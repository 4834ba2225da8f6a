"""Field statistics: realized power spectrum estimator and moments.

Reference parity: the power estimator assumed in
``randomfield/powertools.py:calculate_power`` and the statistical checks
in ``randomfield/tests/test_generate.py`` (SURVEY.md sections 3.5, 4).
Runs as a jitted device program (forward rfftn + scatter-add binning) so
it scales to ensemble validation on device; results return as host numpy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import grid as _grid
from randomfield_tpu.ops import transform as _transform

__all__ = [
    "calculate_power",
    "calculate_power_multipoles",
    "calculate_power_wedges",
    "bin_power_wedges_grid",
    "calculate_masked_power",
    "predicted_masked_power",
    "calculate_power_1d",
    "predicted_power_1d",
    "spectrum_power",
    "field_moments",
    "calculate_correlation",
    "predicted_correlation",
]


@functools.partial(jax.jit, static_argnames=("shape", "spacing"))
def _mode_power(delta, shape, spacing):
    c = _transform.field_to_spectrum(delta, spacing)
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    return (c.real**2 + c.imag**2) / volume


def _interlaced_mode_power(delta, delta2, shape, spacing):
    """Per-mode power with interlacing (Hockney & Eastwood; Sefusatti+
    2016): ``delta2`` is the same catalog painted onto a grid shifted by
    half a cell in every axis; phase-aligning its spectrum and averaging
    cancels the odd alias images of the assignment window, pushing the
    aliasing bias of catalog P(k) from O(1) near Nyquist to percent
    level.  (The combined spectrum is used in k-space only — the phase
    factor breaks exact Hermitian packing on the Nyquist planes, so it
    has no real-space counterpart.)"""
    c1 = _transform.field_to_spectrum(delta, spacing)
    c2 = _transform.field_to_spectrum(delta2, spacing)
    kx, ky, kz = _grid.kvectors(shape, spacing, delta.dtype)
    ph = (
        kx[:, None, None] + ky[None, :, None] + kz[None, None, :]
    ) * jnp.asarray(spacing / 2.0, delta.dtype)
    c = 0.5 * (c1 + c2 * jax.lax.complex(jnp.cos(ph), jnp.sin(ph)))
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    return (c.real**2 + c.imag**2) / volume


def _bin_setup(shape, spacing, nbins):
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001), nbins + 1)
    nz = shape[2]
    mult = np.full(_grid.half_shape(shape)[2], 2.0, np.float32)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    return edges, mult


def _dot_bin(idx, w, pw, km, nbins):
    """Per-bin (sum w, sum w*p, sum w*|k|) via a one-hot matmul contraction.

    Scatter-add serializes colliding updates; contracting the modes
    against an exact {0,1} one-hot avoids that (XLA fuses the one-hot
    generation into the dot, so it is never materialized).
    HIGHEST precision keeps the f32 value operand un-truncated: the
    default bf16 passes bias the power sums by ~0.1%, HIGHEST is within
    ~1e-5 of float64 (and the {0,1} operand is exact in any precision).
    Invalid modes must arrive with ``w == 0`` and an ``idx`` outside
    [0, nbins).
    """
    dt = w.dtype
    oh = (idx.ravel()[:, None] == jnp.arange(nbins, dtype=idx.dtype)).astype(dt)
    wf = w.ravel()
    mat = jnp.stack([wf, wf * pw.ravel(), wf * km.ravel()])
    out = jax.lax.dot(mat, oh, precision=jax.lax.Precision.HIGHEST)
    return out[0], out[1], out[2]


def _masked_bins(km, w, p, edges_j, nbins, per_slab):
    """The shared binning core every estimator variant goes through.

    log-|k| bin index (searchsorted), overflow-bin masking (out-of-range
    |k|, the DC mode, and zero-weight entries such as kz pad columns),
    then the one-hot matmul contraction (:func:`_dot_bin`).  ``w`` may be a
    scalar or broadcastable multiplicity.  ``per_slab=True`` vmaps the
    contraction over axis 0 so partial sums stay short (the f32
    sequential-accumulation concern, see _mean_axiswise); ``False``
    contracts the whole block at once (already-chunked callers).
    """
    wb = jnp.broadcast_to(w, km.shape)
    idx = jnp.searchsorted(edges_j, km, method="compare_all") - 1
    valid = (idx >= 0) & (idx < nbins) & (km > 0) & (wb > 0)
    idx = jnp.where(valid, idx, nbins)
    wv = jnp.where(valid, wb, 0.0)
    kmb = jnp.broadcast_to(km, p.shape)
    if per_slab:
        counts, psum, ksum = jax.vmap(
            lambda ix, wx, px, kx: _dot_bin(ix, wx, px, kx, nbins)
        )(idx, wv, p, kmb)
        return (
            jnp.sum(counts, axis=0),
            jnp.sum(psum, axis=0),
            jnp.sum(ksum, axis=0),
        )
    return _dot_bin(idx, wv, p, kmb, nbins)


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "nbins", "window_order")
)
def _binned(delta, shape, spacing, nbins, window_order=0, delta2=None):
    p = (
        _mode_power(delta, shape, spacing)
        if delta2 is None
        else _interlaced_mode_power(delta, delta2, shape, spacing)
    )
    if window_order:
        p = p / _assignment_window(shape, spacing, p.dtype) ** (
            2 * window_order
        )
    kmag = jnp.broadcast_to(_grid.kmag(shape, spacing, p.dtype), p.shape)
    edges, mult = _bin_setup(shape, spacing, nbins)
    return _masked_bins(
        kmag, jnp.asarray(mult)[None, None, :], p,
        jnp.asarray(edges, p.dtype), nbins, per_slab=True,
    )


_WINDOW_ORDERS = {None: 0, "ngp": 1, "cic": 2, "tsc": 3}

# even-order Legendre polynomials in mu^2 (odd multipoles vanish
# identically under Hermitian symmetry: L_odd(-mu) = -L_odd(mu))
_LEGENDRE_EVEN = {
    0: lambda mu2: jnp.ones_like(mu2),
    2: lambda mu2: 0.5 * (3.0 * mu2 - 1.0),
    4: lambda mu2: 0.125 * (35.0 * mu2 * mu2 - 30.0 * mu2 + 3.0),
}


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "ells", "los_axis",
                     "window_order"),
)
def _binned_multipoles(delta, shape, spacing, nbins, ells, los_axis,
                       window_order, delta2=None):
    p = (
        _mode_power(delta, shape, spacing)
        if delta2 is None
        else _interlaced_mode_power(delta, delta2, shape, spacing)
    )
    if window_order:
        p = p / _assignment_window(shape, spacing, p.dtype) ** (
            2 * window_order
        )
    kv = _grid.kvectors(shape, spacing)
    km = _grid.kmag(shape, spacing, p.dtype)
    k_los = jnp.asarray(kv[los_axis], p.dtype)
    bcast = [None, None, None]
    bcast[los_axis] = slice(None)
    k_los = k_los[tuple(bcast)]
    mu2 = jnp.where(km > 0, (k_los / jnp.where(km > 0, km, 1.0)) ** 2, 0.0)
    edges, mult = _bin_setup(shape, spacing, nbins)
    kmb = jnp.broadcast_to(km, p.shape)
    multb = jnp.asarray(mult)[None, None, :]
    edges_j = jnp.asarray(edges, p.dtype)
    out = []
    counts = ksum = None
    for ell in ells:
        w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
        counts, psum, ksum = _masked_bins(
            kmb, multb, p * w_ell, edges_j, nbins, per_slab=True
        )
        out.append(psum)
    return counts, jnp.stack(out), ksum


def _assignment_window(shape, spacing, dtype):
    """Per-mode mass-assignment window W(k) = prod_i sinc(k_i dx / 2)^order
    at order 1 (NGP); CIC/TSC are its square/cube (Hockney & Eastwood)."""
    kx, ky, kz = _grid.kvectors(shape, spacing)

    def sinc(k):
        x = jnp.asarray(k, dtype) * (spacing / 2.0)
        return jnp.where(x != 0, jnp.sin(x) / jnp.where(x != 0, x, 1.0), 1.0)

    return (
        sinc(kx)[:, None, None]
        * sinc(ky)[None, :, None]
        * sinc(kz)[None, None, :]
    )


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "nbins", "chunks")
)
def _staged_field_power(delta, shape, spacing, nbins, chunks):
    """Forward estimate for fields near the HBM ceiling.

    Chunked r2c over (z, y) per x-slab, one full transpose + minor-axis
    fft over x, then kz-slab binning — never more than two full-size
    complex buffers live (the one-shot path needs an (nx, ny, nz) full
    complex intermediate that cannot fit at 1024^3 on 16 GB).
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    _Bar = jax.lax.optimization_barrier
    cdt = jnp.complex64 if delta.dtype == jnp.float32 else jnp.complex128

    def f1(chunk):  # (cx, ny, nz) real -> (cx, nzh, ny) spectrum in z,y
        c = jnp.fft.fft(chunk.astype(cdt), axis=-1, norm="backward")
        c = _Bar(c[..., :nzh])
        c = _Bar(jnp.transpose(c, (0, 2, 1)))  # (cx, nzh, ny)
        return jnp.fft.fft(c, axis=-1, norm="backward")

    c1 = jax.lax.map(
        f1, delta.reshape(chunks, nx // chunks, ny, nz)
    ).reshape(nx, nzh, ny)
    # fft over x on the minor axis
    c2 = _Bar(jnp.transpose(c1, (1, 2, 0)))  # (nzh, ny, nx)
    c2 = jnp.fft.fft(c2, axis=-1, norm="backward")

    # bin per kz slab: multiplicity is constant within a slab
    edges, mult = _bin_setup(shape, spacing, nbins)
    two_pi = 2.0 * np.pi
    kxv = two_pi * np.fft.fftfreq(nx, d=spacing)
    kyv = two_pi * np.fft.fftfreq(ny, d=spacing)
    kzv = two_pi * np.fft.rfftfreq(nz, d=spacing)
    dtype = delta.dtype
    edges_j = jnp.asarray(edges, dtype)
    ky_sq = jnp.asarray(kyv * kyv, dtype)
    kx_sq = jnp.asarray(kxv * kxv, dtype)
    scale = jnp.asarray(spacing**6 / volume, dtype)

    def slab(args):
        kz_sq, m, cs = args  # scalars + (ny, nx) slab
        km = jnp.sqrt(kz_sq + ky_sq[:, None] + kx_sq[None, :])
        p = (cs.real**2 + cs.imag**2) * scale
        return _masked_bins(km, m, p, edges_j, nbins, per_slab=False)

    counts, psum, ksum = jax.lax.map(
        slab,
        (jnp.asarray(kzv * kzv, dtype), jnp.asarray(mult, dtype), c2),
    )
    return (
        jnp.sum(counts, axis=0),
        jnp.sum(psum, axis=0),
        jnp.sum(ksum, axis=0),
    )


# one-shot forward estimates above this need an (nx, ny, nz) complex
# intermediate that exceeds a 16 GB chip
_STAGED_POWER_THRESHOLD = 256 * 1024 * 1024


def calculate_power(delta, spacing, nbins=32, mesh=None, window=None,
                    interlaced_with=None):
    """Realized isotropic P(k) of a field, binned in log |k|.

    Returns ``(k_mean, p_hat, n_modes)`` numpy arrays: per-bin
    mode-weighted mean |k|, mean estimated power <|c_k|^2>/V, and the
    effective number of (full-spectrum) modes.  Empty bins yield NaN.

    ``window`` (``'ngp'``/``'cic'``/``'tsc'``) deconvolves the named
    mass-assignment window before binning — pass the scheme used to
    paint a particle catalog onto the grid (models/zeldovich.py);
    density fields rendered spectrally need none (the default).
    ``interlaced_with`` is the same catalog painted onto a grid shifted
    by half a cell in every axis: the two spectra are phase-aligned and
    averaged before binning, cancelling the leading alias images of the
    assignment window (see ``_interlaced_mode_power``); single-device,
    like ``window``.

    With ``mesh`` (a ('data','space') mesh whose 'space' axis shards the
    field), the forward FFT runs as the distributed slab transform and
    binning happens shard-locally with a psum — the full spectrum is
    never gathered (ref: powertools.calculate_power, scaled out).
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    from randomfield_tpu.parallel.mesh import SPACE_AXIS
    from randomfield_tpu.parallel.pencil import is_pencil_mesh

    if window not in _WINDOW_ORDERS:
        raise ValueError(
            f"unknown window {window!r}: expected None, 'ngp', 'cic' or 'tsc'"
        )
    worder = _WINDOW_ORDERS[window] or 0
    if interlaced_with is not None and mesh is not None and (
        is_pencil_mesh(mesh) or mesh.shape.get(SPACE_AXIS, 1) > 1
    ):
        fn = _make_mesh_interlaced(
            mesh, shape, float(spacing), int(nbins), worder
        )
        return _bins_to_host(*fn(delta, jnp.asarray(interlaced_with)))
    if interlaced_with is not None:
        counts, psum, ksum = _binned(
            delta, shape, float(spacing), int(nbins),
            _WINDOW_ORDERS[window], jnp.asarray(interlaced_with),
        )
        return _bins_to_host(counts, psum, ksum)
    if mesh is not None and is_pencil_mesh(mesh):
        fn = _make_pencil_binned(
            mesh, shape, float(spacing), int(nbins), order=worder
        )
        counts, psum, ksum = fn(delta)
    elif mesh is not None and mesh.shape.get(SPACE_AXIS, 1) > 1:
        fn = _make_sharded_binned(
            mesh, shape, float(spacing), int(nbins), order=worder
        )
        counts, psum, ksum = fn(delta)
    elif (
        window is None
        and shape[0] * shape[1] * shape[2] > _STAGED_POWER_THRESHOLD
    ):
        chunks = 1
        for c in range(min(16, shape[0]), 0, -1):
            if shape[0] % c == 0:
                chunks = c
                break
        counts, psum, ksum = _staged_field_power(
            delta, shape, float(spacing), int(nbins), chunks
        )
    else:
        counts, psum, ksum = _binned(
            delta, shape, float(spacing), int(nbins),
            _WINDOW_ORDERS[window],
        )
    return _bins_to_host(counts, psum, ksum)


def _bins_to_host(counts, psum, ksum):
    from randomfield_tpu.parallel.multihost import replicated_to_host

    counts = replicated_to_host(counts).astype(np.float64)
    psum = replicated_to_host(psum).astype(np.float64)
    ksum = replicated_to_host(ksum).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


def calculate_power_multipoles(delta, spacing, nbins=32, ells=(0, 2, 4),
                               los_axis=2, window=None,
                               interlaced_with=None, mesh=None):
    """Power-spectrum multipoles P_ell(k) along a plane-parallel LOS.

    ``P_ell(k) = (2 ell + 1) < L_ell(mu) |c_k|^2 / V >_k-bin`` with
    ``mu = k_los / |k|`` — the standard redshift-space expansion
    (Kaiser: ``P_0 = (1 + 2f/3 + f^2/5) P``, ``P_2 = (4f/3 + 4f^2/7) P``,
    ``P_4 = (8f^2/35) P`` at linear order).  Only even multipoles are
    defined (odd ones vanish identically under Hermitian symmetry).
    Returns ``(k_mean, p_ell, n_modes)`` with ``p_ell`` shaped
    ``(len(ells), nbins)``; ``window`` deconvolves a mass-assignment
    window and ``interlaced_with`` alias-cancels with a half-cell-
    shifted painting, exactly as in :func:`calculate_power`.
    Single-device by default; with ``mesh`` (a ('data','space') slab
    mesh or a 2-D pencil mesh) the transform runs distributed and the
    mu^2-weighted binning is shard-local with one psum
    (window/interlacing stay single-device — catalog painting is a
    validation-scale tool).

    Domain note: bins beyond the axis Nyquist ``pi / spacing`` hold
    incomplete k-shells (only diagonal-direction modes exist), which
    biases the mu moments — interpret ell > 0 only below k_Nyquist.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    ells = tuple(int(e) for e in ells)
    for e in ells:
        if e not in _LEGENDRE_EVEN:
            raise ValueError(
                f"ell={e} unsupported: even multipoles 0/2/4 only (odd "
                "ones vanish under Hermitian symmetry)"
            )
    if window not in _WINDOW_ORDERS:
        raise ValueError(
            f"unknown window {window!r}: expected None, 'ngp', 'cic' or 'tsc'"
        )
    if mesh is not None:
        from randomfield_tpu.parallel.mesh import SPACE_AXIS
        from randomfield_tpu.parallel.pencil import is_pencil_mesh

        worder = _WINDOW_ORDERS[window] or 0
        inter = interlaced_with is not None
        if is_pencil_mesh(mesh):
            fn = _make_pencil_multipoles(
                mesh, shape, float(spacing), int(nbins), ells,
                int(los_axis), order=worder, interlaced=inter,
            )
            counts, psums, ksum = (fn(delta, jnp.asarray(interlaced_with))
                                   if inter else fn(delta))
            from randomfield_tpu.parallel.multihost import replicated_to_host

            return _xi_host(
                replicated_to_host(counts), replicated_to_host(psums),
                replicated_to_host(ksum),
            )
        if mesh.shape.get(SPACE_AXIS, 1) > 1 or not getattr(
            delta, "is_fully_addressable", True
        ):
            fn = _make_sharded_multipoles(
                mesh, shape, float(spacing), int(nbins), ells,
                int(los_axis), order=worder, interlaced=inter,
            )
            counts, psums, ksum = (fn(delta, jnp.asarray(interlaced_with))
                                   if inter else fn(delta))
            from randomfield_tpu.parallel.multihost import replicated_to_host

            return _xi_host(
                replicated_to_host(counts), replicated_to_host(psums),
                replicated_to_host(ksum),
            )
    counts, psums, ksum = _binned_multipoles(
        jnp.asarray(delta), shape, float(spacing), int(nbins), ells,
        int(los_axis), _WINDOW_ORDERS[window],
        None if interlaced_with is None else jnp.asarray(interlaced_with),
    )
    return _xi_host(counts, psums, ksum)


def _wedge_bin_core(km, mu, wb, p, edges_j, nbins, nmu):
    """Joint (|k|, |mu|) binning core shared by every wedge variant:
    combined bin index ``k_idx * nmu + mu_idx`` through the same
    one-hot matmul contraction as :func:`_dot_bin`, with the estimator's
    k edges, Hermitian multiplicities and masks.  Wedges are uniform in
    |mu| on [0, 1] (mu = |k_los|/|k| suffices — the conjugate mode has
    the same |mu|, which is why the half-grid multiplicities apply
    unchanged).  Returns (nbins, nmu)-shaped (counts, psum, ksum)."""
    k_idx = jnp.searchsorted(edges_j, km, method="compare_all") - 1
    mu_idx = jnp.clip((mu * nmu).astype(jnp.int32), 0, nmu - 1)
    total = nbins * nmu
    valid = (k_idx >= 0) & (k_idx < nbins) & (km > 0) & (wb > 0)
    idx = jnp.where(valid, k_idx * nmu + mu_idx, total)
    wv = jnp.where(valid, wb, 0.0)
    kmb = jnp.broadcast_to(km, p.shape)
    counts, psum, ksum = jax.vmap(
        lambda ix, wx, px, kx: _dot_bin(ix, wx, px, kx, total)
    )(idx, jnp.broadcast_to(wv, p.shape), p, kmb)
    return (
        jnp.sum(counts, axis=0).reshape(nbins, nmu),
        jnp.sum(psum, axis=0).reshape(nbins, nmu),
        jnp.sum(ksum, axis=0).reshape(nbins, nmu),
    )


def _wedge_mu(km, kv, los_axis, dtype):
    k_los = jnp.asarray(kv[los_axis], dtype)
    bcast = [None, None, None]
    bcast[los_axis] = slice(None)
    k_los = k_los[tuple(bcast)]
    return jnp.where(
        km > 0, jnp.abs(k_los) / jnp.where(km > 0, km, 1.0), 0.0
    )


def _wedge_bins_from_power(p, shape, spacing, nbins, nmu, los_axis):
    km = _grid.kmag(shape, spacing, p.dtype)
    kv = _grid.kvectors(shape, spacing)
    mu = _wedge_mu(km, kv, los_axis, p.dtype)
    edges, mult = _bin_setup(shape, spacing, nbins)
    wb = jnp.broadcast_to(jnp.asarray(mult)[None, None, :], km.shape)
    return _wedge_bin_core(
        km, mu, wb, p, jnp.asarray(edges, p.dtype), nbins, nmu
    )


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "nmu", "los_axis",
                     "window_order"),
)
def _binned_wedges(delta, shape, spacing, nbins, nmu, los_axis,
                   window_order, delta2=None):
    p = (
        _mode_power(delta, shape, spacing)
        if delta2 is None
        else _interlaced_mode_power(delta, delta2, shape, spacing)
    )
    if window_order:
        p = p / _assignment_window(shape, spacing, p.dtype) ** (
            2 * window_order
        )
    return _wedge_bins_from_power(p, shape, spacing, nbins, nmu, los_axis)


def _wedges_host(counts, psum, ksum):
    counts = np.asarray(counts, np.float64)
    psum = np.asarray(psum, np.float64)
    ksum = np.asarray(ksum, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        k_mean = ksum.sum(axis=1) / counts.sum(axis=1)
        return k_mean, psum / counts, counts


def calculate_power_wedges(delta, spacing, nbins=32, nmu=4, los_axis=2,
                           window=None, interlaced_with=None, mesh=None):
    """Anisotropic power spectrum in (k, mu) wedges, P(k, mu_j).

    The clustering-wedge companion of :func:`calculate_power_multipoles`
    (Kazin et al. 2012): the per-mode power averaged in joint bins of
    |k| (the estimator's log-spaced shells) and |mu| = |k_los|/|k|
    (``nmu`` uniform wedges on [0, 1]).  Unlike the Legendre projection,
    wedges keep the full mu-dependence observable — the standard
    diagnostic for RSD and AP analyses.  Returns ``(k_mean, p, n_modes)``
    with ``p`` and ``n_modes`` shaped ``(nbins, nmu)`` and ``k_mean``
    the per-k-shell mean |k| (aggregated over wedges).  ``window`` /
    ``interlaced_with`` behave exactly as in :func:`calculate_power`.
    With ``mesh`` (a ('data','space') slab mesh or a 2-D pencil mesh)
    the transform runs distributed and the joint binning is shard-local
    with one psum, like the multipole estimator.  The count-weighted
    wedge average reproduces :func:`calculate_power` bin for bin (same
    modes, masks and multiplicities — asserted in tests); expectations
    bin through :func:`bin_power_wedges_grid` so residuals are pure
    sample noise.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if window not in _WINDOW_ORDERS:
        raise ValueError(
            f"unknown window {window!r}: expected None, 'ngp', 'cic' or 'tsc'"
        )
    if mesh is not None:
        from randomfield_tpu.parallel.mesh import SPACE_AXIS
        from randomfield_tpu.parallel.pencil import is_pencil_mesh

        if interlaced_with is not None:
            raise ValueError(
                "interlaced wedges are single-device; drop mesh="
            )
        worder = _WINDOW_ORDERS[window] or 0
        from randomfield_tpu.parallel.multihost import replicated_to_host

        if is_pencil_mesh(mesh):
            fn = _make_pencil_wedges(
                mesh, shape, float(spacing), int(nbins), int(nmu),
                int(los_axis), order=worder,
            )
            counts, psum, ksum = fn(delta)
            return _wedges_host(
                replicated_to_host(counts), replicated_to_host(psum),
                replicated_to_host(ksum),
            )
        if mesh.shape.get(SPACE_AXIS, 1) > 1 or not getattr(
            delta, "is_fully_addressable", True
        ):
            fn = _make_sharded_wedges(
                mesh, shape, float(spacing), int(nbins), int(nmu),
                int(los_axis), order=worder,
            )
            counts, psum, ksum = fn(delta)
            return _wedges_host(
                replicated_to_host(counts), replicated_to_host(psum),
                replicated_to_host(ksum),
            )
    counts, psum, ksum = _binned_wedges(
        jnp.asarray(delta), shape, float(spacing), int(nbins), int(nmu),
        int(los_axis), _WINDOW_ORDERS[window],
        None if interlaced_with is None else jnp.asarray(interlaced_with),
    )
    return _wedges_host(counts, psum, ksum)


def bin_power_wedges_grid(pgrid, shape, spacing, nbins=32, nmu=4,
                          los_axis=2):
    """Wedge-average a per-mode power half-grid into estimator bins.

    The (k, mu)-wedge companion of :func:`bin_power_multipoles_grid`:
    bins an expectation grid ``E[P_hat(k)]`` (which may depend on mu)
    with exactly the joint bins, multiplicities and masks of
    :func:`calculate_power_wedges`, so measured-vs-predicted wedge
    residuals are pure sample noise — including the empty high-mu cells
    of incomplete shells.  Returns ``(k_mean, p, n_modes)`` shaped as
    the estimator's.
    """
    shape = tuple(int(s) for s in shape)
    p = jnp.asarray(pgrid)
    counts, psum, ksum = _wedge_bins_from_power(
        p, shape, float(spacing), int(nbins), int(nmu), int(los_axis)
    )
    return _wedges_host(counts, psum, ksum)


@functools.lru_cache(maxsize=16)
def _make_sharded_multipoles(mesh, shape, spacing, nbins, ells, los_axis,
                             order=0, interlaced=False):
    """Distributed P_ell(k) on a ('data','space') slab mesh: sharded
    forward transform, shard-local mu^2 + Legendre-weighted binning, one
    psum.  Mirrors _make_sharded_binned with the multipole weights of
    _binned_multipoles."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel.mesh import SPACE_AXIS
    from randomfield_tpu.ops import grid as _grid

    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    n_space = mesh.shape[SPACE_AXIS]
    ny_loc = ny // n_space
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz = _sinc_half(kz, spacing) ** order

    def _local_bins(cl, cl2):
        j = jax.lax.axis_index(SPACE_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        kv = (jnp.asarray(kx), ky_l, jnp.asarray(kz))
        km2 = (
            (kv[0] * kv[0])[:, None, None]
            + (kv[1] * kv[1])[None, :, None]
            + (kv[2] * kv[2])[None, None, :]
        )
        km = jnp.sqrt(km2).astype(cl.real.dtype)
        if interlaced:
            ph = (
                kv[0][:, None, None] + kv[1][None, :, None]
                + kv[2][None, None, :]
            ).astype(cl.real.dtype) * (spacing / 2.0)
            cl = 0.5 * (cl + cl2 * jax.lax.complex(jnp.cos(ph),
                                                   jnp.sin(ph)))
        k_los = kv[los_axis]
        bcast = [None, None, None]
        bcast[los_axis] = slice(None)
        k_los = k_los.astype(km.dtype)[tuple(bcast)]
        mu2 = jnp.where(km > 0, (k_los / jnp.where(km > 0, km, 1.0)) ** 2,
                        0.0)
        p = (cl.real**2 + cl.imag**2) * (spacing**3) ** 2 / volume
        if order:
            wy_l = jax.lax.dynamic_slice(
                jnp.asarray(wy), (j * ny_loc,), (ny_loc,)
            )
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * jnp.asarray(wz)[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        kmb = jnp.broadcast_to(km, p.shape)
        multb = jnp.asarray(mult)[None, None, :]
        edges_j = jnp.asarray(edges, p.dtype)
        psums = []
        counts = ksum = None
        for ell in ells:
            w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
            counts, psum_, ksum = _masked_bins(
                kmb, multb, p * w_ell, edges_j, nbins, per_slab=True
            )
            psums.append(psum_)
        return jax.lax.psum(
            jnp.concatenate([counts[None], jnp.stack(psums), ksum[None]]),
            SPACE_AXIS,
        )

    @jax.jit
    def fn(delta, delta2=None):
        c = dfft.rfftn_slab(delta, shape, mesh)  # sharded along ky
        c2 = (c if delta2 is None
              else dfft.rfftn_slab(delta2, shape, mesh))
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=(P(None, SPACE_AXIS, None), P(None, SPACE_AXIS, None)),
            out_specs=P(),
            check_vma=False,
        )(c, c2)
        return bins[0], bins[1:-1], bins[-1]

    return fn


def _sinc_half(k, spacing):
    x = np.asarray(k, np.float64) * (spacing / 2.0)
    return np.where(x != 0, np.sin(x) / np.where(x != 0, x, 1.0), 1.0)


@functools.lru_cache(maxsize=16)
def _make_sharded_binned(mesh, shape, spacing, nbins, order=0):
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel.mesh import SPACE_AXIS
    from randomfield_tpu.ops import grid as _grid

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    n_space = mesh.shape[SPACE_AXIS]
    ny_loc = ny // n_space
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    # mass-assignment deconvolution (order = NGP 1 / CIC 2 / TSC 3):
    # the separable sinc factors slice exactly like the k vectors, so
    # deconvolution costs one shard-local multiply — no gathered window
    # grid (the single-device path's _assignment_window)
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz = _sinc_half(kz, spacing) ** order

    # the shard is binned in x-chunks under lax.map, so the per-mode
    # temporaries (|k|, bin index, weights) stay chunk-sized
    chunks = next(c for c in range(min(16, nx), 0, -1) if nx % c == 0)

    def _local_bins(cl):
        # cl: (nx, ny/P, nzh) local block of the packed spectrum
        j = jax.lax.axis_index(SPACE_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        wy_l = jax.lax.dynamic_slice(jnp.asarray(wy), (j * ny_loc,), (ny_loc,))

        def one(args):
            c, kxc, wxc = args
            km = jnp.sqrt(
                (kxc * kxc)[:, None, None]
                + (ky_l * ky_l)[None, :, None]
                + jnp.asarray(kz * kz)[None, None, :]
            ).astype(c.real.dtype)
            p = (c.real**2 + c.imag**2) * (spacing**3) ** 2 / volume
            if order:
                w2 = (
                    wxc[:, None, None]
                    * wy_l[None, :, None]
                    * jnp.asarray(wz)[None, None, :]
                ) ** 2
                p = p / w2.astype(p.dtype)
            return jnp.stack(_masked_bins(
                jnp.broadcast_to(km, p.shape),
                jnp.asarray(mult)[None, None, :], p,
                jnp.asarray(edges, p.dtype), nbins, per_slab=True,
            ))

        cx = nx // chunks
        parts = jax.lax.map(one, (
            cl.reshape(chunks, cx, *cl.shape[1:]),
            jnp.asarray(kx).reshape(chunks, cx),
            jnp.asarray(wx).reshape(chunks, cx),
        ))
        return jax.lax.psum(jnp.sum(parts, axis=0), SPACE_AXIS)

    @jax.jit
    def fn(delta):
        c = dfft.rfftn_slab(delta, shape, mesh)  # sharded along ky
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=P(None, SPACE_AXIS, None),
            out_specs=P(),
            check_vma=False,
        )(c)
        return bins[0], bins[1], bins[2]

    return fn


@functools.lru_cache(maxsize=16)
def _make_pencil_multipoles(mesh, shape, spacing, nbins, ells, los_axis,
                            order=0, interlaced=False):
    """Distributed P_ell(k) on a 2-D pencil mesh: distributed forward
    FFT + shard-local mu^2 / Legendre-weighted binning + one psum over
    both spatial axes.  The pencil analog of _make_sharded_multipoles;
    the state-1 spectrum shards ky over 'spx' and kz over 'spy', so the
    LOS wavenumber slice depends on which axis is the LOS."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.ops import grid as _grid
    from randomfield_tpu.parallel import pencil as _pencil

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    px = mesh.shape[_pencil.SPX_AXIS]
    py = mesh.shape[_pencil.SPY_AXIS]
    ny_loc = ny // px
    nzp = nzh + (-nzh) % py
    nz_loc = nzp // py
    edges, mult = _bin_setup(shape, spacing, nbins)
    mult_p = np.zeros(nzp, np.float32)
    mult_p[:nzh] = mult
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    kz_p = np.zeros(nzp, kz.dtype)
    kz_p[:nzh] = kz
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz_p = np.ones(nzp, np.float64)
    wz_p[:nzh] = _sinc_half(kz, spacing) ** order

    def _local_bins(cl, cl2):
        j = jax.lax.axis_index(_pencil.SPX_AXIS)
        m = jax.lax.axis_index(_pencil.SPY_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        kz_l = jax.lax.dynamic_slice(jnp.asarray(kz_p), (m * nz_loc,), (nz_loc,))
        mult_l = jax.lax.dynamic_slice(
            jnp.asarray(mult_p), (m * nz_loc,), (nz_loc,)
        )
        kv = (jnp.asarray(kx), ky_l, kz_l)
        km = jnp.sqrt(
            (kv[0] * kv[0])[:, None, None]
            + (kv[1] * kv[1])[None, :, None]
            + (kv[2] * kv[2])[None, None, :]
        ).astype(cl.real.dtype)
        if interlaced:
            ph = (
                kv[0][:, None, None] + kv[1][None, :, None]
                + kv[2][None, None, :]
            ).astype(cl.real.dtype) * (spacing / 2.0)
            cl = 0.5 * (cl + cl2 * jax.lax.complex(jnp.cos(ph),
                                                   jnp.sin(ph)))
        k_los = kv[los_axis].astype(km.dtype)
        bcast = [None, None, None]
        bcast[los_axis] = slice(None)
        k_los = k_los[tuple(bcast)]
        mu2 = jnp.where(km > 0, (k_los / jnp.where(km > 0, km, 1.0)) ** 2,
                        0.0)
        p = (cl.real**2 + cl.imag**2) * (spacing**3) ** 2 / volume
        if order:
            wy_l = jax.lax.dynamic_slice(
                jnp.asarray(wy), (j * ny_loc,), (ny_loc,)
            )
            wz_l = jax.lax.dynamic_slice(
                jnp.asarray(wz_p), (m * nz_loc,), (nz_loc,)
            )
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * wz_l[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        kmb = jnp.broadcast_to(km, p.shape)
        multb = mult_l[None, None, :]
        edges_j = jnp.asarray(edges, p.dtype)
        psums = []
        counts = ksum = None
        for ell in ells:
            w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
            counts, psum_, ksum = _masked_bins(
                kmb, multb, p * w_ell, edges_j, nbins, per_slab=True
            )
            psums.append(psum_)
        return jax.lax.psum(
            jnp.concatenate([counts[None], jnp.stack(psums), ksum[None]]),
            (_pencil.SPX_AXIS, _pencil.SPY_AXIS),
        )

    @jax.jit
    def fn(delta, delta2=None):
        c = _pencil.rfftn_pencil(delta, shape, mesh, keep_pad=True)
        c2 = (c if delta2 is None
              else _pencil.rfftn_pencil(delta2, shape, mesh, keep_pad=True))
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=(P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS),
                      P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS)),
            out_specs=P(),
            check_vma=False,
        )(c, c2)
        return bins[0], bins[1:-1], bins[-1]

    return fn


@functools.lru_cache(maxsize=16)
def _make_sharded_wedges(mesh, shape, spacing, nbins, nmu, los_axis,
                         order=0):
    """Distributed P(k, mu) wedges on a ('data','space') slab mesh:
    sharded forward transform, shard-local joint (|k|, |mu|) binning,
    one psum.  The wedge analog of _make_sharded_multipoles."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel.mesh import SPACE_AXIS
    from randomfield_tpu.ops import grid as _grid

    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    n_space = mesh.shape[SPACE_AXIS]
    ny_loc = ny // n_space
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz = _sinc_half(kz, spacing) ** order

    def _local_bins(cl):
        j = jax.lax.axis_index(SPACE_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        kv = (jnp.asarray(kx), ky_l, jnp.asarray(kz))
        km = jnp.sqrt(
            (kv[0] * kv[0])[:, None, None]
            + (kv[1] * kv[1])[None, :, None]
            + (kv[2] * kv[2])[None, None, :]
        ).astype(cl.real.dtype)
        mu = _wedge_mu(km, kv, los_axis, km.dtype)
        p = (cl.real**2 + cl.imag**2) * (spacing**3) ** 2 / volume
        if order:
            wy_l = jax.lax.dynamic_slice(
                jnp.asarray(wy), (j * ny_loc,), (ny_loc,)
            )
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * jnp.asarray(wz)[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        wb = jnp.broadcast_to(jnp.asarray(mult)[None, None, :], km.shape)
        counts, psum, ksum = _wedge_bin_core(
            km, mu, wb, p, jnp.asarray(edges, p.dtype), nbins, nmu
        )
        return jax.lax.psum(
            jnp.stack([counts, psum, ksum]), SPACE_AXIS
        )

    @jax.jit
    def fn(delta):
        c = dfft.rfftn_slab(delta, shape, mesh)  # sharded along ky
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=P(None, SPACE_AXIS, None),
            out_specs=P(),
            check_vma=False,
        )(c)
        return bins[0], bins[1], bins[2]

    return fn


@functools.lru_cache(maxsize=16)
def _make_pencil_wedges(mesh, shape, spacing, nbins, nmu, los_axis,
                        order=0):
    """Pencil-mesh P(k, mu) wedges: distributed forward FFT +
    shard-local joint binning + one psum over both spatial axes.  The
    wedge analog of _make_pencil_multipoles (state-1 spectrum: ky over
    'spx', kz over 'spy', kz pad plane masked by zero multiplicity)."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.ops import grid as _grid
    from randomfield_tpu.parallel import pencil as _pencil

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    px = mesh.shape[_pencil.SPX_AXIS]
    py = mesh.shape[_pencil.SPY_AXIS]
    ny_loc = ny // px
    nzp = nzh + (-nzh) % py
    nz_loc = nzp // py
    edges, mult = _bin_setup(shape, spacing, nbins)
    mult_p = np.zeros(nzp, np.float32)
    mult_p[:nzh] = mult
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    kz_p = np.zeros(nzp, kz.dtype)
    kz_p[:nzh] = kz
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz_p = np.ones(nzp, np.float64)
    wz_p[:nzh] = _sinc_half(kz, spacing) ** order

    def _local_bins(cl):
        j = jax.lax.axis_index(_pencil.SPX_AXIS)
        m = jax.lax.axis_index(_pencil.SPY_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        kz_l = jax.lax.dynamic_slice(jnp.asarray(kz_p), (m * nz_loc,), (nz_loc,))
        mult_l = jax.lax.dynamic_slice(
            jnp.asarray(mult_p), (m * nz_loc,), (nz_loc,)
        )
        kv = (jnp.asarray(kx), ky_l, kz_l)
        km = jnp.sqrt(
            (kv[0] * kv[0])[:, None, None]
            + (kv[1] * kv[1])[None, :, None]
            + (kv[2] * kv[2])[None, None, :]
        ).astype(cl.real.dtype)
        mu = _wedge_mu(km, kv, los_axis, km.dtype)
        p = (cl.real**2 + cl.imag**2) * (spacing**3) ** 2 / volume
        if order:
            wy_l = jax.lax.dynamic_slice(
                jnp.asarray(wy), (j * ny_loc,), (ny_loc,)
            )
            wz_l = jax.lax.dynamic_slice(
                jnp.asarray(wz_p), (m * nz_loc,), (nz_loc,)
            )
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * wz_l[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        wb = jnp.broadcast_to(mult_l[None, None, :], km.shape)
        counts, psum, ksum = _wedge_bin_core(
            km, mu, wb, p, jnp.asarray(edges, p.dtype), nbins, nmu
        )
        return jax.lax.psum(
            jnp.stack([counts, psum, ksum]),
            (_pencil.SPX_AXIS, _pencil.SPY_AXIS),
        )

    @jax.jit
    def fn(delta):
        c = _pencil.rfftn_pencil(delta, shape, mesh, keep_pad=True)
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS),
            out_specs=P(),
            check_vma=False,
        )(c)
        return bins[0], bins[1], bins[2]

    return fn


@functools.lru_cache(maxsize=16)
def _make_pencil_binned(mesh, shape, spacing, nbins, order=0):
    """Pencil-mesh P(k): distributed forward FFT + shard-local binning.

    The spectrum comes back in pencil state 1 (ky over 'spx', kz over
    'spy'); each device bins its (nx, ny/px, nzh/py) block against the
    |k| values and kz multiplicities of its own slices, then psums over
    both spatial axes.  The full spectrum is never gathered.
    """
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.ops import grid as _grid
    from randomfield_tpu.parallel import pencil as _pencil

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    px = mesh.shape[_pencil.SPX_AXIS]
    py = mesh.shape[_pencil.SPY_AXIS]
    ny_loc = ny // px
    # kz is padded to a multiple of py for equal blocks; pad modes are
    # masked out of the binning below
    nzp = nzh + (-nzh) % py
    nz_loc = nzp // py
    edges, mult = _bin_setup(shape, spacing, nbins)
    mult_p = np.zeros(nzp, np.float32)
    mult_p[:nzh] = mult
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    kz_p = np.zeros(nzp, kz.dtype)
    kz_p[:nzh] = kz
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    wz_p = np.ones(nzp, np.float64)
    wz_p[:nzh] = _sinc_half(kz, spacing) ** order

    def _local_bins(cl):
        j = jax.lax.axis_index(_pencil.SPX_AXIS)
        m = jax.lax.axis_index(_pencil.SPY_AXIS)
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (j * ny_loc,), (ny_loc,))
        kz_l = jax.lax.dynamic_slice(jnp.asarray(kz_p), (m * nz_loc,), (nz_loc,))
        mult_l = jax.lax.dynamic_slice(
            jnp.asarray(mult_p), (m * nz_loc,), (nz_loc,)
        )
        km = jnp.sqrt(
            jnp.asarray(kx * kx)[:, None, None]
            + (ky_l * ky_l)[None, :, None]
            + (kz_l * kz_l)[None, None, :]
        ).astype(cl.real.dtype)
        p = (cl.real**2 + cl.imag**2) * (spacing**3) ** 2 / volume
        if order:
            wy_l = jax.lax.dynamic_slice(
                jnp.asarray(wy), (j * ny_loc,), (ny_loc,)
            )
            wz_l = jax.lax.dynamic_slice(
                jnp.asarray(wz_p), (m * nz_loc,), (nz_loc,)
            )
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * wz_l[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        counts, psum_, ksum = _masked_bins(
            jnp.broadcast_to(km, p.shape), mult_l[None, None, :], p,
            jnp.asarray(edges, p.dtype), nbins, per_slab=True,
        )
        return jax.lax.psum(
            jnp.stack([counts, psum_, ksum]),
            (_pencil.SPX_AXIS, _pencil.SPY_AXIS),
        )

    @jax.jit
    def fn(delta):
        # keep_pad: the padded spectrum is already in equal shard blocks
        # (pad modes carry w=0 in the binning), avoiding an uneven
        # re-shard + re-pad round trip
        c = _pencil.rfftn_pencil(delta, shape, mesh, keep_pad=True)
        bins = jax.shard_map(
            _local_bins,
            mesh=mesh,
            in_specs=P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS),
            out_specs=P(),
            check_vma=False,
        )(c)
        return bins[0], bins[1], bins[2]

    return fn


@functools.partial(
    jax.jit, static_argnames=("shape", "spacing", "nbins", "layout")
)
def _binned_spectrum(c, shape, spacing, nbins, layout):
    """Bin |c_k|^2 * V of a packed spectrum (no FFT; layout-aware)."""
    return _binned_spectrum_reim(c.real, c.imag, shape, spacing, nbins, layout)


def _binned_spectrum_reim(cre, cim, shape, spacing, nbins, layout):
    """Binning core on re/im lattices (traceable; no complex input).

    |k| is rebuilt per x-slab from 1-D frequency vectors inside a
    lax.map body — a precomputed |k| cube at 1024^3 would bake a >4 GB
    constant into the executable (resident HBM + minutes of transfer).
    """
    nx, ny, nz = shape
    volume = nx * ny * nz * spacing**3
    edges, mult = _bin_setup(shape, spacing, nbins)
    two_pi = 2.0 * np.pi
    kx = two_pi * np.fft.fftfreq(nx, d=spacing)
    ky = two_pi * np.fft.fftfreq(ny, d=spacing)
    kz = two_pi * np.fft.rfftfreq(nz, d=spacing)
    dtype = cre.dtype
    if layout == "xyz":
        kmid, klast = ky, kz
        m2 = np.broadcast_to(mult[None, :], (ny, nz // 2 + 1))
    elif layout == "xzy":
        kmid, klast = kz, ky
        m2 = np.broadcast_to(mult[:, None], (nz // 2 + 1, ny))
    else:
        raise ValueError(layout)
    kmid_j = jnp.asarray(kmid, dtype)
    klast_j = jnp.asarray(klast, dtype)
    m2_j = jnp.asarray(np.ascontiguousarray(m2), dtype)
    edges_j = jnp.asarray(edges, dtype)
    kx_sq = jnp.asarray(kx * kx, dtype)

    # a handful of x-slabs per map step amortizes per-step dispatch while
    # keeping the live |k|/index temporaries a small fraction of the
    # full-size spectrum
    ch = 1
    for cand in range(min(16, nx), 0, -1):
        if nx % cand == 0:
            ch = cand
            break

    def chunk(args):
        kxs, csr, csi = args  # (ch,) kx^2, (ch, d1, d2) re/im slabs
        km = jnp.sqrt(
            kxs[:, None, None]
            + (kmid_j * kmid_j)[None, :, None]
            + (klast_j * klast_j)[None, None, :]
        )
        p = (csr * csr + csi * csi) * jnp.asarray(volume, dtype)
        return _masked_bins(km, m2_j[None], p, edges_j, nbins, per_slab=False)

    counts, psum, ksum = jax.lax.map(
        chunk,
        (
            kx_sq.reshape(-1, ch),
            cre.reshape(-1, ch, *cre.shape[1:]),
            cim.reshape(-1, ch, *cim.shape[1:]),
        ),
    )
    return (
        jnp.sum(counts, axis=0),
        jnp.sum(psum, axis=0),
        jnp.sum(ksum, axis=0),
    )


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nbins"))
def _binned_cross(delta1, delta2, shape, spacing, nbins):
    c1 = _transform.field_to_spectrum(delta1, spacing)
    c2 = _transform.field_to_spectrum(delta2, spacing)
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    p = (c1.real * c2.real + c1.imag * c2.imag) / volume
    kmag = jnp.broadcast_to(_grid.kmag(shape, spacing, p.dtype), p.shape)
    edges, mult = _bin_setup(shape, spacing, nbins)
    return _masked_bins(
        kmag, jnp.asarray(mult)[None, None, :], p,
        jnp.asarray(edges, p.dtype), nbins, per_slab=True,
    )


@functools.lru_cache(maxsize=16)
def _make_mesh_cross(mesh, shape, spacing, nbins):
    """Distributed cross-spectrum binning (slab + pencil): two sharded
    forward transforms, shard-local Re(c1 conj(c2)) binning, one psum."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    is_pencil = _pencil.is_pencil_mesh(mesh)
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        ny_loc = ny // px
        nzp = nzh + (-nzh) % py
        nz_loc = nzp // py
        mult_p = np.zeros(nzp, np.float32)
        mult_p[:nzh] = mult
        kz_p = np.zeros(nzp, kz.dtype)
        kz_p[:nzh] = kz
        in_spec = P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS)
        psum_axes = (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
    else:
        n_space = mesh.shape[SPACE_AXIS]
        ny_loc = ny // n_space
        in_spec = P(None, SPACE_AXIS, None)
        psum_axes = SPACE_AXIS

    def _local_bins(c1, c2):
        jy = (jax.lax.axis_index(_pencil.SPX_AXIS) if is_pencil
              else jax.lax.axis_index(SPACE_AXIS))
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (jy * ny_loc,),
                                     (ny_loc,))
        if is_pencil:
            jz = jax.lax.axis_index(_pencil.SPY_AXIS)
            kz_l = jax.lax.dynamic_slice(
                jnp.asarray(kz_p), (jz * nz_loc,), (nz_loc,)
            )
            mult_l = jax.lax.dynamic_slice(
                jnp.asarray(mult_p), (jz * nz_loc,), (nz_loc,)
            )[None, None, :]
        else:
            kz_l = jnp.asarray(kz)
            mult_l = jnp.asarray(mult)[None, None, :]
        km = jnp.sqrt(
            jnp.asarray(kx * kx)[:, None, None]
            + (ky_l * ky_l)[None, :, None]
            + (kz_l * kz_l)[None, None, :]
        ).astype(c1.real.dtype)
        p = (c1.real * c2.real + c1.imag * c2.imag) * (
            (spacing**3) ** 2 / volume
        )
        counts, psum_, ksum = _masked_bins(
            jnp.broadcast_to(km, p.shape), mult_l, p,
            jnp.asarray(edges, p.dtype), nbins, per_slab=True,
        )
        return jax.lax.psum(jnp.stack([counts, psum_, ksum]), psum_axes)

    @jax.jit
    def fn(d1, d2):
        if is_pencil:
            c1 = _pencil.rfftn_pencil(d1, shape, mesh, keep_pad=True)
            c2 = _pencil.rfftn_pencil(d2, shape, mesh, keep_pad=True)
        else:
            c1 = dfft.rfftn_slab(d1, shape, mesh)
            c2 = dfft.rfftn_slab(d2, shape, mesh)
        bins = jax.shard_map(
            _local_bins, mesh=mesh, in_specs=(in_spec, in_spec),
            out_specs=P(), check_vma=False,
        )(c1, c2)
        return bins[0], bins[1], bins[2]

    return fn


@functools.lru_cache(maxsize=16)
def _make_mesh_interlaced(mesh, shape, spacing, nbins, order):
    """Distributed interlaced P(k) (slab + pencil): two sharded forward
    transforms, shard-local phase-align + average + window deconvolution
    + binning, one psum.  The phase factor rebuilds from sliced k
    vectors — nothing mode-sized is gathered or replicated."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    nzh = nz // 2 + 1
    volume = nx * ny * nz * spacing**3
    is_pencil = _pencil.is_pencil_mesh(mesh)
    edges, mult = _bin_setup(shape, spacing, nbins)
    kx, ky, kz = (np.asarray(v) for v in _grid.kvectors(shape, spacing))
    wx = _sinc_half(kx, spacing) ** order
    wy = _sinc_half(ky, spacing) ** order
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        ny_loc = ny // px
        nzp = nzh + (-nzh) % py
        nz_loc = nzp // py
        mult_p = np.zeros(nzp, np.float32)
        mult_p[:nzh] = mult
        kz_p = np.zeros(nzp, kz.dtype)
        kz_p[:nzh] = kz
        wz_p = np.ones(nzp, np.float64)
        wz_p[:nzh] = _sinc_half(kz, spacing) ** order
        in_spec = P(None, _pencil.SPX_AXIS, _pencil.SPY_AXIS)
        psum_axes = (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
    else:
        n_space = mesh.shape[SPACE_AXIS]
        ny_loc = ny // n_space
        wz = _sinc_half(kz, spacing) ** order
        in_spec = P(None, SPACE_AXIS, None)
        psum_axes = SPACE_AXIS

    def _local_bins(c1, c2):
        jy = (jax.lax.axis_index(_pencil.SPX_AXIS) if is_pencil
              else jax.lax.axis_index(SPACE_AXIS))
        ky_l = jax.lax.dynamic_slice(jnp.asarray(ky), (jy * ny_loc,),
                                     (ny_loc,))
        wy_l = jax.lax.dynamic_slice(jnp.asarray(wy), (jy * ny_loc,),
                                     (ny_loc,))
        if is_pencil:
            jz = jax.lax.axis_index(_pencil.SPY_AXIS)
            kz_l = jax.lax.dynamic_slice(
                jnp.asarray(kz_p), (jz * nz_loc,), (nz_loc,)
            )
            wz_l = jax.lax.dynamic_slice(
                jnp.asarray(wz_p), (jz * nz_loc,), (nz_loc,)
            )
            mult_l = jax.lax.dynamic_slice(
                jnp.asarray(mult_p), (jz * nz_loc,), (nz_loc,)
            )[None, None, :]
        else:
            kz_l = jnp.asarray(kz)
            wz_l = jnp.asarray(wz)
            mult_l = jnp.asarray(mult)[None, None, :]
        km = jnp.sqrt(
            jnp.asarray(kx * kx)[:, None, None]
            + (ky_l * ky_l)[None, :, None]
            + (kz_l * kz_l)[None, None, :]
        ).astype(c1.real.dtype)
        ph = (
            jnp.asarray(kx)[:, None, None]
            + ky_l[None, :, None]
            + kz_l[None, None, :]
        ).astype(c1.real.dtype) * (spacing / 2.0)
        c = 0.5 * (c1 + c2 * jax.lax.complex(jnp.cos(ph), jnp.sin(ph)))
        p = (c.real**2 + c.imag**2) * ((spacing**3) ** 2 / volume)
        if order:
            w2 = (
                jnp.asarray(wx)[:, None, None]
                * wy_l[None, :, None]
                * wz_l[None, None, :]
            ) ** 2
            p = p / w2.astype(p.dtype)
        counts, psum_, ksum = _masked_bins(
            jnp.broadcast_to(km, p.shape), mult_l, p,
            jnp.asarray(edges, p.dtype), nbins, per_slab=True,
        )
        return jax.lax.psum(jnp.stack([counts, psum_, ksum]), psum_axes)

    @jax.jit
    def fn(d1, d2):
        if is_pencil:
            c1 = _pencil.rfftn_pencil(d1, shape, mesh, keep_pad=True)
            c2 = _pencil.rfftn_pencil(d2, shape, mesh, keep_pad=True)
        else:
            c1 = dfft.rfftn_slab(d1, shape, mesh)
            c2 = dfft.rfftn_slab(d2, shape, mesh)
        bins = jax.shard_map(
            _local_bins, mesh=mesh, in_specs=(in_spec, in_spec),
            out_specs=P(), check_vma=False,
        )(c1, c2)
        return bins[0], bins[1], bins[2]

    return fn


def calculate_cross_power(delta1, delta2, spacing, nbins=32, mesh=None):
    """Binned cross-spectrum ``Re<c1 c2*>/V`` of two co-gridded fields.

    Same bins, multiplicities and conventions as
    :func:`calculate_power` (``calculate_cross_power(d, d)`` reproduces
    it bin for bin); the imaginary part integrates to zero for real
    fields and is dropped.  The standard use is tracer-matter
    cross-spectra of mock catalogs built from one realization (e.g.
    :meth:`randomfield_tpu.models.lognormal.LognormalGenerator.
    generate_biased_field`).  With ``mesh`` (slab or pencil) both
    transforms run distributed and the binning is shard-local.
    Returns ``(k_mean, p_cross, n_modes)``.
    """
    d1, d2 = jnp.asarray(delta1), jnp.asarray(delta2)
    if d1.shape != d2.shape:
        raise ValueError(
            f"fields must share a grid, got {d1.shape} vs {d2.shape}"
        )
    shape = tuple(int(s) for s in d1.shape[-3:])
    if mesh is not None:
        fn = _make_mesh_cross(mesh, shape, float(spacing), int(nbins))
        return _bins_to_host(*fn(d1, d2))
    counts, psum, ksum = _binned_cross(
        d1, d2, shape, float(spacing), int(nbins)
    )
    return _xi_host(counts, psum, ksum)


def calculate_masked_power(delta, mask, spacing, nbins=32, mesh=None):
    """Binned pseudo-P(k) of a survey-masked field.

    ``mask`` is the survey window W(x) >= 0 (selection/completeness;
    binary or weighted).  The estimator is the plain
    :func:`calculate_power` of ``W delta`` normalized by ``<W^2>``
    (the standard pseudo-spectrum convention) — its expectation is NOT
    the true P(k) but the window-convolved
    :func:`predicted_masked_power`, which shares these bins exactly.
    ``mask=1`` reduces to :func:`calculate_power` identically.
    ``mesh``: the window multiply is elementwise on the sharded field
    and the estimator runs distributed.
    Returns ``(k_mean, p_hat, n_modes)``.
    """
    d = jnp.asarray(delta)
    w = jnp.asarray(mask, d.dtype)
    if w.shape != d.shape[-3:]:
        raise ValueError(f"mask shape {w.shape} != field shape "
                         f"{d.shape[-3:]}")
    w2 = float(np.mean(np.asarray(mask, np.float64) ** 2))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    k, p, nm = calculate_power(w * d, spacing, nbins=nbins, mesh=mesh)
    return k, p / w2, nm


def predicted_masked_power(power, mask, spacing, nbins=32,
                           interpolation="log10k"):
    """EXACT expectation of :func:`calculate_masked_power`.

    The masked spectrum is the true grid spectrum convolved with the
    window's power: ``E[P_m(k)] = sum_k' P(k') |W_hat(k - k')|^2 /
    (N^3 sum W^2)`` — evaluated exactly as one FFT cycle (the
    convolution theorem: ``FFT[ IFFT(P) * IFFT(|W_hat|^2) ]``), then
    binned with the estimator's own bins, so measured-vs-predicted
    residuals are pure sample noise.  Host float64 (validation-scale:
    needs full-cube FFTs of the P and window grids).
    """
    from randomfield_tpu.ops import power as _power

    w = np.asarray(mask, np.float64)
    shape = w.shape
    if len(shape) != 3:
        raise ValueError("mask must be a 3-D grid")
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    ks = [2.0 * np.pi * np.fft.fftfreq(n, d=spacing) for n in shape]
    kmag = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                   + ks[2][None, None, :] ** 2)
    pg = np.asarray(
        _power.interpolate_power(table,
                                 jnp.asarray(kmag, jnp.float32),
                                 interpolation),
        np.float64,
    )
    pg[kmag == 0] = 0.0
    w_hat2 = np.abs(np.fft.fftn(w)) ** 2
    sum_w2 = (w * w).sum()
    if sum_w2 <= 0:
        raise ValueError("mask is identically zero")
    n3 = w.size
    conv = np.fft.fftn(np.fft.ifftn(pg) * np.fft.ifftn(w_hat2)).real * n3
    pm = conv / (n3 * sum_w2)
    # the masked field has a (window-leaked) DC component the
    # estimator masks out; bin the half-spectrum view like the
    # estimator does
    nzh = shape[2] // 2 + 1
    return bin_power_grid(
        jnp.asarray(pm[:, :, :nzh], jnp.float32), shape, spacing,
        nbins=nbins,
    )


def bin_power_grid(pgrid, shape, spacing, nbins=32):
    """Shell-average a per-mode power half-grid into the estimator bins.

    Bins an expectation grid ``E[P_hat(k)]`` with exactly the bins,
    multiplicities and masks of :func:`calculate_power`, so theory
    curves and measured spectra compare per bin with no binning
    systematics (the same trick :func:`predicted_correlation` uses for
    xi).  Returns ``(k_mean, p_mean, n_modes)``.
    """
    shape = tuple(int(s) for s in shape)
    p = jnp.asarray(pgrid)
    kmag = jnp.broadcast_to(_grid.kmag(shape, float(spacing), p.dtype), p.shape)
    edges, mult = _bin_setup(shape, float(spacing), int(nbins))
    counts, psum, ksum = _masked_bins(
        kmag, jnp.asarray(mult)[None, None, :], p,
        jnp.asarray(edges, p.dtype), int(nbins), per_slab=True,
    )
    return _xi_host(counts, psum, ksum)


def bin_power_multipoles_grid(pgrid, shape, spacing, nbins=32,
                              ells=(0, 2, 4), los_axis=2):
    """Multipole-average a per-mode power half-grid into estimator bins.

    The anisotropic companion of :func:`bin_power_grid`: bins an
    expectation grid ``E[P_hat(k)]`` (which may depend on mu through,
    e.g., the Kaiser kernel) with exactly the Legendre weights, bins,
    multiplicities and masks of :func:`calculate_power_multipoles`, so
    measured-vs-predicted P_ell residuals are pure sample noise —
    including the incomplete-shell mu-coverage effects above k_Nyquist
    the plain ``(2 ell + 1) K_ell P(k)`` continuum formula misses.
    Returns ``(k_mean, p_ell, n_modes)`` with ``p_ell`` shaped
    ``(len(ells), nbins)``.
    """
    shape = tuple(int(s) for s in shape)
    ells = tuple(int(e) for e in ells)
    p = jnp.asarray(pgrid)
    km = _grid.kmag(shape, float(spacing), p.dtype)
    kv = _grid.kvectors(shape, float(spacing))
    k_los = jnp.asarray(kv[int(los_axis)], p.dtype)
    bcast = [None, None, None]
    bcast[int(los_axis)] = slice(None)
    k_los = k_los[tuple(bcast)]
    mu2 = jnp.where(km > 0, (k_los / jnp.where(km > 0, km, 1.0)) ** 2, 0.0)
    edges, mult = _bin_setup(shape, float(spacing), int(nbins))
    kmb = jnp.broadcast_to(km, p.shape)
    multb = jnp.asarray(mult)[None, None, :]
    edges_j = jnp.asarray(edges, p.dtype)
    out = []
    counts = ksum = None
    for ell in ells:
        w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
        counts, psum, ksum = _masked_bins(
            kmb, multb, p * w_ell, edges_j, int(nbins), per_slab=True
        )
        out.append(psum)
    return _xi_host(counts, jnp.stack(out), ksum)


def spectrum_power(c, shape, spacing, nbins=32, layout="xyz"):
    """Realized binned P(k) directly from a packed sampled spectrum.

    No FFT involved: the render pipeline already holds c_k, and
    ``P_hat = |c_k|^2 * V`` under the engine's conventions — so
    covariance studies can skip the inverse transform entirely (and the
    expensive forward estimate).  Returns host float64 (k_mean, p_hat,
    n_modes) like :func:`calculate_power`.
    """
    counts, psum, ksum = _binned_spectrum(
        c, tuple(int(s) for s in shape), float(spacing), int(nbins), layout
    )
    counts = np.asarray(counts, np.float64)
    psum = np.asarray(psum, np.float64)
    ksum = np.asarray(ksum, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


# ---------------------------------------------------------------------------
# Two-point correlation function xi(r)
#
# xi_hat(r) = (1/V) sum_k P_hat(k) exp(ik.r) — one inverse transform of
# the per-mode power, binned by periodic minimum-image separation.  The
# Hermitian extension of the (real, symmetric) P_hat half-grid makes the
# packed irfftn compute the full-spectrum sum directly; no multiplicity
# weights are needed.  E[xi_hat] equals predicted_correlation bin for bin
# (same modes, same binning), so tests gate on pure sample noise.
# ---------------------------------------------------------------------------

def _r_bin_setup(shape, spacing, nbins):
    """Linear r bins over (0, half the shortest box side]."""
    rmax = 0.5 * min(shape) * spacing
    return np.linspace(0.0, rmax, nbins + 1)


def _min_image_axes(shape, spacing):
    """Per-axis periodic minimum-image distances (float64 host arrays)."""
    return [
        (np.minimum(np.arange(n), n - np.arange(n)) * spacing).astype(
            np.float64
        )
        for n in shape
    ]


def _min_image_r2(shape, spacing):
    ax = _min_image_axes(shape, spacing)
    return ax, (
        (ax[0] ** 2)[:, None, None]
        + (ax[1] ** 2)[None, :, None]
        + (ax[2] ** 2)[None, None, :]
    )


def _min_image_r(shape, spacing, dtype):
    """Periodic minimum-image separation |r| over the full real grid."""
    _, r2 = _min_image_r2(shape, spacing)
    return jnp.asarray(np.sqrt(r2), dtype)


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nbins"))
def _binned_xi_from_power_grid(p, shape, spacing, nbins):
    """Bin xi(r) from a P_hat half-grid (per-mode power, real f32)."""
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    xi = _transform.irfftn(
        (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64), shape
    )
    rmag = _min_image_r(shape, spacing, xi.dtype)
    edges = _r_bin_setup(shape, spacing, nbins)
    return _masked_bins(
        rmag, 1.0, xi, jnp.asarray(edges, xi.dtype), nbins, per_slab=True
    )


@functools.partial(jax.jit, static_argnames=("shape", "spacing", "nbins"))
def _binned_xi_from_field(delta, shape, spacing, nbins):
    p = _mode_power(delta, shape, spacing)
    # zero the DC mode (the field mean squared): the prediction carries
    # P(0) = 0, and a residual mean would otherwise offset every lag
    p = p.at[0, 0, 0].set(0.0)
    return _binned_xi_from_power_grid(p, shape, spacing, nbins)


def _min_image_r_mu2(shape, spacing, los_axis, dtype):
    """(|r|, (r_los/|r|)^2) over the real grid, one shared r^2 pass.

    Only mu^2 is needed — the even Legendre polynomials are polynomials
    in mu^2, and the minimum-image |r_los| loses only the (irrelevant)
    sign of mu.  The zero-lag cell gets mu^2 = 0; it is excluded from
    every bin anyway (r > 0 mask in _masked_bins).
    """
    ax, r2 = _min_image_r2(shape, spacing)
    shp = [1, 1, 1]
    shp[los_axis] = shape[los_axis]
    rlos2 = (ax[los_axis] ** 2).reshape(shp)
    with np.errstate(invalid="ignore", divide="ignore"):
        mu2 = np.where(r2 > 0, rlos2 / r2, 0.0)
    return jnp.asarray(np.sqrt(r2), dtype), jnp.asarray(mu2, dtype)


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "ells", "los_axis"),
)
def _binned_xi_multipoles_from_power_grid(p, shape, spacing, nbins, ells,
                                          los_axis):
    """Bin xi_ell(s) from a P_hat half-grid: one inverse transform of the
    per-mode power, then r-shell binning with (2l+1) L_l(mu) weights."""
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    xi = _transform.irfftn(
        (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64), shape
    )
    rmag, mu2 = _min_image_r_mu2(shape, spacing, los_axis, xi.dtype)
    edges = jnp.asarray(_r_bin_setup(shape, spacing, nbins), xi.dtype)
    counts = ksum = None
    psums = []
    for ell in ells:
        w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
        c, ps, ks = _masked_bins(rmag, 1.0, xi * w_ell, edges, nbins,
                                 per_slab=True)
        psums.append(ps)
        if counts is None:
            counts, ksum = c, ks
    return counts, jnp.stack(psums), ksum


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "ells", "los_axis"),
)
def _binned_xi_multipoles_from_field(delta, shape, spacing, nbins, ells,
                                     los_axis):
    p = _mode_power(delta, shape, spacing)
    p = p.at[0, 0, 0].set(0.0)  # a residual mean would offset every lag
    return _binned_xi_multipoles_from_power_grid(
        p, shape, spacing, nbins, ells, los_axis
    )


@functools.lru_cache(maxsize=16)
def _make_mesh_xi_multipoles(mesh, shape, spacing, nbins, ells, los_axis,
                             cross=False):
    """Distributed xi_ell(s): sharded forward -> per-mode power ->
    sharded inverse -> shard-local minimum-image (r, mu) binning with
    (2l+1) L_l weights + one psum.  Slab and pencil meshes.

    ``cross=True`` returns a two-field program fn(w, d) binning the
    cross-correlation <w(x) d(x+r)> instead of the autocorrelation —
    the distributed backend of validate/profiles.py:stacked_profile."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel import pencil as _pencil
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    is_pencil = _pencil.is_pencil_mesh(mesh)
    volume = nx * ny * nz * spacing**3
    edges = _r_bin_setup(shape, spacing, nbins)
    ax = _min_image_axes(shape, spacing)
    if is_pencil:
        px = mesh.shape[_pencil.SPX_AXIS]
        py = mesh.shape[_pencil.SPY_AXIS]
        nx_loc, ny_loc = nx // px, ny // py
        in_spec = P(_pencil.SPX_AXIS, _pencil.SPY_AXIS, None)
        psum_axes = (_pencil.SPX_AXIS, _pencil.SPY_AXIS)
    else:
        n_space = mesh.shape[SPACE_AXIS]
        nx_loc, ny_loc = nx // n_space, ny
        in_spec = P(SPACE_AXIS, None, None)
        psum_axes = SPACE_AXIS

    def _local_bins(xil):
        jx = (jax.lax.axis_index(_pencil.SPX_AXIS) if is_pencil
              else jax.lax.axis_index(SPACE_AXIS))
        ax_l = jax.lax.dynamic_slice(
            jnp.asarray(ax[0], xil.dtype), (jx * nx_loc,), (nx_loc,)
        )
        if is_pencil:
            jy = jax.lax.axis_index(_pencil.SPY_AXIS)
            ay_l = jax.lax.dynamic_slice(
                jnp.asarray(ax[1], xil.dtype), (jy * ny_loc,), (ny_loc,)
            )
        else:
            ay_l = jnp.asarray(ax[1], xil.dtype)
        az_l = jnp.asarray(ax[2], xil.dtype)
        d2 = [
            (ax_l * ax_l)[:, None, None],
            (ay_l * ay_l)[None, :, None],
            (az_l * az_l)[None, None, :],
        ]
        r2 = d2[0] + d2[1] + d2[2]
        rmag = jnp.sqrt(r2)
        mu2 = jnp.where(
            r2 > 0, d2[los_axis] / jnp.where(r2 > 0, r2, 1.0), 0.0
        )
        out = []
        counts = rsum = None
        for ell in ells:
            w_ell = (2.0 * ell + 1.0) * _LEGENDRE_EVEN[ell](mu2)
            c, ps, ks = _masked_bins(
                jnp.broadcast_to(rmag, xil.shape), 1.0, xil * w_ell,
                jnp.asarray(edges, xil.dtype), nbins, per_slab=True,
            )
            out.append(ps)
            if counts is None:
                counts, rsum = c, ks
        return jax.lax.psum(
            jnp.stack([counts, rsum] + out), psum_axes
        )

    def _bin_power_grid(p):
        xi_in = (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64)
        if is_pencil:
            xi = _pencil.irfftn_pencil(
                xi_in, shape, mesh, assume_hermitian=True,
                input_layout="state1",
            )
        else:
            xi = dfft.irfftn_slab(xi_in, shape, mesh)
        bins = jax.shard_map(
            _local_bins, mesh=mesh, in_specs=in_spec, out_specs=P(),
            check_vma=False,
        )(xi)
        return bins[0], bins[2:], bins[1]

    def _fwd(x):
        if is_pencil:
            return _pencil.rfftn_pencil(x, shape, mesh)
        return dfft.rfftn_slab(x, shape, mesh)

    @jax.jit
    def fn(delta):
        scale = jnp.asarray((spacing**3) ** 2 / volume, jnp.float32)
        c = _fwd(delta)
        p = (c.real**2 + c.imag**2) * scale
        p = p.at[0, 0, 0].set(0.0)
        return _bin_power_grid(p)

    @jax.jit
    def fn_cross(w, d):
        scale = jnp.asarray((spacing**3) ** 2 / volume, jnp.float32)
        cw = _fwd(w)
        cd = _fwd(d)
        p = (cw.real * cd.real + cw.imag * cd.imag) * scale
        p = p.at[0, 0, 0].set(0.0)
        return _bin_power_grid(p)

    return fn_cross if cross else fn


def calculate_correlation_multipoles(delta, spacing, nbins=24,
                                     ells=(0, 2, 4), los_axis=2,
                                     mesh=None):
    """Correlation-function multipoles xi_ell(s) along a plane-parallel LOS.

    ``xi_ell(s) = (2 ell + 1) < L_ell(mu) xi(s, mu) >_s-bin`` with
    ``mu = s_los / |s|`` under the periodic minimum image — the
    configuration-space counterpart of
    :func:`calculate_power_multipoles` (Kaiser at linear order:
    ``xi_0 = (1 + 2f/3 + f^2/5) xi``, with xi_2/xi_4 fixed by the same
    ``P_ell -> xi_ell`` spherical-Bessel transforms).  Even multipoles
    only (odd ones vanish for an autocorrelation, xi(-s) = xi(s)).
    Returns ``(r_mean, xi_ell, n_cells)`` with ``xi_ell`` shaped
    ``(len(ells), nbins)``; ``ells=(0,)`` reproduces
    :func:`calculate_correlation` bin for bin.  The exact estimator
    expectation for a power table (optionally Kaiser-distorted) is
    :func:`predicted_correlation_multipoles`.  With ``mesh`` (slab or
    pencil) the transforms run distributed and the (r, mu) binning is
    shard-local with one psum.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    ells = tuple(int(e) for e in ells)
    for e in ells:
        if e not in _LEGENDRE_EVEN:
            raise ValueError(
                f"ell={e} unsupported: even multipoles 0/2/4 only (odd "
                "ones vanish for an autocorrelation)"
            )
    if mesh is not None:
        from randomfield_tpu.parallel.multihost import replicated_to_host

        fn = _make_mesh_xi_multipoles(
            mesh, shape, float(spacing), int(nbins), ells, int(los_axis)
        )
        counts, psums, rsum = fn(jnp.asarray(delta))
        return _xi_host(
            replicated_to_host(counts), replicated_to_host(psums),
            replicated_to_host(rsum),
        )
    counts, psums, rsum = _binned_xi_multipoles_from_field(
        jnp.asarray(delta), shape, float(spacing), int(nbins), ells,
        int(los_axis)
    )
    return _xi_host(counts, psums, rsum)


def predicted_correlation_multipoles(power, shape, spacing, f=0.0, nbins=24,
                                     ells=(0, 2, 4), los_axis=2,
                                     interpolation="log10k"):
    """Expectation of :func:`calculate_correlation_multipoles` for a
    power table, optionally Kaiser-distorted.

    Interpolates P onto this grid's discrete modes, applies the linear
    Kaiser factor ``(1 + f mu_k^2)^2`` (``f = cosmology.growth_rate``;
    ``f=0`` is the isotropic expectation), and runs the identical
    transform + binning — so measured-vs-predicted residuals are pure
    sample noise, including every discreteness effect (incomplete
    shells, anisotropic mu coverage at large s).
    """
    from randomfield_tpu.ops import power as _power

    shape = tuple(int(s) for s in shape)
    ells = tuple(int(e) for e in ells)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    if f:
        kvecs = _grid.kvectors(shape, float(spacing))
        klos = kvecs[int(los_axis)]
        kshp = [1, 1, 1]
        kshp[int(los_axis)] = klos.shape[0]
        mu2k = jnp.where(
            kmag > 0, (klos.reshape(kshp) / jnp.where(kmag > 0, kmag, 1.0)) ** 2,
            0.0,
        )
        pgrid = pgrid * (1.0 + float(f) * mu2k) ** 2
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)
    counts, psums, rsum = _binned_xi_multipoles_from_power_grid(
        pgrid, shape, float(spacing), int(nbins), ells, int(los_axis)
    )
    return _xi_host(counts, psums, rsum)


def _xi_host(counts, psum, ksum):
    counts = np.asarray(counts, np.float64)
    psum = np.asarray(psum, np.float64)
    ksum = np.asarray(ksum, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return ksum / counts, psum / counts, counts


# ---------------------------------------------------------------------------
# Projected correlation function w_p(r_p)
#
# w_p(r_p) = 2 * integral_0^{pi_max} xi(r_p, pi) dpi along a plane-parallel
# line of sight — the classic galaxy-survey statistic that integrates out
# redshift-space distortions along pi.  On the periodic grid the integral
# is a masked minimum-image lag sum: Delta * sum over LOS lags with
# |pi| <= pi_max of xi(r_p, pi) (the +pi and -pi images each count once,
# reproducing the symmetric 2*int_0 form in the continuum limit).
# ---------------------------------------------------------------------------

def _wp_bin_setup(shape, spacing, nbins, los_axis):
    """Linear r_p bins over (0, half the shortest transverse side]."""
    tr = [a for a in range(3) if a != int(los_axis)]
    rmax = 0.5 * min(shape[tr[0]], shape[tr[1]]) * spacing
    return np.linspace(0.0, rmax, nbins + 1)


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "pi_max", "los_axis"),
)
def _binned_wp_from_power_grid(p, shape, spacing, nbins, pi_max, los_axis):
    """Bin w_p(r_p) from a P_hat half-grid: one inverse transform of the
    per-mode power, a masked LOS lag sum, then transverse r_p binning."""
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    xi = _transform.irfftn(
        (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64), shape
    )
    los = int(los_axis)
    ax = _min_image_axes(shape, spacing)
    w_pi = np.where(ax[los] <= pi_max * (1.0 + 1e-9), spacing, 0.0)
    shp = [1, 1, 1]
    shp[los] = shape[los]
    wmap = jnp.sum(xi * jnp.asarray(w_pi, xi.dtype).reshape(shp), axis=los)
    tr = [a for a in range(3) if a != los]
    rp = np.sqrt((ax[tr[0]] ** 2)[:, None] + (ax[tr[1]] ** 2)[None, :])
    edges = jnp.asarray(
        _wp_bin_setup(shape, spacing, nbins, los), xi.dtype
    )
    return _masked_bins(
        jnp.asarray(rp, xi.dtype), 1.0, wmap, edges, nbins, per_slab=True
    )


@functools.partial(
    jax.jit,
    static_argnames=("shape", "spacing", "nbins", "pi_max", "los_axis"),
)
def _binned_wp_from_field(delta, shape, spacing, nbins, pi_max, los_axis):
    p = _mode_power(delta, shape, spacing)
    p = p.at[0, 0, 0].set(0.0)  # a residual mean would offset every lag
    return _binned_wp_from_power_grid(
        p, shape, spacing, nbins, pi_max, los_axis
    )


def _resolve_pi_max(pi_max, shape, spacing, los_axis):
    if pi_max is None:
        return 0.5 * shape[int(los_axis)] * spacing
    return float(pi_max)


def calculate_projected_correlation(delta, spacing, nbins=24, pi_max=None,
                                    los_axis=2):
    """Projected correlation w_p(r_p) along a plane-parallel line of sight.

    ``w_p(r_p) = 2 integral_0^{pi_max} xi(r_p, pi) dpi`` — the
    RSD-insensitive two-point statistic of galaxy surveys (Davis &
    Peebles 1983 form), realized here as a minimum-image LOS lag sum of
    the same xi grid the other correlation estimators use (one inverse
    transform of the per-mode power, no pair counting).  ``pi_max``
    (Mpc/h) defaults to half the LOS box — the full distinct-lag range;
    the r_p = 0 column (pure LOS pairs) is excluded like every zero-lag
    cell.  Returns ``(rp_mean, wp, n_cells)``; w_p carries units of
    Mpc/h.  The exact estimator expectation is
    :func:`predicted_projected_correlation`; the continuum theory curve
    is :func:`randomfield_tpu.ops.power.power_to_projected_correlation`.
    Single-device validation-scale tool, like the other xi estimators.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    pi_max = _resolve_pi_max(pi_max, shape, float(spacing), los_axis)
    counts, psums, rsum = _binned_wp_from_field(
        jnp.asarray(delta), shape, float(spacing), int(nbins), pi_max,
        int(los_axis)
    )
    return _xi_host(counts, psums, rsum)


def predicted_projected_correlation(power, shape, spacing, f=0.0, nbins=24,
                                    pi_max=None, los_axis=2,
                                    interpolation="log10k"):
    """Expectation of :func:`calculate_projected_correlation` for a power
    table, optionally Kaiser-distorted.

    Interpolates P onto this grid's discrete modes, applies the linear
    Kaiser factor ``(1 + f mu_k^2)^2`` (``f=0``: isotropic), and runs
    the identical transform + LOS sum + binning — so
    measured-vs-predicted residuals are pure sample noise, including
    every discreteness and minimum-image truncation effect the
    continuum ``2 int xi dpi`` formula misses.
    """
    from randomfield_tpu.ops import power as _power

    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    if f:
        kvecs = _grid.kvectors(shape, float(spacing))
        klos = kvecs[int(los_axis)]
        kshp = [1, 1, 1]
        kshp[int(los_axis)] = klos.shape[0]
        mu2k = jnp.where(
            kmag > 0,
            (klos.reshape(kshp) / jnp.where(kmag > 0, kmag, 1.0)) ** 2,
            0.0,
        )
        pgrid = pgrid * (1.0 + float(f) * mu2k) ** 2
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)
    pi_max = _resolve_pi_max(pi_max, shape, float(spacing), los_axis)
    counts, psums, rsum = _binned_wp_from_power_grid(
        pgrid, shape, float(spacing), int(nbins), pi_max, int(los_axis)
    )
    return _xi_host(counts, psums, rsum)


@functools.lru_cache(maxsize=16)
def _make_sharded_xi(mesh, shape, spacing, nbins):
    """Distributed xi(r) on a ('data','space') slab mesh: sharded forward
    transform -> per-mode power -> sharded inverse transform of P_hat ->
    shard-local minimum-image r binning + psum.  The full xi grid is
    sharded along x throughout; nothing is gathered."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import dfft
    from randomfield_tpu.parallel.mesh import SPACE_AXIS

    nx, ny, nz = shape
    n_space = mesh.shape[SPACE_AXIS]
    nx_loc = nx // n_space
    volume = nx * ny * nz * spacing**3
    edges = _r_bin_setup(shape, spacing, nbins)
    ax = _min_image_axes(shape, spacing)

    def _local_bins(xil):
        j = jax.lax.axis_index(SPACE_AXIS)
        ax_l = jax.lax.dynamic_slice(
            jnp.asarray(ax[0], xil.dtype), (j * nx_loc,), (nx_loc,)
        )
        rmag = jnp.sqrt(
            (ax_l * ax_l)[:, None, None]
            + jnp.asarray(ax[1] ** 2, xil.dtype)[None, :, None]
            + jnp.asarray(ax[2] ** 2, xil.dtype)[None, None, :]
        )
        counts, psum_, rsum = _masked_bins(
            rmag, 1.0, xil, jnp.asarray(edges, xil.dtype), nbins,
            per_slab=True,
        )
        return jax.lax.psum(jnp.stack([counts, psum_, rsum]), SPACE_AXIS)

    @jax.jit
    def fn(delta):
        c = dfft.rfftn_slab(delta, shape, mesh)  # sharded along ky
        scale = jnp.asarray((spacing**3) ** 2 / volume, jnp.float32)
        p = (c.real**2 + c.imag**2) * scale
        p = p.at[0, 0, 0].set(0.0)  # DC: a residual mean offsets all lags
        xi = dfft.irfftn_slab(
            (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64),
            shape, mesh,
        )  # sharded along x
        bins = jax.shard_map(
            _local_bins, mesh=mesh,
            in_specs=P(SPACE_AXIS, None, None),
            out_specs=P(),
            check_vma=False,
        )(xi)
        return bins[0], bins[1], bins[2]

    return fn


@functools.lru_cache(maxsize=16)
def _make_pencil_xi(mesh, shape, spacing, nbins):
    """Distributed xi(r) on a 2-D pencil mesh: pencil transforms with
    the xi grid sharded (x over 'spx', y over 'spy'), shard-local
    minimum-image r binning from sliced axis vectors, one psum over
    both spatial axes."""
    from jax.sharding import PartitionSpec as P

    from randomfield_tpu.parallel import pencil as _pencil

    nx, ny, nz = shape
    px = mesh.shape[_pencil.SPX_AXIS]
    py = mesh.shape[_pencil.SPY_AXIS]
    nx_loc, ny_loc = nx // px, ny // py
    volume = nx * ny * nz * spacing**3
    edges = _r_bin_setup(shape, spacing, nbins)
    ax = _min_image_axes(shape, spacing)

    def _local_bins(xil):
        jx = jax.lax.axis_index(_pencil.SPX_AXIS)
        jy = jax.lax.axis_index(_pencil.SPY_AXIS)
        ax_l = jax.lax.dynamic_slice(
            jnp.asarray(ax[0], xil.dtype), (jx * nx_loc,), (nx_loc,)
        )
        ay_l = jax.lax.dynamic_slice(
            jnp.asarray(ax[1], xil.dtype), (jy * ny_loc,), (ny_loc,)
        )
        rmag = jnp.sqrt(
            (ax_l * ax_l)[:, None, None]
            + (ay_l * ay_l)[None, :, None]
            + jnp.asarray(ax[2] ** 2, xil.dtype)[None, None, :]
        )
        counts, psum_, rsum = _masked_bins(
            rmag, 1.0, xil, jnp.asarray(edges, xil.dtype), nbins,
            per_slab=True,
        )
        return jax.lax.psum(
            jnp.stack([counts, psum_, rsum]),
            (_pencil.SPX_AXIS, _pencil.SPY_AXIS),
        )

    @jax.jit
    def fn(delta):
        c = _pencil.rfftn_pencil(delta, shape, mesh)  # state 1
        scale = jnp.asarray((spacing**3) ** 2 / volume, jnp.float32)
        p = (c.real**2 + c.imag**2) * scale
        p = p.at[0, 0, 0].set(0.0)
        xi = _pencil.irfftn_pencil(
            (p / jnp.asarray(volume, p.dtype)).astype(jnp.complex64),
            shape, mesh, assume_hermitian=True, input_layout="state1",
        )
        bins = jax.shard_map(
            _local_bins, mesh=mesh,
            in_specs=P(_pencil.SPX_AXIS, _pencil.SPY_AXIS, None),
            out_specs=P(),
            check_vma=False,
        )(xi)
        return bins[0], bins[1], bins[2]

    return fn


def calculate_correlation(delta, spacing, nbins=24, mesh=None):
    """Measured isotropic two-point correlation xi(r) of a field.

    Returns ``(r_mean, xi_hat, n_cells)`` numpy arrays: per-bin
    cell-weighted mean separation, mean correlation, and cell-pair count
    (one entry per grid cell — every cell contributes its periodic
    autocorrelation at each lag).  Bins are linear in r from 0 to half
    the shortest box side; the zero-lag cell (the variance) is excluded.
    Empty bins yield NaN.

    Single-device by default (the full xi grid plus the minimum-image
    radius grid are materialized — fine through 512^3).  With ``mesh``
    (a ('data','space') slab mesh sharding along x, or a 2-D pencil
    mesh sharding x/y) both transforms run distributed and the r
    binning is shard-local with a psum — xi scales to the same grids
    as the sharded renders.  The companion theory curve on the SAME
    discrete modes and bins is :func:`predicted_correlation`; the
    continuum-integral counterpart is
    :func:`randomfield_tpu.ops.power.power_to_correlation`.
    """
    shape = tuple(int(s) for s in delta.shape[-3:])
    if mesh is not None:
        from randomfield_tpu.parallel.mesh import SPACE_AXIS
        from randomfield_tpu.parallel.multihost import replicated_to_host
        from randomfield_tpu.parallel.pencil import is_pencil_mesh

        if is_pencil_mesh(mesh):
            fn = _make_pencil_xi(mesh, shape, float(spacing), int(nbins))
            counts, psum, rsum = fn(delta)
            return _xi_host(
                replicated_to_host(counts), replicated_to_host(psum),
                replicated_to_host(rsum),
            )
        if mesh.shape.get(SPACE_AXIS, 1) > 1 or not getattr(
            delta, "is_fully_addressable", True
        ):
            fn = _make_sharded_xi(mesh, shape, float(spacing), int(nbins))
            counts, psum, rsum = fn(delta)
            return _xi_host(
                replicated_to_host(counts), replicated_to_host(psum),
                replicated_to_host(rsum),
            )
    counts, psum, ksum = _binned_xi_from_field(
        jnp.asarray(delta), shape, float(spacing), int(nbins)
    )
    return _xi_host(counts, psum, ksum)


def predicted_correlation(power, shape, spacing, nbins=24,
                          interpolation="log10k"):
    """Expectation of :func:`calculate_correlation` for a power table.

    Interpolates P onto this grid's discrete modes (the engine's
    log10(k) convention), runs the identical inverse transform and
    binning, and returns ``(r_mean, xi, n_cells)`` — the exact estimator
    expectation, so measured-vs-predicted residuals are pure sample
    noise (no discreteness systematics).
    """
    from randomfield_tpu.ops import power as _power

    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), jnp.float32)
    pgrid = _power.interpolate_power(table, kmag, interpolation)
    pgrid = jnp.where(kmag > 0, pgrid, 0.0)
    counts, psum, ksum = _binned_xi_from_power_grid(
        pgrid, shape, float(spacing), int(nbins)
    )
    return _xi_host(counts, psum, ksum)


@functools.partial(jax.jit, static_argnames=("nbins",))
def _binned_values(x, edges, nbins):
    """Histogram + per-bin value sums via the one-hot matmul contraction
    (scatter-add serializes colliding updates; see _dot_bin)."""
    # np.histogram semantics: bins are left-inclusive, the last bin also
    # includes the right edge (side='right' keeps x == vmin in bin 0)
    idx = jnp.searchsorted(edges, x, side="right", method="compare_all") - 1
    idx = jnp.where(x == edges[-1], nbins - 1, idx)
    valid = (idx >= 0) & (idx < nbins)
    idx = jnp.where(valid, idx, nbins)
    w = jnp.where(valid, 1.0, 0.0).astype(x.dtype)
    counts, vsum, _ = jax.vmap(
        lambda ix, wx, px: _dot_bin(ix, wx, px, px, nbins)
    )(idx.reshape(idx.shape[0], -1), w.reshape(w.shape[0], -1),
      x.reshape(x.shape[0], -1))
    return jnp.sum(counts, axis=0), jnp.sum(vsum, axis=0)


def field_pdf(delta, nbins=64, vmin=None, vmax=None):
    """One-point PDF of field values (device-binned histogram density).

    Linear bins over ``[vmin, vmax]`` (defaults: the field's min/max,
    stretched 1e-3 so the extremes land inside).  Returns ``(centers,
    density, counts)`` with ``centers`` the per-bin mean VALUE (not the
    midpoint — matches how the k/r estimators report bin positions;
    NaN for empty bins) and ``density`` normalized so ``sum(density *
    bin_width)`` equals the in-range fraction (1 with default bounds).
    Validation-scale companion of :func:`field_moments`: a rendered
    Gaussian field's density matches the normal curve with
    ``predicted_variance``, a lognormal mock's matches the lognormal
    curve (gated in tests).
    """
    d = jnp.asarray(delta)
    shape = d.shape
    d3 = d.reshape((-1,) + shape[-2:]) if d.ndim >= 3 else d.reshape(1, -1)
    if vmin is None or vmax is None:
        lo = float(d.min())
        hi = float(d.max())
        span = (hi - lo) or 1.0
        vmin = lo - 1e-3 * span if vmin is None else float(vmin)
        vmax = hi + 1e-3 * span if vmax is None else float(vmax)
    if not vmax > vmin:
        raise ValueError(f"need vmax > vmin, got [{vmin}, {vmax}]")
    edges = np.linspace(float(vmin), float(vmax), int(nbins) + 1)
    counts, vsum = _binned_values(
        d3, jnp.asarray(edges, d.dtype), int(nbins)
    )
    counts = np.asarray(counts, np.float64)
    vsum = np.asarray(vsum, np.float64)
    width = edges[1] - edges[0]
    ntot = float(np.prod(shape))
    with np.errstate(invalid="ignore", divide="ignore"):
        centers = vsum / counts
    density = counts / (ntot * width)
    return centers, density, counts


def cell_variance(delta, m):
    """(mean, variance) of m^3-cell block averages of a field.

    Counts-in-cells workhorse: block-average the grid into cubes of
    ``m`` cells per side (every axis must divide) and return host
    floats.  ``m=1`` is :func:`field_moments`.  The exact expectation
    of the variance for a power table is
    :func:`predicted_cell_variance`.
    """
    d = jnp.asarray(delta)
    nx, ny, nz = (int(s) for s in d.shape[-3:])
    m = int(m)
    if m < 1 or nx % m or ny % m or nz % m:
        raise ValueError(
            f"block size {m} must divide every grid axis {(nx, ny, nz)}"
        )
    blocks = d.reshape(nx // m, m, ny // m, m, nz // m, m)
    blocks = blocks.mean(axis=(1, 3, 5))
    return field_moments(blocks)


def predicted_cell_variance(power, shape, spacing, m,
                            interpolation="log10k"):
    """Exact expectation of :func:`cell_variance`'s variance.

    Block-averaging is a linear filter: in Fourier space the m-cell
    boxcar multiplies each mode by the Dirichlet kernel product
    ``W(k) = prod_a sin(m k_a dx/2) / (m sin(k_a dx/2))``, so the
    block-averaged field's variance is ``sum_k P(k) |W(k)|^2 / V`` over
    this grid's discrete modes — subsampling to one value per block
    changes no one-point statistics.  ``m=1`` reduces to the engine's
    ``predicted_variance`` (W = 1).
    """
    from randomfield_tpu.ops import power as _power

    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    m = int(m)
    if m < 1 or any(s % m for s in shape):
        raise ValueError(f"block size {m} must divide every axis {shape}")
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    kmag = np.asarray(_grid.kmag(shape, spacing, jnp.float32), np.float64)
    pgrid = np.asarray(
        _power.interpolate_power(table, jnp.asarray(kmag, jnp.float32),
                                 interpolation),
        np.float64,
    )
    pgrid = np.where(kmag > 0, pgrid, 0.0)
    kv = [np.asarray(v, np.float64) for v in _grid.kvectors(shape, spacing)]

    def dirichlet(k):
        x = k * spacing / 2.0
        with np.errstate(invalid="ignore", divide="ignore"):
            w = np.where(
                np.abs(np.sin(x)) > 0,
                np.sin(m * x) / (m * np.where(np.abs(np.sin(x)) > 0,
                                              np.sin(x), 1.0)),
                1.0,
            )
        return w

    w2 = (
        (dirichlet(kv[0]) ** 2)[:, None, None]
        * (dirichlet(kv[1]) ** 2)[None, :, None]
        * (dirichlet(kv[2]) ** 2)[None, None, :]
    )
    nz = shape[2]
    mult = np.full(nz // 2 + 1, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    return float((pgrid * w2 * mult[None, None, :]).sum() / volume)


def _mean_axiswise(x):
    """Mean via one axis at a time — each reduction sums only O(n) terms.

    A flat f32 mean over ~10^8+ elements can accumulate sequentially
    enough to saturate the mantissa (biasing x^2 sums low by tens of
    percent at 512^3); per-axis reductions keep every partial sum short
    so the bias is O(n * eps) instead.
    """
    while x.ndim:
        x = jnp.mean(x, axis=-1)
    return x


@jax.jit
def _moments(delta):
    m = _mean_axiswise(delta)
    v = _mean_axiswise((delta - m) ** 2)
    return m, v


def field_moments(delta):
    """(mean, variance) of a field as host floats (accumulation-safe).

    Works on sharded (including multi-process) fields: the per-axis
    reductions run where the data lives and the replicated scalars are
    read from a local shard.
    """
    from randomfield_tpu.parallel.multihost import replicated_to_host

    if isinstance(delta, jax.Array) and not delta.is_fully_addressable:
        m, v = _moments(delta)
    else:
        m, v = _moments(jnp.asarray(delta))
    return float(replicated_to_host(m)), float(replicated_to_host(v))


# ---------------------------------------------------------------------------
# Line-of-sight 1-D (skewer) power spectra
#
# Each transverse site (x, y) defines a skewer delta(x, y, .) whose 1-D
# spectrum is c1(k_par) = a sum_z delta e^{-i k_par z}; the estimator
# averages |c1|^2 / L_par over every skewer.  The exact discrete
# expectation is the transverse-plane sum of the 3-D per-mode power,
#
#     E[P1D(k_par)] = (1 / A_perp) sum_{k_perp} P(k_perp, k_par),
#
# the lattice form of P1D = int d^2k_perp / (2 pi)^2 P(k) — the classic
# Lyman-alpha / IGM skewer statistic.  Per packed k_par mode, no
# binning, so measured-vs-predicted residuals are pure sample noise.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("spacing", "los_axis"))
def _p1d_device(delta, spacing, los_axis):
    d = jnp.moveaxis(delta, int(los_axis), -1)
    n_par = d.shape[-1]
    c1 = jnp.fft.rfft(d.astype(jnp.float32), axis=-1)  # minor-axis FFT
    p = c1.real**2 + c1.imag**2
    # mean over skewers axiswise (accumulation safety), |a . |^2 / L_par
    return p.mean(axis=0).mean(axis=0) * (float(spacing) / n_par)


def calculate_power_1d(delta, spacing, los_axis=2):
    """Mean 1-D line-of-sight power of all skewers of a field.

    Returns ``(k_par, p1d)`` host float64 arrays over the non-negative
    rfft frequencies of the LOS axis (``n_par // 2 + 1`` modes,
    per-mode — no binning).  Units: P1D in (Mpc/h) for delta in
    density-contrast convention.  Compare against
    :func:`predicted_power_1d` on the same arguments.
    """
    delta = jnp.asarray(delta)
    if delta.ndim != 3:
        raise ValueError("calculate_power_1d expects one (nx, ny, nz) field")
    n_par = int(delta.shape[int(los_axis)])
    k_par = 2.0 * np.pi * np.fft.rfftfreq(n_par, d=float(spacing))
    p1d = np.asarray(
        _p1d_device(delta, float(spacing), int(los_axis)), np.float64)
    return k_par, p1d


def predicted_power_1d(power, shape, spacing, los_axis=2,
                       smoothing_length=0.0, interpolation="log10k",
                       pgrid=None):
    """EXACT per-mode expectation of :func:`calculate_power_1d`.

    ``power`` is interpolated onto the grid like the render path
    (optionally Gaussian-smoothed); pass ``pgrid=`` (a per-mode
    expectation half-grid, e.g. Kaiser ``Generator._kaiser_pgrid``) to
    override it — any per-axis-even anisotropic expectation works.
    For the packed LOS axis the transverse sum is the plane sum; for
    x/y LOS axes the kz multiplicities (2 interior, 1 on the kz=0 /
    Nyquist planes) restore the unstored half.  Identity (gated):
    ``sum_par mult_par * E1D / L_par`` equals the predicted field
    variance exactly.  Returns ``(k_par, e1d)`` float64.
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    los_axis = int(los_axis)
    from randomfield_tpu.ops import power as _power

    if pgrid is None:
        table = _power.validate_power(power)
        km = _grid.kmag(shape, spacing, jnp.float32)
        pg = _power.interpolate_power(table, km, interpolation)
        sm = float(smoothing_length)
        if sm:
            pg = pg * jnp.exp(-(km * km) * sm * sm)
        pg = jnp.where(km > 0, pg, 0.0)
    else:
        pg = jnp.asarray(pgrid)
    pg = np.asarray(pg, np.float64)
    nx, ny, nz = shape
    a_perp = (
        {0: ny * nz, 1: nx * nz, 2: nx * ny}[los_axis] * spacing * spacing
    )
    if los_axis == 2:
        e1d = pg.sum(axis=(0, 1)) / a_perp
        n_par = nz
    else:
        nzh = nz // 2 + 1
        mult = np.full(nzh, 2.0)
        mult[0] = 1.0
        if nz % 2 == 0:
            mult[-1] = 1.0
        w = pg * mult[None, None, :]
        other = 1 if los_axis == 0 else 0
        full = w.sum(axis=2).sum(axis=other)  # (n_los,) over full indices
        n_par = shape[los_axis]
        # rfft k_par picks the non-negative representatives; P is even
        # per axis, so the +f and -f rows are equal — take the packed
        # half directly
        e1d = full[: n_par // 2 + 1] / a_perp
    k_par = 2.0 * np.pi * np.fft.rfftfreq(n_par, d=spacing)
    return k_par, e1d
