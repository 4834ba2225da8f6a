"""Constrained / data-conditioned sampling methods of the Generator.

Split out of engine/generator.py (round 4).  Hoffman-Ribak constrained
realizations, Wiener filtering and posterior sampling — single-device
and mesh-native paths; the math lives in models/constrained.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from randomfield_tpu.ops import power as _power


def _gen_as_key(seed):
    from randomfield_tpu.engine.generator import _as_key

    return _as_key(seed)


class ConstrainedMixin:
    """Constraint packing, Hoffman-Ribak renders, Wiener/posterior."""

    # ---- constrained realizations / data-conditioned sampling ---------------
    def _require_constrainable(self, what, allow_mesh=False):
        if self.mesh is not None:
            if allow_mesh:
                return
            raise ValueError(
                f"{what} needs a single-device fused scene with a "
                "materialized sigma grid (sampler='threefry' or 'nested', "
                "pipeline='fused', mesh=None)"
            )
        if self.state.sigmas is None or self._layout != "xyz":
            raise ValueError(
                f"{what} needs a single-device fused scene with a "
                "materialized sigma grid (sampler='threefry' or 'nested', "
                "pipeline='fused', mesh=None)"
            )

    def _packed_constraints(self, constraints):
        from randomfield_tpu.models import constrained as _con

        return _con.pack_constraints(
            constraints, self.scene.shape, self.scene.grid_spacing,
            self._dtype,
        )

    def constraint_matrix(self, constraints, smoothing_length=0.0):
        """The M x M covariance matrix of the constraint functionals.

        xi_ij = <Gamma_i Gamma_j> under this scene's P(k) (and optional
        render smoothing) — host float64.  Inspect its conditioning
        before trusting a large constraint set (models/constrained.py).
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("constraint_matrix", allow_mesh=True)
        pos, scales, _ = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(
            pos, scales, float(smoothing_length)
        )
        from randomfield_tpu.parallel.multihost import replicated_to_host

        return np.asarray(replicated_to_host(gram), np.float64)

    def generate_constrained_field(self, seed, constraints,
                                   smoothing_length=0.0,
                                   apply_lightcone=False):
        """Hoffman-Ribak constrained realization of this scene (snapshot).

        Each constraint pins the Gaussian-smoothed field value at a
        comoving position EXACTLY (per realization, not just on average)
        while the field everywhere else keeps the correct conditional
        ensemble statistics: ``constraints`` is an iterable of
        ``(position, value, scale)`` tuples or dicts — see
        models/constrained.py:pack_constraints.  Constraints are defined
        on the unweighted snapshot; ``apply_lightcone=True`` scales the
        planes AFTER constraining (the pinned values then hold on the
        pre-weighting field).  One fused program: sample -> measure ->
        M x M solve -> spectral correction -> inverse transform.
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("generate_constrained_field",
                                    allow_mesh=True)
        pos, scales, values = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(
            pos, scales, float(smoothing_length)
        )
        if self.mesh is not None:
            return self._constrained_mesh(
                seed, gram, pos, scales, values, smoothing_length,
                apply_lightcone, mean_only=False,
            )
        return _con.constrained_render(
            _gen_as_key(seed), self.state.sigmas,
            self._weights(apply_lightcone), gram, pos, scales, values,
            smoothing_length, self.scene.shape, self.scene.grid_spacing,
            nested=self._nested,
        )

    def constrained_mean_field(self, constraints, smoothing_length=0.0,
                               apply_lightcone=False):
        """The conditional MEAN field given the constraints (no seed).

        The ensemble average of :meth:`generate_constrained_field` over
        seeds; satisfies every constraint exactly itself.
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("constrained_mean_field",
                                    allow_mesh=True)
        pos, scales, values = self._packed_constraints(constraints)
        gram = self._constraint_gram_cached(
            pos, scales, float(smoothing_length)
        )
        if self.mesh is not None:
            return self._constrained_mesh(
                0, gram, pos, scales, values, smoothing_length,
                apply_lightcone, mean_only=True,
            )
        return _con.constrained_mean(
            self.state.sigmas, self._weights(apply_lightcone), gram, pos,
            scales, values, smoothing_length, self.scene.shape,
            self.scene.grid_spacing,
        )

    def _constrained_mesh(self, seed, gram, pos, scales, values,
                          smoothing_length, apply_lightcone, mean_only):
        """Dispatch the compiled mesh-native constrained program."""
        from randomfield_tpu.models import constrained as _con

        fn = _con.make_sharded_constrained(
            self.mesh, self.scene.shape, self.scene.grid_spacing,
            int(pos.shape[0]), from_seed=self._multiprocess,
            log_values=self._table_host[2], dtype_name=str(self._dtype),
            mean_only=bool(mean_only),
        )
        lk, val = self._table_args()
        if self._multiprocess:
            pos = np.asarray(pos, np.float32)
            scales = np.asarray(scales, np.float32)
            values = np.asarray(values, np.float32)
        return fn(
            self._seed_u32(seed) if self._multiprocess else _gen_as_key(seed),
            lk, val, self._mesh_sigmas(), gram, pos, scales, values,
            self._weights(apply_lightcone),
            self._smoothing(smoothing_length),
        )

    def _constraint_gram_cached(self, pos, scales, smoothing_length):
        """Gram matrices are seed-independent: cache per constraint set."""
        from randomfield_tpu.models import constrained as _con

        key = (
            np.asarray(pos, np.float64).tobytes(),
            np.asarray(scales, np.float64).tobytes(),
            float(smoothing_length),
        )
        cache = getattr(self, "_gram_cache", None)
        if cache is None:
            cache = self._gram_cache = {}
        if key not in cache:
            if self.mesh is not None:
                fn = _con.make_sharded_constraint_gram(
                    self.mesh, self.scene.shape, self.scene.grid_spacing,
                    int(pos.shape[0]), log_values=self._table_host[2],
                    dtype_name=str(self._dtype),
                )
                lk, val = self._table_args()
                if self._multiprocess:
                    pos = np.asarray(pos, np.float32)
                    scales = np.asarray(scales, np.float32)
                cache[key] = fn(
                    lk, val, self._mesh_sigmas(), pos, scales,
                    self._smoothing(smoothing_length),
                )
            else:
                cache[key] = _con.constraint_gram(
                    self.state.sigmas, pos, scales, smoothing_length,
                    self.scene.shape, self.scene.grid_spacing,
                )
        return cache[key]

    def measure_constraints(self, delta, constraints):
        """Evaluate constraint functionals on a rendered field (host f64).

        Validation path independent of the constrained render's internal
        measurement (forward transform + packed-mode sum).
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("measure_constraints", allow_mesh=True)
        pos, scales, _ = self._packed_constraints(constraints)
        if self.mesh is not None:
            from randomfield_tpu.parallel.multihost import replicated_to_host

            fn = _con.make_sharded_measure(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                int(pos.shape[0]), dtype_name=str(self._dtype),
            )
            if self._multiprocess:
                pos = np.asarray(pos, np.float32)
                scales = np.asarray(scales, np.float32)
            out = fn(delta, pos, scales)
            return np.asarray(replicated_to_host(out), np.float64)
        out = _con.measure_constraints(
            jnp.asarray(delta, self._dtype), pos, scales,
            self.scene.shape, self.scene.grid_spacing,
        )
        return np.asarray(out, np.float64)

    def _noise_args(self, noise_power):
        """(tabulated, noise_a, noise_b) program inputs for mesh programs.

        Scalar white noise is pre-normalized to P_n/V on the host so the
        traced program never recompiles on a value change; tables pass
        their (log10 k, P_n) arrays like the signal spectrum.
        """
        if np.isscalar(noise_power) or getattr(noise_power, "ndim", 1) == 0:
            nx, ny, nz = self.scene.shape
            volume = nx * ny * nz * float(self.scene.grid_spacing) ** 3
            nvar = float(noise_power) / volume
            dt = np.dtype(str(self._dtype))
            return False, np.asarray(nvar, dt), np.zeros((), dt)
        table = _power.validate_power(noise_power)
        dt = np.dtype(str(self._dtype))
        return (
            True,
            np.log10(table.k).astype(dt),
            np.asarray(table.Pk, dt),
        )

    def wiener_filter(self, data, noise_power):
        """Minimum-variance reconstruction of a noisy observation of one
        realization: per-mode filter sigma^2 / (sigma^2 + P_n/V).

        ``noise_power``: physical noise power ((Mpc/h)^3) — scalar white
        noise (per-voxel std s <=> s^2 spacing^3) or a (k, P_n) table.
        On mesh scenes the whole reconstruction (forward transform,
        filter, inverse) is distributed; ``data`` may be a sharded
        global array (e.g. a mesh render) or host numpy.
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("wiener_filter", allow_mesh=True)
        if self.mesh is not None:
            tabulated, na, nb = self._noise_args(noise_power)
            fn = _con.make_sharded_wiener(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                noise_tabulated=tabulated, log_values=self._table_host[2],
                dtype_name=str(self._dtype),
            )
            lk, val = self._table_args()
            return fn(data, lk, val, self._mesh_sigmas(), na, nb)
        return _con.wiener_filter(
            data, self.state.sigmas, noise_power, self.scene.shape,
            self.scene.grid_spacing,
        )

    def generate_posterior_field(self, seed, data, noise_power):
        """One exact sample of P(field | data) for full-grid noisy data.

        ``delta_r + WF(data - delta_r - n_r)`` — the mean over seeds is
        :meth:`wiener_filter`'s reconstruction and the scatter is the
        exact posterior covariance (models/constrained.py).  Mesh
        scenes run the fully distributed program; identical Threefry
        draws make the sharded sample equal the single-device one.
        """
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("generate_posterior_field",
                                    allow_mesh=True)
        if self.mesh is not None:
            tabulated, na, nb = self._noise_args(noise_power)
            fn = _con.make_sharded_posterior(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                from_seed=self._multiprocess, noise_tabulated=tabulated,
                log_values=self._table_host[2],
                dtype_name=str(self._dtype),
            )
            lk, val = self._table_args()
            return fn(
                self._seed_u32(seed) if self._multiprocess else _gen_as_key(seed),
                data, lk, val, self._mesh_sigmas(), na, nb,
            )
        return _con.posterior_render(
            _gen_as_key(seed), data, self.state.sigmas, noise_power,
            self.scene.shape, self.scene.grid_spacing,
        )

    def predicted_posterior_mse(self, noise_power):
        """Exact expected mean-square error of :meth:`wiener_filter`."""
        from randomfield_tpu.models import constrained as _con

        self._require_constrainable("predicted_posterior_mse",
                                    allow_mesh=True)
        if self.mesh is not None:
            from randomfield_tpu.parallel.multihost import replicated_to_host

            tabulated, na, nb = self._noise_args(noise_power)
            fn = _con.make_sharded_posterior_mse(
                self.mesh, self.scene.shape, self.scene.grid_spacing,
                noise_tabulated=tabulated, log_values=self._table_host[2],
                dtype_name=str(self._dtype),
            )
            lk, val = self._table_args()
            return float(replicated_to_host(
                fn(lk, val, self._mesh_sigmas(), na, nb)
            ))
        return _con.predicted_posterior_mse(
            self.state.sigmas, noise_power, self.scene.shape,
            self.scene.grid_spacing,
        )

