"""randomfield_tpu — a JAX Gaussian random field engine.

A from-scratch JAX/XLA framework with the capabilities of the
reference package ``dkirkby/randomfield`` (see SURVEY.md): generate 3-D
Gaussian random density fields delta(x) with a prescribed power spectrum
P(k), with cosmological lightcone evolution along the line of sight.

Architecture (accelerator-first, not a port):

- the reference's pyfftw in-place c2r plans  ->  jitted ``jnp.fft.irfftn``
  on device, plus a distributed slab-decomposed irfftn built on
  ``shard_map`` + ``all_to_all`` for grids larger than one device
  (``randomfield_tpu.parallel``);
- the reference's numpy ``RandomState`` half-spectrum sampling  ->
  counter-based ``jax.random`` producing
  Hermitian-symmetric packed spectra (``randomfield_tpu.ops.sample``);
- the reference's scipy/astropy powertools + cosmotools  ->  pure
  jnp/numpy implementations with no scipy/astropy dependency
  (``randomfield_tpu.ops.power``, ``randomfield_tpu.models.cosmology``);
- the reference's ``Generator`` scene/state API is kept: precompute
  sigma(k), growth weights and FFT setup once, then render many seeds as
  one fused jitted program (``randomfield_tpu.engine``).

Reference parity citations use ``randomfield/<module>.py:<symbol>``
granularity because the reference mount was empty at survey time
(SURVEY.md "Provenance").
"""

from randomfield_tpu.engine.generator import Generator
from randomfield_tpu.models.cosmology import (
    Cosmology,
    Planck13,
    Planck15,
    Planck18,
    create_cosmology,
)
from randomfield_tpu.models.powerspec import (
    bbks_power,
    eisenstein_hu_power,
    load_camb_power,
    power_at_redshift,
    power_law_power,
)
from randomfield_tpu.ops.power import load_default_power, validate_power

__version__ = "0.1.0"

__all__ = [
    "Generator",
    "Cosmology",
    "Planck13",
    "Planck15",
    "Planck18",
    "create_cosmology",
    "load_default_power",
    "validate_power",
    "eisenstein_hu_power",
    "bbks_power",
    "power_law_power",
    "load_camb_power",
    "power_at_redshift",
    "__version__",
]
