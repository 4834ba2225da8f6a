"""Test harness config: run JAX on 8 virtual CPU devices.

Multi-device sharding is validated on a virtual CPU mesh (SURVEY.md
section 4, "Distributed tests"); the GPU paths run through
``python chip_smoke.py [--chips 4]`` on the card.

jax may already be imported by the time this runs, so the platform and
device count go through jax.config.update (env vars would be too late)
before any backend is initialized.
"""

import faulthandler
import os
import sys

import jax

_PLATFORM = os.environ.get("RF_TEST_PLATFORM", "cpu")
jax.config.update("jax_platforms", _PLATFORM)
if _PLATFORM == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Hang watchdog: rather than let a deadlocked test (a collective whose
# peer never arrives, a futex wait) eat the whole run silently, arm a
# per-test deadline that dumps every thread's stack and hard-exits.  900 s is ~6x
# the slowest legitimate test (the 2-process Gloo multihost run).
_TEST_DEADLINE_S = float(os.environ.get("RF_TEST_DEADLINE", 900))


import pytest


# Smoke tier (VERDICT r4 item 7): a <3-minute cross-section — one or
# two gates per subsystem — for inner-loop iteration.  `pytest -m smoke`
# runs just these; the default tier (-m 'not slow') stays the
# correctness set.  Node IDs are listed here (not decorated in place) so
# the smoke set is reviewable as one unit.
_SMOKE = {
    # engine: determinism, moments, realized P(k) vs input
    "test_generator.py::test_fixed_seed_deterministic",
    "test_generator.py::test_mean_and_variance_match_prediction",
    "test_generator.py::test_realized_power_matches_input",
    # float64 oracle parity (the stand-in reference)
    "test_oracle_parity.py::test_render_matches_oracle",
    # sampling: Hermitian structure of the canonical stream
    "test_sample.py::test_unit_noise_is_hermitian_and_real_field",
    # transforms: local + staged pipeline equivalence
    "test_transform.py::test_roundtrip_identity",
    "test_staged.py::test_fused_and_staged_draw_one_canonical_stream",
    # spectral tools
    "test_power.py::test_tabulate_sigmas_values",
    "test_power.py::test_sigma_r_known_integral",
    # cosmology
    "test_cosmology.py::test_growth_normalization_and_monotonicity",
    "test_cosmology.py::test_get_redshifts_planes",
    # slab mesh: render parity; native mesh transforms vs numpy float64
    "test_parallel.py::test_sharded_render_equals_single_device",
    "test_gpu_route.py::test_mesh_native_route_matches_numpy",
    # pencil mesh: state-0 distributed inverse + render parity
    "test_pencil.py::test_pencil_render_equals_single_device",
    # pipeline choice from device memory
    "test_gpu_route.py::test_pick_pipeline_from_memory_stats",
    # estimator: exact single-mode P(k)
    "test_stats.py::test_calculate_power_single_cosine",
    # CLI end to end
    "test_io_cli.py::test_cli_end_to_end",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.nodeid.split("/")[-1].split("[")[0]
        if base in _SMOKE:
            item.add_marker(pytest.mark.smoke)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    # wrap the WHOLE protocol (setup + call + teardown, including fixture
    # finalization — session-scoped finalizers run inside the last item's
    # teardown) so a hang anywhere inside it trips the deadline; plain
    # setup/teardown hooks run before the built-in runner finalizes
    # fixtures and would leave teardown hangs uncovered (ADVICE r3)
    if _TEST_DEADLINE_S > 0:
        faulthandler.dump_traceback_later(_TEST_DEADLINE_S, exit=True)
    yield
    if _TEST_DEADLINE_S > 0:
        faulthandler.cancel_dump_traceback_later()
