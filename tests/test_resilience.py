"""Failure detection and elastic recovery (utils/resilience.py).

Fault-injection tests: transient infrastructure failures are retried
with a rebuilt scene and resume from the ensemble checkpoint; fatal
(deterministic) failures re-raise immediately; the checkpoint's
topology-free fingerprint makes restarts elastic across mesh shapes.
"""

import numpy as np
import pytest

import randomfield_tpu as rf
from randomfield_tpu.utils import resilience as rz
from randomfield_tpu.validate.ensemble import sample_power_ensemble


class _FakeRuntimeError(RuntimeError):
    pass


def test_classify_failure():
    t = rz.classify_failure
    assert t(_FakeRuntimeError("UNAVAILABLE: socket closed")) == "transient"
    assert t(_FakeRuntimeError("DEADLINE_EXCEEDED: heartbeat")) == "transient"
    assert t(ConnectionResetError("peer reset")) == "transient"
    assert t(_FakeRuntimeError("slice 0 preempted")) == "transient"
    # deterministic failures must never be retried
    assert t(ValueError("bad power table")) == "fatal"
    assert t(_FakeRuntimeError("RESOURCE_EXHAUSTED: out of memory "
                               "allocating 8.0G")) == "fatal"
    assert t(_FakeRuntimeError("INVALID_ARGUMENT: shapes")) == "fatal"
    assert t(_FakeRuntimeError("UNIMPLEMENTED: complex transfer")) == "fatal"
    # unknown runtime errors default to fatal (no retry spin)
    assert t(_FakeRuntimeError("weird new failure")) == "fatal"


def test_retry_transient_recovers_and_reinits():
    calls = {"n": 0, "reinit": 0, "retries": []}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise _FakeRuntimeError("UNAVAILABLE: device lost")
        return "ok"

    out = rz.retry_transient(
        fn, max_retries=3, base_delay_s=0.0,
        reinit=lambda: calls.__setitem__("reinit", calls["reinit"] + 1),
        on_retry=lambda a, e: calls["retries"].append(a),
    )
    assert out == "ok"
    assert calls == {"n": 3, "reinit": 2, "retries": [1, 2]}


def test_retry_transient_fatal_and_exhaustion():
    def fatal():
        raise ValueError("bug")

    with pytest.raises(ValueError):
        rz.retry_transient(fatal, max_retries=5, base_delay_s=0.0)

    n = {"v": 0}

    def always_down():
        n["v"] += 1
        raise _FakeRuntimeError("ABORTED: collective")

    with pytest.raises(_FakeRuntimeError):
        rz.retry_transient(always_down, max_retries=2, base_delay_s=0.0)
    assert n["v"] == 3  # initial + 2 retries


def test_resilient_ensemble_resumes_from_checkpoint(tmp_path,
                                                    monkeypatch):
    """A transient failure mid-ensemble loses at most checkpoint_every
    seeds: the restart rebuilds the Generator, skips checkpointed rows
    and produces exactly the no-failure result."""
    n, sp = 16, 8.0
    seeds = list(range(10))
    ck = tmp_path / "ens.npz"

    g_ref = rf.Generator(n, n, n, grid_spacing=sp)
    k_ref, p_ref, m_ref = sample_power_ensemble(
        g_ref, seeds, nbins=8,
        checkpoint_path=tmp_path / "ref.npz", checkpoint_every=4,
    )

    built = {"n": 0}
    real_batch = rf.Generator.sample_power_batch
    state = {"calls": 0}

    def flaky_batch(self, *a, **kw):
        state["calls"] += 1
        if state["calls"] == 2:  # after one checkpointed chunk
            raise _FakeRuntimeError("UNAVAILABLE: device heartbeat lost")
        return real_batch(self, *a, **kw)

    monkeypatch.setattr(rf.Generator, "sample_power_batch", flaky_batch)

    def factory():
        built["n"] += 1
        return rf.Generator(n, n, n, grid_spacing=sp)

    retries = []
    k, p, m = rz.resilient_sample_power_ensemble(
        factory, seeds, nbins=8, checkpoint_path=ck,
        checkpoint_every=4, max_restarts=2, base_delay_s=0.0,
        on_retry=lambda a, e: retries.append(str(e)),
    )
    assert built["n"] == 2  # fresh scene per (re)start
    assert len(retries) == 1 and "UNAVAILABLE" in retries[0]
    np.testing.assert_allclose(k, k_ref)
    np.testing.assert_allclose(p, p_ref)
    np.testing.assert_array_equal(m, m_ref)
    # only the unfinished seeds were recomputed: 3 chunks before the
    # failure run + failure + 2 remaining chunks on the restart
    assert state["calls"] <= 5


def test_resilient_ensemble_fatal_propagates(tmp_path):
    def factory():
        return rf.Generator(16, 16, 16, grid_spacing=8.0)

    sample_power_ensemble(
        factory(), [0, 1], nbins=8,
        checkpoint_path=tmp_path / "a.npz", checkpoint_every=2,
    )
    g2 = rf.Generator(16, 16, 16, grid_spacing=4.0)
    with pytest.raises(ValueError):
        # mismatched checkpoint scene => fatal ValueError, no retries
        rz.resilient_sample_power_ensemble(
            lambda: g2, [0, 1], nbins=8,
            checkpoint_path=tmp_path / "a.npz", base_delay_s=0.0,
        )

    with pytest.raises(ValueError):
        rz.resilient_sample_power_ensemble(
            factory, [0, 1], nbins=8, checkpoint_path=None,
        )


def test_elastic_resume_across_mesh_shapes(tmp_path):
    """The checkpoint fingerprint is topology-free: start unsharded,
    finish on a ('data','space') mesh — rows are identical because the
    Threefry streams are sharding-invariant."""
    from randomfield_tpu.parallel.mesh import make_mesh

    n, sp = 16, 8.0
    seeds = list(range(6))
    ck = tmp_path / "elastic.npz"
    g1 = rf.Generator(n, n, n, grid_spacing=sp)
    sample_power_ensemble(
        g1, seeds[:3], nbins=8, checkpoint_path=ck, checkpoint_every=2
    )

    k, p, m = rz.resilient_sample_power_ensemble(
        lambda: rf.Generator(n, n, n, grid_spacing=sp,
                             mesh=make_mesh(data=2, space=4)),
        seeds, nbins=8, checkpoint_path=ck, checkpoint_every=2,
        base_delay_s=0.0,
    )
    k_ref, p_ref, m_ref = sample_power_ensemble(
        rf.Generator(n, n, n, grid_spacing=sp), seeds, nbins=8,
        checkpoint_path=tmp_path / "ref2.npz",
    )
    np.testing.assert_allclose(k, k_ref, rtol=1e-5)
    np.testing.assert_allclose(p, p_ref, rtol=2e-4)
    np.testing.assert_array_equal(m, m_ref)
