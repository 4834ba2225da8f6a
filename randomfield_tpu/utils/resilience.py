"""Failure detection and elastic recovery for long-running workflows.

The reference has no failure handling at all (SURVEY.md section 5 —
single process, seconds-long runs).  At production ensemble scale
(BASELINE.json config 4: 1024^3-class covariance studies over many
seeds, possibly multi-host) runs last long enough to meet preemptions,
lost devices and transient collective failures, so recovery is
a first-class subsystem here.  The design exploits the framework's core
invariant: FIELDS REGENERATE FROM SEEDS.  Durable state is a tiny
binned-spectrum checkpoint (validate/ensemble.py), and recovery is

    classify the failure  ->  bounded retry with a REBUILT scene/state
                          ->  resume from the checkpoint.

Classification is conservative: programming and capacity errors
(INVALID_ARGUMENT, RESOURCE_EXHAUSTED, UNIMPLEMENTED, plain Python
errors) re-raise immediately — retrying them would loop on a
deterministic failure.  Only infrastructure-flavored errors (gRPC-style
UNAVAILABLE / DEADLINE_EXCEEDED / ABORTED / CANCELLED codes in the
runtime error text, connection / preemption markers) count as
transient.

Elasticity falls out of the checkpoint format: the fingerprint
(validate/ensemble.py:_scene_fingerprint) records the PHYSICS of a row
(grid, spacing, power hash, smoothing, binning) and deliberately NOT
the topology, so a resume may run on a different mesh shape, device
count or host count — remaining seeds are simply recomputed under the
new layout, and identical Threefry streams make the rows bit-compatible
regardless of sharding.  Multi-host recovery is relaunch-based (the
JAX runtime cannot shrink a live collective): the job dies, the
scheduler restarts it with whatever slice is healthy, and at most
``checkpoint_every`` seeds are repaid.
"""

from __future__ import annotations

import time

__all__ = [
    "classify_failure",
    "retry_transient",
    "resilient_sample_power_ensemble",
]

# gRPC-ish status codes + infrastructure markers that indicate the WORLD
# failed (retryable), not the program.  Checked case-sensitively for
# codes, case-insensitively for prose markers.
TRANSIENT_CODES = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "CANCELLED",
)
TRANSIENT_MARKERS = (
    "connection reset",
    "connection refused",
    "failed to connect",
    "socket closed",
    "broken pipe",
    "preempt",
    "device halted",
    "network error",
    "heartbeat",
)
# Deterministic failures: retrying reproduces them.
FATAL_CODES = (
    "INVALID_ARGUMENT",
    "RESOURCE_EXHAUSTED",
    "UNIMPLEMENTED",
    "FAILED_PRECONDITION",
    "OUT_OF_RANGE",
)


def classify_failure(exc):
    """'transient' (retry with a rebuilt scene) or 'fatal' (re-raise).

    Plain Python errors (ValueError, TypeError, KeyError, ...) are the
    caller's bug — always fatal.  Runtime errors are classified by the
    status code / marker text above; unknown runtime errors default to
    FATAL so a new deterministic failure mode can never spin the retry
    loop.
    """
    if isinstance(exc, (ValueError, TypeError, KeyError, AttributeError,
                        IndexError, ZeroDivisionError)):
        return "fatal"
    text = str(exc)
    for code in FATAL_CODES:
        if code in text:
            return "fatal"
    for code in TRANSIENT_CODES:
        if code in text:
            return "transient"
    low = text.lower()
    for marker in TRANSIENT_MARKERS:
        if marker in low:
            return "transient"
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return "transient"
    return "fatal"


def retry_transient(fn, max_retries=3, base_delay_s=1.0, reinit=None,
                    classify=classify_failure, on_retry=None):
    """Run ``fn()`` with bounded retries on transient failures.

    Between attempts: JAX compilation caches are cleared (stale
    executables can pin buffers on a device that just came back),
    ``reinit()`` runs if given (rebuild generators / re-establish the
    backend), and the delay backs off exponentially from
    ``base_delay_s``.  Fatal failures and retry exhaustion re-raise the
    original exception.  ``on_retry(attempt, exc)`` observes each retry
    (logging / metrics hook).  Returns ``fn()``'s value.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classified below
            if classify(exc) != "transient" or attempt >= int(max_retries):
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            try:
                import jax

                jax.clear_caches()
            except Exception:  # noqa: BLE001 — cache clear is best-effort
                pass
            if reinit is not None:
                reinit()
            if base_delay_s > 0:
                time.sleep(float(base_delay_s) * 2.0 ** (attempt - 1))


def resilient_sample_power_ensemble(generator_factory, seeds,
                                    smoothing_length=0.0, nbins=32,
                                    checkpoint_path=None,
                                    checkpoint_every=16, max_restarts=3,
                                    base_delay_s=1.0, on_retry=None):
    """Elastic, fault-tolerant P(k) ensemble.

    ``generator_factory`` is a zero-argument callable returning a fresh
    ``Generator`` — called once per (re)start so every retry gets a
    clean scene/state (new device buffers, new compiled programs; a
    long-lived Generator may hold executables bound to a failed
    device).  Passing a Generator instance directly also works but
    forgoes the rebuild.  ``checkpoint_path`` is required: it is what
    bounds the recomputation per failure to ``checkpoint_every`` seeds
    (validate/ensemble.py documents the format; its fingerprint is
    topology-free, so restarts may use a different mesh / device count
    / host count).  Transient failures restart up to ``max_restarts``
    times; fatal ones re-raise immediately.  Returns
    ``(k_mean, p_hat, n_modes)`` exactly like
    :func:`randomfield_tpu.validate.ensemble.sample_power_ensemble`.
    """
    from randomfield_tpu.validate.ensemble import sample_power_ensemble

    if checkpoint_path is None:
        raise ValueError(
            "resilient_sample_power_ensemble requires checkpoint_path: "
            "without it a restart would recompute every seed, which is "
            "plain retry_transient(sample_power_ensemble), not recovery."
        )
    if callable(generator_factory):
        factory = generator_factory
    else:
        g = generator_factory
        factory = lambda: g  # noqa: E731 — documented degraded mode

    def run():
        return sample_power_ensemble(
            factory(), seeds, smoothing_length=smoothing_length,
            nbins=nbins, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
        )

    return retry_transient(
        run, max_retries=max_restarts, base_delay_s=base_delay_s,
        on_retry=on_retry,
    )
