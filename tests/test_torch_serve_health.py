"""repro_torch.serve.health: the per-endpoint state machine, unit by unit;
the reference's tests/test_serve_health.py run on the port, then the health
transitions against the JAX package's.

Pins every edge of healthy -> degraded -> quarantined -> probing ->
(recovered) healthy on a hand-driven tick clock: latency-EWMA degradation
with hysteresis, the consecutive-error circuit breaker, exponential
half-open backoff with escalation on failed probes, the probe quota, and
the watchdog reset on recovery.  Everything here is pure arithmetic — no
tensor anywhere on the path.
"""
import importlib

import pytest

from repro_torch.serve.health import (DEGRADED, HEALTH_STATES, HEALTHY, PROBING,
                                      QUARANTINED, EndpointHealth, HealthConfig)


def make(**kw):
    defaults = dict(ewma_alpha=1.0, degrade_factor=2.0, recover_factor=1.2,
                    error_threshold=2, backoff_ticks=4, backoff_mult=2.0,
                    max_backoff_ticks=64, probe_quota=1, probe_successes=1)
    defaults.update(kw)
    return EndpointHealth("ep", HealthConfig(**defaults))


def test_states_and_config_validation():
    assert HEALTH_STATES == (HEALTHY, DEGRADED, QUARANTINED, PROBING)
    with pytest.raises(ValueError):
        HealthConfig(degraded_penalty=0.5)
    with pytest.raises(ValueError):
        HealthConfig(error_threshold=0)
    with pytest.raises(ValueError):
        HealthConfig(backoff_ticks=0)


def test_latency_degrade_and_recover_hysteresis():
    """EWMA above degrade_factor x baseline degrades; it must come back
    under the *tighter* recover_factor to re-enter healthy (hysteresis:
    no flapping at the boundary)."""
    h = make()                           # alpha=1.0: ewma == last sample
    h.observe_latency(1.0)               # seeds the baseline
    assert h.state == HEALTHY and h.baseline_s == pytest.approx(1.0)
    h.observe_latency(1.9)               # below 2x: still healthy
    assert h.state == HEALTHY
    h.observe_latency(3.0)               # 3x baseline: degraded
    assert h.state == DEGRADED
    assert h.penalty == pytest.approx(1.5)
    h.observe_latency(1.5)               # 1.5x > recover_factor: stays
    assert h.state == DEGRADED
    h.observe_latency(1.1)               # within 1.2x: recovered
    assert h.state == HEALTHY
    assert h.penalty == 1.0
    assert [t["to"] for t in h.transitions] == [DEGRADED, HEALTHY]


def test_baseline_is_best_ever_seen_never_ratcheted_up_by_a_fault():
    h = make()
    h.observe_latency(2.0)
    h.observe_latency(0.5)               # faster: the honest baseline
    assert h.baseline_s == pytest.approx(0.5)
    h.observe_latency(10.0)              # a fault window cannot raise it
    assert h.baseline_s == pytest.approx(0.5)
    assert h.state == DEGRADED


def test_consecutive_errors_open_the_circuit():
    h = make(error_threshold=2)
    h.observe_error("boom")
    assert h.state == HEALTHY            # one error is noise
    h.observe_success()                  # success resets the streak
    h.observe_error("boom")
    assert h.state == HEALTHY
    h.observe_error("boom")
    assert h.state == QUARANTINED
    assert not h.available               # the router must skip it
    assert h.errors == 3


def test_backoff_elapses_into_half_open_probing():
    h = make(error_threshold=1, backoff_ticks=4)
    h.on_tick(10)
    h.observe_error("died")
    assert h.state == QUARANTINED
    h.on_tick(13)                        # 3 < 4 ticks: still closed
    assert h.state == QUARANTINED and not h.available
    h.on_tick(14)                        # backoff elapsed: half-open
    assert h.state == PROBING
    assert h.available and h.probe_free


def test_probe_quota_limits_half_open_concurrency():
    h = make(error_threshold=1, backoff_ticks=1, probe_quota=1)
    h.observe_error("died")
    h.on_tick(5)
    assert h.state == PROBING and h.available
    h.on_probe_dispatch()
    assert not h.probe_free and not h.available   # quota exhausted
    h.observe_success(probe=True)                 # probe came back
    assert h.state == HEALTHY


def test_failed_probe_requarantines_with_escalated_backoff():
    h = make(error_threshold=1, backoff_ticks=4, backoff_mult=2.0,
             max_backoff_ticks=16)
    h.on_tick(0)
    h.observe_error("died")              # quarantine: backoff 4
    h.on_tick(4)
    assert h.state == PROBING
    h.on_probe_dispatch()
    h.observe_error("still dead", probe=True)
    assert h.state == QUARANTINED        # escalated: backoff now 8
    h.on_tick(11)
    assert h.state == QUARANTINED
    h.on_tick(12)
    assert h.state == PROBING
    h.on_probe_dispatch()
    h.observe_error("still dead", probe=True)
    h.on_tick(12 + 16)                   # 8 * 2 = 16 (capped there)
    assert h.state == PROBING
    # a further failure cannot push the backoff past max_backoff_ticks
    h.on_probe_dispatch()
    h.observe_error("still dead", probe=True)
    h.on_tick(28 + 16)
    assert h.state == PROBING


def test_probe_success_recovers_and_resets_backoff_and_watchdog():
    h = make(error_threshold=1, backoff_ticks=4, probe_successes=1)
    for t in range(8):
        h.observe_latency(1.0)
    h.on_tick(0)
    h.observe_error("died")
    h.on_tick(4)
    h.on_probe_dispatch()
    h.observe_success(probe=True)
    assert h.state == HEALTHY and h.recoveries == 1
    assert len(h.watchdog.times) == 0    # fresh window post-recovery
    assert h.watchdog.ewma is None
    # backoff is back to its base: the next quarantine reopens in 4 ticks
    h.observe_error("died again")
    h.on_tick(8)
    assert h.state == PROBING
    last = h.transitions[-1]
    assert last["from"] == QUARANTINED and last["to"] == PROBING


def test_multi_probe_successes_required_to_close():
    h = make(error_threshold=1, backoff_ticks=1, probe_quota=2,
             probe_successes=2)
    h.observe_error("died")
    h.on_tick(2)
    assert h.state == PROBING
    h.on_probe_dispatch()
    h.observe_success(probe=True)
    assert h.state == PROBING            # one success is not enough
    h.on_probe_dispatch()
    h.observe_success(probe=True)
    assert h.state == HEALTHY


def test_explicit_quarantine_and_transition_log():
    h = make()
    h.on_tick(7)
    h.quarantine("operator request")
    assert h.state == QUARANTINED
    tr = h.transitions[-1]
    assert tr == {"tick": 7, "from": HEALTHY, "to": QUARANTINED,
                  "reason": "operator request",
                  "observed": {"backoff_ticks": 4}}
    h.quarantine("again")                # idempotent: no new transition
    assert len(h.transitions) == 1


# ------------------------------------------------ parity with the JAX package
def _drive(pkg):
    """One observation script through every edge of the machine: latency
    degradation and recovery, a streak of errors, a failed probe with the
    escalated backoff, a successful probe, then an operator quarantine."""
    health = importlib.import_module(f"{pkg}.serve.health")
    h = health.EndpointHealth("ep", health.HealthConfig(
        ewma_alpha=0.5, degrade_factor=2.0, recover_factor=1.2,
        error_threshold=2, backoff_ticks=3, backoff_mult=2.0,
        max_backoff_ticks=16, probe_quota=1, probe_successes=1))
    lat = [1.0, 1.1, 0.9, 3.5, 4.0, 1.0, 1.0, 1.0, 1.0, 0.95]
    for tick, x in enumerate(lat):
        h.on_tick(tick)
        h.observe_latency(x)
        h.observe_success()
    for tick in range(10, 40):
        h.on_tick(tick)
        if tick in (11, 12):
            h.observe_error("endpoint died")
        if h.state == PROBING and h.probe_free:
            h.on_probe_dispatch()
            if tick < 20:
                h.observe_error("still dead", probe=True)
            else:
                h.observe_latency(1.0)
                h.observe_success(probe=True)
    h.on_tick(41)
    h.quarantine("operator")
    return h


def test_transitions_equal_the_jax_packages():
    ref, ours = _drive("repro"), _drive("repro_torch")
    assert ours.transitions == ref.transitions
    assert [t["to"] for t in ours.transitions] == [
        DEGRADED, HEALTHY, QUARANTINED, PROBING, QUARANTINED, PROBING,
        HEALTHY, QUARANTINED]
    for attr in ("state", "errors", "recoveries", "baseline_s",
                 "consecutive_errors"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert ours.watchdog.ewma == ref.watchdog.ewma
    assert list(ours.watchdog.times) == list(ref.watchdog.times)
