"""Endpoint health: the serve-time half of the verification environment.

The paper's premise is that an offload destination can silently be wrong
or slow — offline, the verification environment catches that before
selection; online, the same distrust has to run continuously.  Each live
:class:`~repro_torch.serve.router.Endpoint` carries one :class:`EndpointHealth`:
a per-endpoint :class:`~repro_torch.runtime.fault_tolerance.StragglerWatchdog`
EWMA over observed request latencies plus explicit error reports, driving
the state machine

    healthy -> degraded -> quarantined -> probing -> (recovered) healthy

  * **healthy -> degraded** — the latency EWMA drifts past
    ``degrade_factor`` x the endpoint's baseline (or the watchdog flags a
    z-score outlier).  A degraded endpoint is *not* skipped: the Router
    applies ``degraded_penalty`` to its score so traffic shifts away
    gradually — graceful degradation, never a cliff.
  * **-> quarantined** — ``error_threshold`` consecutive error reports
    open the circuit breaker: the Router dispatches nothing to a
    quarantined endpoint (refusal reason "endpoint quarantined" when no
    alternative exists).
  * **quarantined -> probing** — after an exponential backoff
    (``backoff_ticks`` x ``backoff_mult`` per consecutive re-quarantine,
    capped at ``max_backoff_ticks``) the circuit goes half-open: at most
    ``probe_quota`` in-flight probe requests are admitted.
  * **probing -> healthy** — ``probe_successes`` successful probes close
    the circuit (a *recovered* transition: backoff resets, the watchdog
    window restarts fresh).  A failed probe re-quarantines with the
    escalated backoff.

Everything here is pure Python arithmetic on a virtual tick clock —
deterministic under test, zero traces or launches on the routing path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.obs import get_tracer
from repro_torch.runtime.fault_tolerance import StragglerWatchdog

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBING = "probing"

HEALTH_STATES = (HEALTHY, DEGRADED, QUARANTINED, PROBING)


@dataclass(frozen=True)
class HealthConfig:
    """Knobs of the per-endpoint state machine (shared by a Router)."""
    ewma_alpha: float = 0.3         # latency EWMA smoothing
    window: int = 16                # watchdog sample window
    threshold: float = 3.0          # watchdog z-score flag threshold
    baseline_s: Optional[float] = None  # expected latency; 1st obs if None
    degrade_factor: float = 2.0     # ewma > factor x baseline -> degraded
    recover_factor: float = 1.2     # ewma <= factor x baseline -> healthy
    degraded_penalty: float = 1.5   # score multiplier while degraded
    error_threshold: int = 2        # consecutive errors -> quarantine
    backoff_ticks: int = 8          # first quarantine duration (ticks)
    backoff_mult: float = 2.0       # escalation per failed probe cycle
    max_backoff_ticks: int = 512
    probe_quota: int = 1            # concurrent half-open probes
    probe_successes: int = 1        # successes needed to close the circuit

    def __post_init__(self):
        if self.degraded_penalty < 1.0:
            raise ValueError(f"degraded_penalty must be >= 1.0: "
                             f"{self.degraded_penalty}")
        if self.error_threshold < 1:
            raise ValueError(f"error_threshold must be >= 1: "
                             f"{self.error_threshold}")
        if self.backoff_ticks < 1:
            raise ValueError(f"backoff_ticks must be >= 1: "
                             f"{self.backoff_ticks}")


class EndpointHealth:
    """Health state of one live endpoint (see module docstring).

    The Router feeds it from the admission ledger: ``observe_latency`` /
    ``observe_success`` on each completed request, ``observe_error`` on
    each failure report; a controller advances the circuit timers with
    ``on_tick``.  ``transitions`` records every state change (tick, from,
    to, reason, and the triggering ``observed`` measurement) so chaos
    scenarios are assertable and post-mortems can explain each firing.
    """

    def __init__(self, name: str = "", cfg: Optional[HealthConfig] = None):
        self.name = name
        self.cfg = cfg if cfg is not None else HealthConfig()
        self.state = HEALTHY
        self.baseline_s = self.cfg.baseline_s
        self.watchdog = StragglerWatchdog(window=self.cfg.window,
                                          threshold=self.cfg.threshold,
                                          ewma_alpha=self.cfg.ewma_alpha)
        self.consecutive_errors = 0
        self.errors = 0
        self.recoveries = 0
        self.transitions: List[Dict] = []
        self._tick = 0
        self._backoff = float(self.cfg.backoff_ticks)
        self._reopen_at: Optional[int] = None
        self._probes_in_flight = 0
        self._probe_successes = 0

    # ----------------------------------------------------------- plumbing
    def _to(self, state: str, reason: str,
            observed: Optional[Dict] = None):
        """Record a state change.  ``observed`` carries the triggering
        measurement (latency/ewma values, error counts, backoff length) so
        a post-mortem can show *why* the transition fired, not just
        from->to."""
        if state == self.state:
            return
        entry = {"tick": self._tick, "from": self.state, "to": state,
                 "reason": reason, "observed": dict(observed or {})}
        self.transitions.append(entry)
        get_tracer().event("transition", cat="health",
                           track=f"endpoint:{self.name}", **entry,
                           endpoint=self.name)
        self.state = state

    @property
    def available(self) -> bool:
        """May the Router consider this endpoint at all right now?"""
        if self.state == QUARANTINED:
            return False
        if self.state == PROBING:
            return self.probe_free
        return True

    @property
    def probe_free(self) -> bool:
        return self._probes_in_flight < self.cfg.probe_quota

    @property
    def penalty(self) -> float:
        """Score multiplier the Router applies (1.0 unless degraded)."""
        return self.cfg.degraded_penalty if self.state == DEGRADED else 1.0

    # -------------------------------------------------------------- clock
    def on_tick(self, tick: int):
        """Advance the circuit timer: a quarantined endpoint whose backoff
        elapsed goes half-open (probing)."""
        self._tick = int(tick)
        if self.state == QUARANTINED and self._reopen_at is not None \
                and self._tick >= self._reopen_at:
            self._probes_in_flight = 0
            self._probe_successes = 0
            self._to(PROBING, f"backoff elapsed after "
                              f"{int(self._backoff)} ticks: half-open",
                     observed={"backoff_ticks": int(self._backoff)})

    # ------------------------------------------------------- observations
    def on_probe_dispatch(self):
        """A half-open probe request left for this endpoint."""
        self._probes_in_flight += 1

    def observe_latency(self, latency_s: float):
        """One completed request's observed service latency."""
        flagged = self.watchdog.record(self._tick, float(latency_s))
        if self.baseline_s is None:
            self.baseline_s = float(latency_s)
        else:
            # the best latency ever seen is the endpoint's honest baseline:
            # a fault window cannot ratchet it up
            self.baseline_s = min(self.baseline_s, float(latency_s))
        ewma = self.watchdog.ewma
        if ewma is None or self.baseline_s <= 0.0:
            return
        observed = {"latency_s": float(latency_s), "ewma_s": float(ewma),
                    "baseline_s": float(self.baseline_s)}
        if self.state == HEALTHY and \
                (flagged or ewma > self.cfg.degrade_factor * self.baseline_s):
            self._to(DEGRADED,
                     f"latency ewma {ewma:.4g}s > "
                     f"{self.cfg.degrade_factor:g}x baseline "
                     f"{self.baseline_s:.4g}s", observed=observed)
        elif self.state == DEGRADED and \
                ewma <= self.cfg.recover_factor * self.baseline_s:
            self._to(HEALTHY,
                     f"latency ewma {ewma:.4g}s back within "
                     f"{self.cfg.recover_factor:g}x baseline",
                     observed=observed)

    def observe_success(self, probe: bool = False):
        """A request completed correctly on this endpoint."""
        self.consecutive_errors = 0
        if probe:
            self._probes_in_flight = max(self._probes_in_flight - 1, 0)
        if self.state == PROBING:
            self._probe_successes += 1
            if self._probe_successes >= self.cfg.probe_successes:
                self.recoveries += 1
                self._backoff = float(self.cfg.backoff_ticks)
                self._reopen_at = None
                probes = self._probe_successes
                self.watchdog.reset()         # fresh window post-recovery
                self._to(HEALTHY, "recovered: half-open probe succeeded",
                         observed={"probe_successes": probes})

    def observe_error(self, reason: str = "", probe: bool = False):
        """An explicit failure report (died, wrong result, timeout...)."""
        self.errors += 1
        self.consecutive_errors += 1
        if probe:
            self._probes_in_flight = max(self._probes_in_flight - 1, 0)
        observed = {"consecutive_errors": self.consecutive_errors,
                    "errors": self.errors,
                    "error": reason or "error"}
        if self.state == PROBING:
            self._quarantine(f"probe failed: {reason or 'error'}",
                             escalate=True, observed=observed)
        elif self.state != QUARANTINED and \
                self.consecutive_errors >= self.cfg.error_threshold:
            self._quarantine(reason or
                             f"{self.consecutive_errors} consecutive "
                             f"errors", escalate=False, observed=observed)

    # ------------------------------------------------------------ circuit
    def _quarantine(self, reason: str, escalate: bool,
                    observed: Optional[Dict] = None):
        if escalate:
            self._backoff = min(self._backoff * self.cfg.backoff_mult,
                                float(self.cfg.max_backoff_ticks))
        self._reopen_at = self._tick + int(self._backoff)
        obs = dict(observed or {})
        obs["backoff_ticks"] = int(self._backoff)
        self._to(QUARANTINED, reason, observed=obs)

    def quarantine(self, reason: str = "operator request"):
        """Open the circuit explicitly (operator / controller action)."""
        if self.state != QUARANTINED:
            self._quarantine(reason, escalate=False)
