"""Request lifecycle metrics: queue, TTFT/TPOT/tok-s, joules per request.

Counter semantics follow the usual serving definitions:

  * **TTFT** — submit-to-first-token: queueing + prefill.
  * **TPOT** — mean inter-token time after the first token.
  * **tok/s** — completed generated tokens over the engine's active span.
  * **joules/request** — every engine tick's energy
    (:meth:`repro_torch.power.EnergyModel.tick_joules`) is split evenly across
    the requests that were live during it, so a request that decoded in a
    full batch is charged a fraction of the tick while a lone straggler
    pays the whole machine — the per-request form of the planner's
    ``energy_for_record`` charge.

All timestamps are caller-supplied seconds on one monotonic timeline (the
engine feeds its own tick clock), so the counters are deterministic under
test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def percentile(values: List[float], p: float) -> Optional[float]:
    """Nearest-rank percentile (p in [0,100]); None on empty input.

    Uses the ceil-based nearest-rank definition ``k = ceil(p/100 * n)``:
    ``int(round(...))`` rounds half-to-even (banker's rounding), which
    picked the *lower* element on exact .5 ranks for half the input sizes
    — a nondeterministic-looking bias pinned away by
    tests/test_serve_metrics.py."""
    if not values:
        return None
    xs = sorted(values)
    if p <= 0:
        return xs[0]
    k = math.ceil(p / 100.0 * len(xs))
    return xs[min(max(k, 1), len(xs)) - 1]


@dataclass
class RequestMetrics:
    rid: str
    submit_s: float = 0.0
    admit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    n_tokens: int = 0
    energy_j: float = 0.0
    rejected: Optional[str] = None          # last rejection reason, if any
    arch: Optional[str] = None              # requested architecture
    endpoint: Optional[str] = None          # endpoint it dispatched to
    service_s: Optional[float] = None       # observed service latency

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.submit_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean inter-token time after the first token."""
        if self.finish_s is None or self.first_token_s is None \
                or self.n_tokens < 2:
            return None
        return (self.finish_s - self.first_token_s) / (self.n_tokens - 1)


@dataclass
class ServeMetrics:
    requests: Dict[str, RequestMetrics] = field(default_factory=dict)
    rejected: int = 0
    refusals: Dict[str, int] = field(default_factory=dict)
    ticks: int = 0
    total_energy_j: float = 0.0
    _span_start: Optional[float] = None
    _span_end: Optional[float] = None

    # --------------------------------------------------------- lifecycle
    def _get(self, rid: str) -> RequestMetrics:
        m = self.requests.get(rid)
        if m is None:
            m = self.requests[rid] = RequestMetrics(rid)
        return m

    def on_submit(self, rid: str, t: float, arch: Optional[str] = None):
        m = self._get(rid)
        m.submit_s = t
        if arch is not None:
            m.arch = arch
        self._span_start = t if self._span_start is None \
            else min(self._span_start, t)

    def on_reject(self, rid: str, reason: str):
        """One refusal event.  A queued request that is re-routed every
        tick counts one event per attempt — ``refusals`` is the operator's
        view of *why* admission is failing, not a unique-request count."""
        self._get(rid).rejected = reason
        self.rejected += 1
        self.refusals[reason] = self.refusals.get(reason, 0) + 1

    def on_admit(self, rid: str, t: float):
        self._get(rid).admit_s = t

    def on_dispatch(self, rid: str, endpoint: str):
        """The router committed the request to ``endpoint``."""
        self._get(rid).endpoint = endpoint

    def on_complete(self, rid: str, *, latency_s: Optional[float] = None,
                    energy_j: Optional[float] = None,
                    t: Optional[float] = None):
        """A routed request finished service: observed latency (feeds the
        per-endpoint percentiles the health state machine also reads) and
        its realized energy charge."""
        m = self._get(rid)
        if latency_s is not None:
            m.service_s = latency_s
        if energy_j is not None:
            m.energy_j += energy_j
            self.total_energy_j += energy_j
        if t is not None:
            self.on_finish(rid, t)

    def on_token(self, rid: str, t: float, n: int = 1):
        m = self._get(rid)
        if m.first_token_s is None:
            m.first_token_s = t
        m.n_tokens += n
        self._span_end = t if self._span_end is None \
            else max(self._span_end, t)

    def on_finish(self, rid: str, t: float):
        m = self._get(rid)
        m.finish_s = t
        self._span_end = t if self._span_end is None \
            else max(self._span_end, t)

    # ------------------------------------------------------------ energy
    def charge_tick(self, joules: float, active_rids: List[str]):
        """One engine tick's energy, split evenly among the live requests
        (the machine burned it regardless; occupancy decides the split)."""
        self.ticks += 1
        self.total_energy_j += joules
        if not active_rids:
            return
        share = joules / len(active_rids)
        for rid in active_rids:
            self._get(rid).energy_j += share

    # ----------------------------------------------------------- summary
    def endpoint_summary(self) -> Dict[str, dict]:
        """Per-endpoint completed counts and service-latency percentiles —
        the same numbers the health state machine's EWMA digests, so
        operators and the circuit breaker read one source of truth."""
        per: Dict[str, List[float]] = {}
        for m in self.requests.values():
            if m.endpoint is None or m.service_s is None:
                continue
            per.setdefault(m.endpoint, []).append(m.service_s)
        return {
            name: {
                "completed": len(lats),
                "latency_p50_s": percentile(lats, 50),
                "latency_p95_s": percentile(lats, 95),
            }
            for name, lats in sorted(per.items())
        }

    def summary(self) -> dict:
        done = [m for m in self.requests.values() if m.finish_s is not None]
        ttfts = [m.ttft_s for m in done if m.ttft_s is not None]
        tpots = [m.tpot_s for m in done if m.tpot_s is not None]
        tokens = sum(m.n_tokens for m in done)
        span = None
        if self._span_start is not None and self._span_end is not None \
                and self._span_end > self._span_start:
            span = self._span_end - self._span_start
        return {
            "completed": len(done),
            "rejected": self.rejected,
            "refusals": dict(self.refusals),
            "ticks": self.ticks,
            "tokens": tokens,
            "span_s": span,
            "tok_per_s": (tokens / span) if span else None,
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p95_s": percentile(ttfts, 95),
            "tpot_mean_s": (sum(tpots) / len(tpots)) if tpots else None,
            "total_energy_j": self.total_energy_j,
            "joules_per_request": (self.total_energy_j / len(done))
            if done else None,
            "endpoints": self.endpoint_summary(),
        }
