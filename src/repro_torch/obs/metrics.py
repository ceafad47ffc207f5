"""Metrics registry: one ``snapshot()`` over the repo's scattered counters.

PRs 1-9 grew ad-hoc counters in three places — ``CacheStats``
(plan/search side), ``ServeMetrics`` (request side) and
``EndpointHealth.transitions`` (control side) — each with its own
``to_dict()``/``summary()`` face.  :class:`MetricsRegistry` consolidates
them behind one nested snapshot **without breaking those public faces**:
first-class :class:`Counter`/:class:`Gauge`/:class:`Histogram` instruments
for new measurements, plus *collectors* — callables polled at snapshot
time — that adapt the existing objects in place.

Zero dependencies; imports neither torch nor numpy.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional


class Counter:
    """Monotonic count (events, tokens, joules...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value (queue depth, live slots, power draw...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float):
        self.value = value

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming distribution: count/sum/min/max plus a bounded reservoir
    for percentiles (first ``cap`` observations — deterministic, no
    sampling RNG; the serve paths this instruments are tick-bounded)."""

    __slots__ = ("name", "count", "total", "lo", "hi", "cap", "_values")

    def __init__(self, name: str, cap: int = 4096):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.lo = math.inf
        self.hi = -math.inf
        self.cap = cap
        self._values: List[float] = []

    def observe(self, value: float):
        v = float(value)
        self.count += 1
        self.total += v
        self.lo = min(self.lo, v)
        self.hi = max(self.hi, v)
        if len(self._values) < self.cap:
            self._values.append(v)

    def percentile(self, p: float) -> Optional[float]:
        from repro_torch.serve.metrics import percentile
        return percentile(self._values, p)

    def snapshot(self):
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.lo, "max": self.hi,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class MetricsRegistry:
    """Get-or-create instrument registry + snapshot-time collectors.

    ``counter``/``gauge``/``histogram`` return the named instrument,
    creating it on first use — call sites don't coordinate registration.
    :meth:`register_collector` adds a named callable polled by
    :meth:`snapshot`; the ``attach_*`` helpers wire up the repo's existing
    counter objects that way, leaving their own APIs untouched.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], Any]] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, cap=cap)
        return h

    def register_collector(self, name: str, fn: Callable[[], Any]):
        """Poll ``fn()`` at snapshot time under key ``name`` (an adapter
        for pre-existing counter objects; last registration wins)."""
        self._collectors[name] = fn

    # ------------------------------------------------- existing-face adapters
    def attach_cache_stats(self, name: str, stats):
        """Adapt a :class:`repro_torch.core.search_cache.CacheStats`."""
        self.register_collector(name, stats.to_dict)

    def attach_serve_metrics(self, name: str, metrics):
        """Adapt a :class:`repro_torch.serve.metrics.ServeMetrics` (summary keys
        only — per-request detail stays on the object)."""
        self.register_collector(name, metrics.summary)

    def attach_health(self, name: str, health_map):
        """Adapt a ``{endpoint: EndpointHealth}`` map to per-endpoint
        state + transition counts."""
        def collect():
            out = {}
            for ep, h in sorted(health_map.items()):
                out[ep] = {"state": h.state,
                           "transitions": len(h.transitions),
                           "errors": h.errors}
            return out
        self.register_collector(name, collect)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """One nested dict over everything: first-class instruments under
        ``counters``/``gauges``/``histograms``, collectors under
        ``collected``."""
        out: Dict[str, Any] = {
            "counters": {k: c.snapshot()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.snapshot()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(self._histograms.items())},
            "collected": {},
        }
        for name, fn in sorted(self._collectors.items()):
            try:
                out["collected"][name] = fn()
            except Exception as e:      # a dead collector must not sink
                out["collected"][name] = {"error": repr(e)[:200]}
        return out
