"""Span tracer: one timeline for plan -> publish -> serve -> control, the
port of ``repro.obs.tracer``.

Nested :class:`Span`s and instant events recorded by a :class:`Tracer`,
exported as JSONL / Chrome trace / text summary
(:mod:`repro_torch.obs.export`) and post-mortemed by ``python -m
repro_torch.obs.report``.  The planner opens a ``plan/offload`` span per app
and a ``plan/verify`` span per verification, the GA records a
``ga/generation`` event per generation, the continuous batcher one
``engine/tick`` complete-span per tick, the router a ``serve/route`` span
per decision and the control loop its ``control/*`` events, under the same
names as the JAX package, so one reader serves both.

Design constraints, all load-bearing:

  * **zero dependencies** — importing :mod:`repro_torch.obs` pulls in
    neither torch nor numpy;
  * **null-object disabled state** — the ambient tracer defaults to
    :data:`NULL_TRACER`; every instrumented call site writes
    ``with get_tracer().span(...) as sp: sp.set(...)`` unconditionally and
    pays only a no-op context manager when tracing is off;
  * **caller-supplied clocks** — offline search spans stamp wall time; the
    serve/control loop pins the tracer to its virtual tick clock
    (:meth:`Tracer.set_time`), so a :class:`~repro_torch.runtime.control
    .ControlLoop` replay produces a **byte-identical** JSONL log (pinned in
    tests/test_torch_control.py).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional


def _jsonable(obj):
    """Clamp attribute values to JSON-representable structures."""
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    return repr(obj)


class Span:
    """One timed, attributed operation on a track.

    Context-manager use stamps ``t1`` at exit; :meth:`set` attaches
    attributes at any point before the span is recorded.  Spans nest: the
    tracer keeps a per-thread stack, and each span records its parent's
    id, so exporters can reconstruct the tree.
    """

    __slots__ = ("tracer", "id", "parent", "name", "cat", "track",
                 "t0", "t1", "attrs")

    def __init__(self, tracer: "Tracer", sid: int, parent: Optional[int],
                 name: str, cat: str, track: str, t0: float,
                 attrs: Dict[str, Any]):
        self.tracer = tracer
        self.id = sid
        self.parent = parent
        self.name = name
        self.cat = cat
        self.track = track
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def finish(self, t: Optional[float] = None):
        if self.t1 is not None:
            return                       # already recorded
        self.t1 = float(t) if t is not None else self.tracer.now()
        self.tracer._record_span(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", repr(exc)[:200])
        self.finish()
        return False


class _NullSpan:
    """The disabled tracer's span: accepts everything, records nothing."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def finish(self, t=None):
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Null-object tracer: the ambient default when tracing is disabled.

    Every method is a cheap no-op, so instrumented call sites need no
    conditionals — ``get_tracer().span(...)`` costs one attribute lookup
    and one singleton return.
    """

    enabled = False

    def span(self, name, cat="", track="", t0=None, **attrs):
        return NULL_SPAN

    def complete_span(self, name, t0, t1, cat="", track="", **attrs):
        return None

    def event(self, name, cat="", track="", t=None, **attrs):
        return None

    def set_time(self, t):
        pass

    def clear_time(self):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer (see module docstring).

    ``clock`` supplies timestamps (default ``time.perf_counter``);
    :meth:`set_time` overrides it with a pinned virtual time — the
    serve/control loop pins each tick, so replays are byte-identical.
    Records accumulate in memory in completion order; export them with
    :meth:`to_jsonl` / :meth:`to_chrome` / :meth:`summary`.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.records: List[dict] = []
        self._lock = threading.Lock()
        self._seq = 0
        self._pinned: Optional[float] = None
        self._local = threading.local()

    # --------------------------------------------------------------- clock
    def now(self) -> float:
        return self._pinned if self._pinned is not None else self.clock()

    def set_time(self, t: float):
        """Pin the current time (virtual tick clocks; deterministic)."""
        self._pinned = float(t)

    def clear_time(self):
        self._pinned = None

    # --------------------------------------------------------------- spans
    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def span(self, name: str, cat: str = "", track: str = "",
             t0: Optional[float] = None, **attrs) -> Span:
        """Open a span; close it via context manager or ``finish()``."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sp = Span(self, self._next_id(), parent, name, cat, track,
                  float(t0) if t0 is not None else self.now(),
                  dict(attrs))
        stack.append(sp.id)
        return sp

    def _record_span(self, sp: Span):
        stack = self._stack()
        if stack and stack[-1] == sp.id:
            stack.pop()
        elif sp.id in stack:             # out-of-order finish: unwind to it
            del stack[stack.index(sp.id):]
        with self._lock:
            self.records.append({
                "type": "span", "id": sp.id, "parent": sp.parent,
                "name": sp.name, "cat": sp.cat, "track": sp.track,
                "t0": sp.t0, "t1": sp.t1,
                "attrs": _jsonable(sp.attrs)})

    def complete_span(self, name: str, t0: float, t1: float, cat: str = "",
                      track: str = "", **attrs) -> dict:
        """Record an already-finished span with explicit timestamps (e.g. a
        request's dispatch->completion window on the tick clock)."""
        rec = {"type": "span", "id": self._next_id(), "parent": None,
               "name": name, "cat": cat, "track": track,
               "t0": float(t0), "t1": float(t1), "attrs": _jsonable(attrs)}
        with self._lock:
            self.records.append(rec)
        return rec

    def event(self, name: str, cat: str = "", track: str = "",
              t: Optional[float] = None, **attrs) -> dict:
        """Record an instant event."""
        rec = {"type": "event", "id": self._next_id(), "name": name,
               "cat": cat, "track": track,
               "t": float(t) if t is not None else self.now(),
               "attrs": _jsonable(attrs)}
        with self._lock:
            self.records.append(rec)
        return rec

    # ------------------------------------------------------------- exports
    def to_jsonl(self, path) -> str:
        from repro_torch.obs.export import write_jsonl
        return write_jsonl(self.records, path)

    def to_chrome(self, path) -> str:
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(self.records, path)

    def summary(self) -> str:
        from repro_torch.obs.export import text_summary
        return text_summary(self.records)


# ------------------------------------------------------- the ambient tracer
_current: object = NULL_TRACER


def get_tracer():
    """The ambient tracer every instrumented call site records through
    (:data:`NULL_TRACER` unless :func:`set_tracer`/:func:`use_tracer`
    installed a recording one)."""
    return _current


def set_tracer(tracer) -> object:
    """Install ``tracer`` as the ambient tracer (None restores the null
    tracer).  Returns the installed tracer."""
    global _current
    _current = tracer if tracer is not None else NULL_TRACER
    return _current


@contextmanager
def use_tracer(tracer):
    """Scoped :func:`set_tracer`: restores the previous tracer on exit."""
    global _current
    prev = _current
    _current = tracer if tracer is not None else NULL_TRACER
    try:
        yield _current
    finally:
        _current = prev
