"""The traced window: a ``torch.profiler`` session over a slice of the
measured window, reduced to device intervals and host ranges.

The harness opens ``portbench.*`` ranges (``record_function``) around the
calls it makes into each layer and closes each with a synchronisation, so
every device event launched inside one also runs inside it: a device event
is placed in a host range by its own start time.  A range the program
opens without one (``train.optimizer``) is read from the device-side span
the profiler gives it (``device:train.optimizer``).  Nothing here imports
the program.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

PAD_SPINS = 64          # spin kernels that open a trace (the first records
PAD_CYCLES = 20_000     # of a trace can be lost; these absorb the loss)
TOP = 10
NAME_CHARS = 160        # a kernel's name as the breakdown gives it
RANGE_PREFIXES = ("portbench.", "train.")


class Interval:
    __slots__ = ("name", "start", "end")

    def __init__(self, name, start, end):
        self.name, self.start, self.end = name, start, end


class Ranges:
    """One range name's host intervals, sorted, for lookups by time."""

    def __init__(self, spans: List[Tuple[int, int]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def holding(self, t: int) -> Optional[Tuple[int, int]]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i]
        return None


class Traced:
    """What a traced slice holds: device events (kernels, copies, fills)
    that started in it, host ranges by name, and its bounds (ns)."""

    def __init__(self, events, ranges: Dict[str, Ranges], start: int,
                 end: int):
        self.events: List[Interval] = events
        self.ranges = ranges
        self.start, self.end = start, end

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def kernels(self, *names: str) -> List[Interval]:
        """Device events whose name holds any of ``names``."""
        return [e for e in self.events if any(n in e.name for n in names)]

    def within(self, range_name: str, events=None) -> List[Interval]:
        """Device events placed in a range named ``range_name``."""
        r = self.ranges.get(range_name)
        if r is None:
            return []
        return [e for e in (self.events if events is None else events)
                if r.holding(e.start) is not None]

    def by_span(self, range_name: str, events=None) -> Dict[tuple, list]:
        """Device events grouped by the range span that holds them."""
        r = self.ranges.get(range_name)
        out: Dict[tuple, list] = {}
        if r is None:
            return out
        for e in (self.events if events is None else events):
            span = r.holding(e.start)
            if span is not None:
                out.setdefault(span, []).append(e)
        return out

    def busy_ns(self, events=None) -> int:
        """Length of the union of the events' intervals, clipped to the
        slice."""
        ivs = sorted((max(e.start, self.start), min(e.end, self.end))
                     for e in (self.events if events is None else events))
        total, cur_s, cur_e = 0, None, None
        for s, e in ivs:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def idle_gaps(self) -> List[Tuple[int, int]]:
        ivs = sorted((max(e.start, self.start), min(e.end, self.end))
                     for e in self.events)
        gaps, t = [], self.start
        for s, e in ivs:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def breakdown(self, labels: List[str]) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost of ``labels`` (host ranges, innermost first) that
        held the host at each gap's middle."""
        by_name: Dict[str, float] = {}
        for e in self.events:
            n = e.name[:NAME_CHARS]
            by_name[n] = by_name.get(n, 0.0) + (e.end - e.start) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle: Dict[str, float] = {}
        for s, e in self.idle_gaps():
            mid = (s + e) // 2
            label = next((n for n in labels if n in self.ranges
                          and self.ranges[n].holding(mid) is not None),
                         "outside any portbench range")
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e9
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _pad():
    for _ in range(PAD_SPINS):
        torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


class Session:
    """``start()`` opens the profiler (after a pad of spin kernels) and a
    ``portbench.window`` range; ``stop()`` synchronises, closes both and
    returns the reduced :class:`Traced`.  On the CPU (the tests) the same
    calls record host ranges and no device event."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.device.type == "cuda":
            _pad()
        self.window = torch.profiler.record_function("portbench.window")
        self.window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Traced:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return reduce(self.prof)


def reduce(prof) -> Traced:
    """The profiler's raw events reduced to device intervals in the
    ``portbench.window`` range, host ranges by name, and the device-side
    spans of ranges as ``device:<name>``."""
    ranges: Dict[str, List[Tuple[int, int]]] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        span = (e.start_ns(), e.start_ns() + e.duration_ns())
        on_card = str(e.device_type()).endswith("CUDA")
        if name.startswith(RANGE_PREFIXES):
            ranges.setdefault(("device:" if on_card else "") + name,
                              []).append(span)
        elif on_card and not e.is_user_annotation():
            device.append((name, span))     # a kernel, copy or fill
    win = ranges.get("portbench.window", [(0, 0)])[0]
    out = [Interval(name, s, e) for name, (s, e) in device
           if win[0] <= s <= win[1]]
    return Traced(out, {n: Ranges(v) for n, v in ranges.items()}, win[0],
                  win[1])
