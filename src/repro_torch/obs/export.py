"""Trace exporters: JSONL, Chrome trace-event JSON, text summary.

JSONL is the canonical archive format: one record per line, keys sorted,
compact separators and deterministic float repr — so two traces of the
same deterministic scenario are **byte-identical** files (the control
loop's replay pin, extended to observability in tests/test_torch_control.py).

The Chrome export targets the trace-event format Perfetto and
``chrome://tracing`` load: spans become ``ph:"X"`` complete events, instant
events ``ph:"i"``, and each distinct ``track`` string becomes a named
thread via ``ph:"M"`` ``thread_name`` metadata — so endpoints, backends and
the control plane render as separate swim-lanes.  Timestamps are
microseconds (the serve tick clock's seconds scale up cleanly).
"""
from __future__ import annotations

import json
from typing import Iterable, List


def jsonl_line(record: dict) -> str:
    """The canonical byte-stable encoding of one record."""
    return json.dumps(record, sort_keys=True, separators=(",", ":"))


def write_jsonl(records: Iterable[dict], path) -> str:
    path = str(path)
    with open(path, "w") as f:
        for rec in records:
            f.write(jsonl_line(rec))
            f.write("\n")
    return path


def read_jsonl(path) -> List[dict]:
    out = []
    with open(str(path)) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ------------------------------------------------------------ chrome trace
_US = 1e6          # record times are seconds; trace-event ts/dur are µs


def chrome_trace(records: Iterable[dict]) -> dict:
    """Render records as a Chrome trace-event JSON object.

    Tracks map to tids in first-appearance order (deterministic for a
    deterministic record stream); everything runs under one pid.
    """
    tids = {}

    def tid_for(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids) + 1
        return t

    events = []
    for rec in records:
        track = rec.get("track") or "main"
        tid = tid_for(track)
        args = dict(rec.get("attrs") or {})
        if rec.get("type") == "span":
            t0, t1 = rec["t0"], rec["t1"]
            events.append({
                "ph": "X", "name": rec["name"], "cat": rec.get("cat") or "",
                "pid": 1, "tid": tid, "ts": t0 * _US,
                "dur": max(t1 - t0, 0.0) * _US, "args": args})
        elif rec.get("type") == "event":
            events.append({
                "ph": "i", "name": rec["name"], "cat": rec.get("cat") or "",
                "pid": 1, "tid": tid, "ts": rec["t"] * _US, "s": "t",
                "args": args})
    meta = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
             "args": {"name": track}} for track, tid in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(records: Iterable[dict], path) -> str:
    path = str(path)
    with open(path, "w") as f:
        json.dump(chrome_trace(records), f, sort_keys=True)
    return path


# ------------------------------------------------------------ text summary
def text_summary(records: Iterable[dict]) -> str:
    """Per-(category, name) span/event counts and total span time — the
    at-a-glance answer to "where did the time go"."""
    spans = {}
    events = {}
    for rec in records:
        key = (rec.get("cat") or "", rec["name"])
        if rec.get("type") == "span":
            n, tot = spans.get(key, (0, 0.0))
            spans[key] = (n + 1, tot + max(rec["t1"] - rec["t0"], 0.0))
        elif rec.get("type") == "event":
            events[key] = events.get(key, 0) + 1
    lines = ["trace summary",
             f"  {sum(n for n, _ in spans.values())} spans, "
             f"{sum(events.values())} events"]
    if spans:
        lines.append("  spans (count, total_s):")
        for (cat, name), (n, tot) in sorted(
                spans.items(), key=lambda kv: -kv[1][1]):
            label = f"{cat}/{name}" if cat else name
            lines.append(f"    {label:<40} {n:>6}  {tot:10.4f}")
    if events:
        lines.append("  events (count):")
        for (cat, name), n in sorted(events.items(), key=lambda kv: -kv[1]):
            label = f"{cat}/{name}" if cat else name
            lines.append(f"    {label:<40} {n:>6}")
    return "\n".join(lines)
