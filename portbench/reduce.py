"""Arithmetic the metric readers share: latencies on the host clock over
the measured window, device times of the admissions and decode steps a
traced run times by CUDA events before its profiler starts, and shares of
the traced slice's device time.

A reader returns None where its run holds nothing to read (no trace, no
request, no kernel of its name); it never returns 0 for a share of a peak
or of a roofline.
"""
from __future__ import annotations

from typing import List, Optional

from portbench import yardstick as ys

FLASH_FWD = ("flash_bf16_kernel", "flash_f32_kernel")
FLASH_BWD = ("bwd_prep_kernel", "bwd_dkdv_", "bwd_dq_")
DECODE = ("decode_kernel", "decode_mma_kernel")


def in_window(run, t: float) -> bool:
    return run.window[0] <= t <= run.window[1]


def due_in_window(run) -> List[dict]:
    w0, w1 = run.window[0], run.window[0] + run.seconds
    return [q for q in run.requests.values() if w0 <= q["due"] < w1]


def ttft_s(run) -> List[float]:
    """From each request's due time to its first token; a request with
    none counts the time until the run stopped waiting."""
    return [(q["times"][0] if q["times"] else run.stop) - q["due"]
            for q in due_in_window(run)]


def itl_s(run) -> List[float]:
    out = []
    for q in run.requests.values():
        t = q.get("times") or []
        out += [b - a for a, b in zip(t, t[1:]) if in_window(run, b)]
    return out


def ms(x: Optional[float]) -> Optional[float]:
    return None if x is None else 1e3 * x


# ------------------------------------------------------------ traced slice

def traced_admissions(run) -> List[dict]:
    """Requests whose admission started in the traced slice."""
    t0, t1 = run.traced_host
    return [q for q in run.requests.values()
            if q.get("admit") is not None and t0 <= q["admit"] <= t1]


def decode_bound_s(run) -> float:
    """Least time of the traced steps' decode-attention calls: the valid
    rows of the slots that serve a request, read once (a retired slot's
    stale rows are work no request needs)."""
    cfg, w = run.cfg, run.mix["cache_len"]
    total = 0.0
    for _, pos, active, *_ in run.traced_steps:
        valid = int(sum(min(int(p) + 1, w) for p, a in zip(pos, active)
                        if a))
        total += ys.least_seconds(*ys.decode_work(
            len(pos), cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"],
            valid)) * cfg["n_layers"]
    return total


def decode_flops(run, steps) -> float:
    """Model FLOPs of decode steps (records whose second and third items
    are the slots' positions and activity): the active slots' tokens."""
    cfg, w = run.cfg, run.mix["cache_len"]
    total = 0.0
    for _, pos, active, *_ in steps:
        live = [int(p) for p, a in zip(pos, active) if a]
        pairs = sum(min(p + 1, w) for p in live)
        total += ys.forward_flops(cfg, len(live), pairs)
    return total


def prefill_flops(run, prompt_lens) -> float:
    return sum(ys.forward_flops(run.cfg, n, ys.causal_pairs(n))
               for n in prompt_lens)


def flash_fwd_bound_s(run) -> float:
    cfg = run.cfg
    g = cfg["n_heads"] // cfg["n_kv_heads"]
    return sum(ys.least_seconds(*ys.flash_fwd_work(
        cfg["n_heads"], q["prompt_len"], cfg["d_head"], g)) * cfg["n_layers"]
        for q in traced_admissions(run))


def kernel_s(run, names) -> float:
    return sum(e.end - e.start for e in run.traced.kernels(*names)) / 1e9


def share(bound_s: float, took_s: float) -> Optional[float]:
    """A share of a peak in %, or None where nothing ran."""
    if took_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / took_s


def idle_share(run) -> Optional[float]:
    """Share of the traced slice with no device operation running."""
    if run.traced is None or run.traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.traced.busy_ns() / 1e9 / run.traced.window_s)


# ----------------------------------------- timed by CUDA events, untraced

def timed_ms(run):
    """The event-timed admissions' and steps' device milliseconds, and the
    device's span from the first's start to the last's end; None before a
    traced run on the card has timed anything."""
    span = getattr(run, "timed_span_ms", 0.0)
    if span <= 0:
        return None
    return (sum(t for t, _ in run.timed_admits),
            sum(t for t, *_ in run.timed_steps), span)


def timed_idle_share(run) -> Optional[float]:
    """Share of the event-timed span in which the device was in neither an
    admission nor a decode step (the two never overlap: one stream)."""
    got = timed_ms(run)
    if got is None:
        return None
    admits, steps, span = got
    return 100.0 * (1.0 - (admits + steps) / span)


def timed_prefill_ms_per_ktok(run) -> Optional[float]:
    ktok = sum(n for _, n in getattr(run, "timed_admits", ())) / 1e3
    if ktok <= 0:
        return None
    return sum(t for t, _ in run.timed_admits) / ktok
