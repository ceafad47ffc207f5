"""Verification environment: dynamic measurement of candidate patterns, the
port of ``repro.core.measure`` (``TimedRunner`` and ``outputs_close``).

:class:`TimedRunner` actually executes the candidate on this machine, times
it (best-of-k after a first call), and applies the paper's result-equality
check: a result differing from the un-offloaded reference, or a timeout,
sets processing time to 1000 s so the pattern dies out of the GA.  PyTorch
runs eagerly, so each timed call is bracketed by ``torch.cuda.synchronize()``
on the inputs' card: the time is the device's, not the enqueue's.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.ga import Evaluation


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_floating_point() and x.dtype not in (torch.float32,
                                                     torch.float64):
            x = x.to(torch.float64)        # bf16/fp16 have no numpy type
        return x.numpy()
    return np.asarray(x)


def outputs_close(a, b, rtol=1e-2, atol=1e-2) -> bool:
    try:
        la = tree_leaves(a)
        lb = tree_leaves(b)
        if len(la) != len(lb):
            return False
        for x, y in zip(la, lb):
            x = _host_array(x)
            y = _host_array(y)
            if x.shape != y.shape:
                return False
            if x.dtype.kind in "biu" and y.dtype.kind in "biu":
                # integer/bool results compare exactly — a float64 round
                # trip is silently lossy above 2**53
                if not np.array_equal(x, y):
                    return False
                continue
            x = x.astype(np.float64)
            y = y.astype(np.float64)
            if not np.allclose(x, y, rtol=rtol, atol=atol, equal_nan=False):
                return False
            if not np.isfinite(x).all():
                return False
        return True
    except Exception:
        return False


def _synchronize(inputs) -> None:
    """Wait for every card the inputs live on."""
    for dev in {t.device for t in tree_leaves(inputs)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class TimedRunner:
    def __init__(self, timeout_s: float = 180.0, rtol: float = 1e-2,
                 atol: float = 1e-2, repeats: int = 3):
        self.timeout_s = timeout_s
        self.rtol = rtol
        self.atol = atol
        self.repeats = repeats

    def _timed_call(self, fn: Callable, inputs):
        _synchronize(inputs)
        t0 = time.perf_counter()
        out = fn(inputs)
        _synchronize(inputs)
        return out, time.perf_counter() - t0

    def measure(self, fn: Callable, inputs, reference_out) -> Evaluation:
        """Time fn(inputs) and check it against reference_out.

        ``reference_out=None`` means "this IS the reference run": the result
        is trivially correct and callers reuse ``info["output"]`` instead of
        executing the reference a second time (see planner.plan_offload).
        """
        try:
            out, first = self._timed_call(fn, inputs)     # warm-up + run
            if first > self.timeout_s:
                return Evaluation(time_s=first, correct=False,
                                  timed_out=True)
            times = []
            for _ in range(self.repeats):
                # every call gets the budget, not only the first: a
                # candidate whose steady-state repeats hang must die
                # through the paper's penalty path instead of running
                # unbounded (per-call, so a legitimately slow-but-correct
                # candidate under timeout_s per run is still measured)
                out, dt = self._timed_call(fn, inputs)
                if dt > self.timeout_s:
                    return Evaluation(time_s=dt, correct=False,
                                      timed_out=True)
                times.append(dt)
            if reference_out is None:
                # reference run: keep the output for reuse; candidate runs
                # drop it (the GA cache would otherwise pin one output-sized
                # tensor per evaluated gene string)
                return Evaluation(time_s=min(times), correct=True,
                                  info={"first_call_s": first,
                                        "output": out})
            correct = outputs_close(out, reference_out, self.rtol, self.atol)
            return Evaluation(time_s=min(times), correct=correct,
                              info={"first_call_s": first})
        except Exception as e:   # a failing candidate == "conversion fails"
            return Evaluation(time_s=float("inf"), correct=False,
                              info={"error": repr(e)[:500]})
