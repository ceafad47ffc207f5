"""Verification environment: dynamic measurement of candidate patterns, the
port of ``repro.core.measure``.

Two runners:

  * :class:`TimedRunner` actually executes the candidate on this machine,
    times it (best-of-k after a first call), and applies the paper's
    result-equality check: a result differing from the un-offloaded
    reference, or a timeout, sets processing time to 1000 s so the pattern
    dies out of the GA.  PyTorch runs eagerly, so each timed call is
    bracketed by ``torch.cuda.synchronize()`` on the inputs' card: the time
    is the device's, not the enqueue's.
  * :class:`CompiledCostRunner` traces the candidate on fake tensors
    (:mod:`repro_torch.core.trace_analysis`: shapes only, no launch, no
    device memory) and scores the traced artifact with the H100 roofline
    (:mod:`repro_torch.core.cost_model`).  It keeps the reference's name:
    the traced artifact stands where the compiled one stood.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core import cost_model
from repro_torch.core.ga import Evaluation
from repro_torch.core.search_cache import analyze_artifact
from repro_torch.core.trace_analysis import Traceable


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


class CompiledCostRunner:
    """Roofline scoring of traced candidates (``mesh`` and ``n_chips`` as in
    the reference: the chips a step's per-device analysis is spread over)."""

    def __init__(self, mesh=None, n_chips: Optional[int] = None,
                 model_flops: float = 0.0):
        self.mesh = mesh
        size = getattr(mesh, "size", 1)        # DeviceMesh.size() a method
        self.n_chips = n_chips or int(size() if callable(size) else size)
        self.model_flops = model_flops

    def score_analysis(self, analyzed: dict, verify_s: float = 0.0, *,
                       bubble_fraction: float = 0.0,
                       cache_hit: Optional[bool] = None) -> Evaluation:
        """Roofline-score an analysis dict — pure arithmetic.

        This is the cache-hit scoring path (repro_torch.core.search_cache):
        the analysis dict stands in for the traced artifact, so re-scoring
        the same artifact under a different ``bubble_fraction`` or
        selection policy never retraces.
        """
        try:
            rl = cost_model.roofline_from_analysis(
                analyzed, n_chips=self.n_chips,
                model_flops=self.model_flops,
                bubble_fraction=bubble_fraction)
            info = {"roofline": rl.to_dict(), "verify_s": verify_s}
            if cache_hit is not None:
                info["cache_hit"] = cache_hit
            return Evaluation(time_s=rl.step_time_s, correct=True,
                              info=info)
        except Exception as e:
            return Evaluation(time_s=float("inf"), correct=False,
                              info={"error": repr(e)[:500]})

    def score_artifact(self, artifact, verify_s: float = 0.0, *,
                       bubble_fraction: float = 0.0) -> Evaluation:
        """Roofline-score an already traced artifact (the reference's
        ``score_compiled``); the analysis is memoised per artifact
        (``search_cache.analyze_artifact``)."""
        try:
            analyzed = analyze_artifact(artifact)
        except Exception as e:
            return Evaluation(time_s=float("inf"), correct=False,
                              info={"error": repr(e)[:500]})
        return self.score_analysis(analyzed, verify_s,
                                   bubble_fraction=bubble_fraction)

    def measure_traced(self, traceable: Traceable, *,
                       bubble_fraction: float = 0.0) -> Evaluation:
        """Trace and score (the reference's ``measure_lowered``)."""
        try:
            t0 = time.perf_counter()
            artifact = traceable.trace()
            verify_s = time.perf_counter() - t0
        except Exception as e:
            return Evaluation(time_s=float("inf"), correct=False,
                              info={"error": repr(e)[:500]})
        return self.score_artifact(artifact, verify_s,
                                   bubble_fraction=bubble_fraction)

    def measure(self, fn: Callable, inputs, *, shardings=None,
                bubble_fraction: float = 0.0) -> Evaluation:
        """Trace ``fn(inputs)`` and score it.  ``inputs`` may hold real
        tensors or :class:`~repro_torch.core.trace_analysis.TensorSpec` s:
        either way they become fake tensors on their own device (the card
        for a spec without one), and no device memory is touched.
        ``shardings`` (NamedShardings over a DeviceMesh, a tree like
        ``inputs``) trace one device of that mesh on DTensor shards, its
        collectives counted (``trace_analysis.trace``)."""
        return self.measure_traced(Traceable(fn, inputs, shardings),
                                   bubble_fraction=bubble_fraction)
