"""Fault-tolerant training runtime: the port of
``repro.runtime.fault_tolerance``.

:class:`StragglerWatchdog` flags slow steps (and, in the serve-time health
machine, slow requests); :func:`run_resilient` is the checkpointed training
loop: resume from the latest checkpoint, roll back to the last good one
and retry when a step raises, a watchdog over every step time.  Importing
this module pulls in neither torch nor numpy: the loop reaches the
checkpointer only through the object it is handed.
"""
from __future__ import annotations

import logging
import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Any, Callable, Deque, Dict, List,
                    Optional)

if TYPE_CHECKING:                                 # torch-free import path
    from repro_torch.checkpoint.checkpointer import Checkpointer

log = logging.getLogger("repro_torch.runtime")


@dataclass
class StragglerWatchdog:
    """Step-time EWMA + z-score straggler/anomaly detector.

    A step (or request) whose time exceeds mean + threshold*std of the
    window before it is flagged.  The serve-time health state machine
    (repro_torch.serve.health) runs one per endpoint over observed request
    latencies; ``reset()`` starts a fresh window when an endpoint recovers,
    so post-recovery statistics are never judged against the degraded
    regime.
    """
    window: int = 50
    threshold: float = 3.0
    ewma_alpha: float = 0.1
    times: Deque[float] = field(default_factory=deque)
    ewma: Optional[float] = None
    flagged: List[Dict] = field(default_factory=list)

    def __post_init__(self):
        # bounded ring buffer: append evicts the oldest sample for free
        self.times = deque(self.times, maxlen=self.window)

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        self.ewma = dt if self.ewma is None else \
            self.ewma_alpha * dt + (1 - self.ewma_alpha) * self.ewma
        if len(self.times) >= 10:
            prior = list(self.times)[:-1]
            mu = statistics.fmean(prior)
            sd = statistics.pstdev(prior) or 1e-9
            if dt > mu + self.threshold * sd:
                self.flagged.append({"step": step, "dt": dt, "mean": mu,
                                     "std": sd})
                log.warning("straggler step %d: %.3fs (mean %.3fs)",
                            step, dt, mu)
                return True
        return False

    def reset(self):
        """Start a fresh window (per-endpoint reuse after recovery): the
        sample window and EWMA restart cold; ``flagged`` keeps its history
        — past flags are a record, not current state."""
        self.times.clear()
        self.ewma = None


@dataclass
class ResilientLoopResult:
    last_step: int
    restarts: int
    metrics_history: List[dict]
    watchdog: StragglerWatchdog
    state: Any = None           # the loop's state after its last step


def run_resilient(
    *,
    total_steps: int,
    checkpointer: "Checkpointer",
    init_state: Callable[[], Any],
    step_fn: Callable[[Any, int], tuple],        # (state, step) -> (state, metrics)
    save_every: int = 50,
    max_restarts: int = 3,
    device: Any = "cpu",
    fault_hook: Optional[Callable[[int], None]] = None,
    async_checkpoint: bool = True,
) -> ResilientLoopResult:
    """Checkpointed training loop with automatic retry + resume.

    * resumes from the latest checkpoint if one exists (its leaves restored
      onto ``device``, the reference's ``state_shardings``);
    * on exception: emergency-saves nothing (state may be poisoned), rolls
      back to the last good checkpoint and retries, up to ``max_restarts``;
    * straggler watchdog records every step time.
    """
    watchdog = StragglerWatchdog()
    restarts = 0
    history: List[dict] = []

    def load_or_init():
        last = checkpointer.latest_step()
        if last is not None:
            state, extra = checkpointer.restore(last, device=device)
            log.info("resumed from step %d", last)
            return state, int(extra.get("next_step", last))
        return init_state(), 0

    state, step = load_or_init()
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            if fault_hook is not None:
                fault_hook(step)
            state, metrics = step_fn(state, step)
            dt = time.perf_counter() - t0
            watchdog.record(step, dt)
            history.append({"step": step, "dt": dt, **{
                k: float(v) for k, v in (metrics or {}).items()
                if hasattr(v, "__float__") or isinstance(v, (int, float))}})
            step += 1
            if step % save_every == 0 or step == total_steps:
                if async_checkpoint:
                    checkpointer.async_save(step, state,
                                            {"next_step": step})
                else:
                    checkpointer.save(step, state, {"next_step": step})
        except KeyboardInterrupt:
            raise
        except Exception as e:
            restarts += 1
            log.error("step %d failed (%r); restart %d/%d", step, e,
                      restarts, max_restarts)
            if restarts > max_restarts:
                checkpointer.wait()
                raise
            checkpointer.wait()
            state, step = load_or_init()
    checkpointer.wait()
    return ResilientLoopResult(last_step=step, restarts=restarts,
                               metrics_history=history, watchdog=watchdog,
                               state=state)
