"""Straggler watchdog, the part of ``repro.runtime.fault_tolerance`` the
serve-time health machine uses.

The reference module also holds ``run_resilient``, the checkpointed training
loop; it joins the port with the training slice, which brings the
checkpointer it needs.
"""
from __future__ import annotations

import logging
import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

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
