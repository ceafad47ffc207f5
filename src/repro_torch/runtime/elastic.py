"""Capacity-change signal, the part of ``repro.runtime.elastic`` the fleet
controller consumes.

:class:`ResizeEvent` / :func:`detect_resize` are an edge detector over the
live device count that the online fleet controller
(:class:`repro_torch.runtime.control.FleetController.on_resize`) consumes to
trigger a placement replan when a slice is lost or regained.  The
reference's ``reshard_restore`` / ``available_mesh`` (restore a checkpoint
onto another mesh) join the port with the training and mesh slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ResizeEvent:
    """One observed change in usable capacity (devices, chips, slots)."""
    tick: int
    n_before: int
    n_after: int

    @property
    def grew(self) -> bool:
        return self.n_after > self.n_before


def detect_resize(prev_n: Optional[int], n: int,
                  tick: int = 0) -> Optional[ResizeEvent]:
    """Edge-detect a capacity change: None while the count is stable (or
    on the first observation), a :class:`ResizeEvent` on any transition —
    the elastic-restart signal the fleet controller replans on."""
    if prev_n is None or prev_n == n:
        return None
    return ResizeEvent(tick=tick, n_before=prev_n, n_after=n)
