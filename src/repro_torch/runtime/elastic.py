"""Elastic scaling: resume any checkpoint onto a different mesh; the port
of ``repro.runtime.elastic``.

Checkpoints store whole tensors, so resharding is a placement decision at
restore time.  :func:`reshard_restore` builds the shardings for the *new*
mesh from the model's logical axes and restores onto it (each leaf a
DTensor with its placements), and :func:`available_mesh` builds the mesh
the live ranks can form: scale from 512 ranks to 256, or to one card,
without conversion.

:class:`ResizeEvent` / :func:`detect_resize` are the signal side: an edge
detector over the live device count that the online fleet controller
(:class:`repro_torch.runtime.control.FleetController.on_resize`) consumes to
trigger a placement replan when a slice is lost or regained.

Importing this module pulls in neither torch nor numpy (the fleet layers
import it); the restore functions import them when called.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence


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


def shardings_for(cfg, mesh, plan, tree, axes_tree):
    """The shardings of ``tree`` (tensors, arrays or anything with a
    ``shape``) on ``mesh`` under ``plan``'s rules."""
    from repro_torch.dist.sharding import Rules, tree_shardings
    return tree_shardings(Rules(mesh, plan), axes_tree, tree)


def reshard_restore(ckpt, *, step: Optional[int], new_mesh, plan, cfg,
                    make_abstract, axes_tree) -> Any:
    """Restore checkpoint ``step`` re-sharded for ``new_mesh``: (tree,
    extra), each leaf a DTensor.  ``make_abstract()`` returns a tree
    matching the saved one whose leaves have the saved shapes (tensors,
    or ``torch.empty(shape, device="meta")``)."""
    shardings = shardings_for(cfg, new_mesh, plan, make_abstract(),
                              axes_tree)
    return ckpt.restore(step, shardings=shardings)


def available_mesh(preferred_shape: Optional[Sequence[int]] = None,
                   axes=("data", "model"), device=None):
    """The best mesh for the ranks that are alive (an elastic restart after
    losing a slice): ``preferred_shape`` when the live world holds it,
    else every rank on the first axis and 1 on the rest.  With no process
    group, a one-rank one is started (``launch.mesh.init_local_group``)."""
    import math

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_local_group, make_test_mesh
    init_local_group(device)
    n = dist.get_world_size()
    if preferred_shape is not None and math.prod(preferred_shape) <= n:
        return make_test_mesh(tuple(preferred_shape), tuple(axes), device)
    return make_test_mesh((n,) + (1,) * (len(axes) - 1), tuple(axes),
                          device)
