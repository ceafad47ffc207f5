"""repro_torch.dist — the parallelism-plan subsystem; the port of
``repro.dist``.

  * :mod:`repro_torch.dist.plan`      — :class:`Plan` (a copy of the
    reference's dataclass and its ``GENE_SPACE``).
  * :mod:`repro_torch.dist.sharding`  — :class:`Rules` (logical-axis ->
    mesh-axis mapping with the largest-divisible-prefix / duplicate-axis
    fallbacks) over a ``DeviceMesh``, :class:`NullRules`,
    ``tree_shardings`` and ``batch_axes``.
  * :mod:`repro_torch.dist.schedules` — pipeline schedules as static tick
    plans (``gpipe``, ``one_f_one_b``, ``interleaved``).
  * :mod:`repro_torch.dist.pipeline`  — ``pipeline_apply`` /
    ``sequential_apply`` over the mesh's "pod" ranks.
  * :mod:`repro_torch.dist.collectives` — the SPMD collectives the
    pipeline, the pod-parallel step and expert-parallel MoE share.
  * :mod:`repro_torch.dist.bridge`    — the planner <-> mesh bridge.

The torch-backed exports resolve lazily (PEP 562), so importing
``repro_torch.dist.schedules`` or ``.plan`` pulls in no torch.
"""
from typing import TYPE_CHECKING

from repro_torch.dist.plan import NAMED_PLANS, Gene, Plan
from repro_torch.dist.schedules import (SCHEDULES, Schedule, TickPlan,
                                        get_schedule, register_schedule)

_LAZY = {name: "repro_torch.dist.sharding"
         for name in ("Rules", "NullRules", "tree_shardings", "batch_axes")}

__all__ = ["Plan", "Gene", "NAMED_PLANS", "Rules", "NullRules",
           "tree_shardings", "batch_axes", "Schedule", "TickPlan",
           "SCHEDULES", "get_schedule", "register_schedule"]

if TYPE_CHECKING:                               # pragma: no cover
    from repro_torch.dist.sharding import (  # noqa: F401
        NullRules, Rules, batch_axes, tree_shardings)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
