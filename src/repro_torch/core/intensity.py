"""FPGA-analogue narrowing (paper [40], §III.A), the port of
``repro.core.intensity``: before any expensive kernel "synthesis",
candidates are narrowed by arithmetic intensity and loop count, then by
resource efficiency; only a handful of patterns are measured.

The resource budget is the Hopper adaptation of the FPGA's LUT/DSP count
(the JAX package used the TPU's VMEM): the H100's 50 MB L2 cache, the
largest on-chip store a nest's working set can stay in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core import graph_tools
from repro_torch.core.offloadable import LoopNest, OffloadableApp

L2_BUDGET_BYTES = 50 * 1000 * 1000


@dataclass
class NestProfile:
    nest: LoopNest
    flops: float
    bytes: float
    intensity: float        # FLOPs / byte
    resource: float         # working-set bytes (on-chip proxy)
    efficiency: float       # intensity / resource
    fits_on_chip: bool


def profile_nests(app: OffloadableApp, small_state) -> List[NestProfile]:
    """Profile each nest on the state it actually receives (nests are a
    chain: the recorded ``seq`` run of one nest feeds the next)."""
    out = []
    state = dict(small_state)
    for nest in app.nests:
        try:
            tr = graph_tools.trace(nest.impls["seq"], state)
            fl, by = tr.flops, tr.bytes
            state = tr.output
        except Exception:
            fl, by = 0.0, 1.0
        by = max(by, 1.0)
        inten = fl / by
        res = by
        out.append(NestProfile(
            nest=nest, flops=fl, bytes=by, intensity=inten, resource=res,
            efficiency=inten / max(res, 1.0),
            fits_on_chip=res <= L2_BUDGET_BYTES))
    return out


def narrow(app: OffloadableApp, small_state, top_intensity: int = 5,
           top_efficiency: int = 3) -> List[NestProfile]:
    """Paper's two-stage narrowing: arithmetic intensity + loop count first,
    then resource efficiency — returns <= top_efficiency candidates."""
    profiles = profile_nests(app, small_state)
    # stage 1: intensity * loop-count ranking (paper: "arithmetic intensity
    # and loop count with ROSE and gcov")
    stage1 = sorted(profiles,
                    key=lambda p: p.intensity * max(p.nest.trip_count, 1),
                    reverse=True)[:top_intensity]
    # stage 2: resource efficiency
    stage2 = sorted(stage1, key=lambda p: p.efficiency,
                    reverse=True)[:top_efficiency]
    return stage2


def fpga_patterns(candidates: List[NestProfile]) -> List[tuple]:
    """Paper §III.A: measure the top-3 single-nest patterns, then one combo
    of the two best performers => at most 4 measured patterns.

    Returns a list of tuples of nest names; the combo is appended by the
    caller after the singles are measured.
    """
    return [(p.nest.name,) for p in candidates]
