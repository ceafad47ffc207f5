"""Pipeline parallelism over the "pod" axis (differentiable, schedulable);
the port of ``repro.dist.pipeline``.

``pipeline_apply`` runs S stacked stages on the ranks of the mesh's
pipeline axis under a :mod:`repro_torch.dist.schedules` tick plan, as SPMD
code that every rank of the axis calls with the whole stage weights and
the whole input: rank r runs stage chunks c·R + r, microbatches pass from
rank to rank through :func:`~repro_torch.dist.collectives.ring_shift`
(P2P to r + 1, the gradient back to r − 1), and the last rank's outputs
are summed over the axis (:func:`~repro_torch.dist.collectives
.sum_replicated`, a differentiable all-reduce) so every rank returns the
whole output.  The weights and the input enter through
:func:`~repro_torch.dist.collectives.replicated`, so the gradient every
rank gets back is the whole one and every rank can take the same
optimizer step.  Numerics match ``sequential_apply`` for every schedule
(the same ops in the same order per microbatch).

Schedules (``schedule=`` / ``virtual_stages=``):

  * ``gpipe``        — S ranks, one stage each, bubble S-1.
  * ``one_f_one_b``  — same forward order, in-flight capped at min(S, m).
  * ``interleaved``  — S = ranks x V stages, V chunks per rank;
    microbatches recirculate the ring V times.

Each tick is the same program on every rank, the rank entering as data
(``torch.where`` on a rank mask, as the reference's ``jnp.where``): rank 0
takes the fed microbatch (zeros on a bubble tick, never real data), the
others the carry, and the last rank's output is captured.  So every rank
builds the same autograd graph, runs the ring shifts' backward passes in
the same order, and their sends and receives pair up.  The shift after the
last tick, whose result nobody reads, is not made.

When the mesh cannot host the pipeline (no pipeline axis, a stage count
the schedule cannot place on the axis, or a batch the microbatch count
does not divide) ``sequential_apply`` runs instead, the reference's rule.
``stage_params`` is one tensor whose leading dim is the stage.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as col
from repro_torch.dist.schedules import get_schedule
from repro_torch.dist.sharding import mesh_axes


def sequential_apply(stage_fn, stage_params: torch.Tensor, x: torch.Tensor):
    """Reference schedule: fold x through the stacked stages one by one."""
    h = x
    for w in stage_params:
        h = stage_fn(w, h)
    return h


def pipeline_apply(stage_fn, stage_params: torch.Tensor, x: torch.Tensor,
                   mesh, *, microbatches: int = 1, axis: str = "pod",
                   schedule: str = "gpipe", virtual_stages: int = 1):
    """Run ``stage_params`` (leading dim = stages) as a pipeline over the
    ``axis`` ranks of ``mesh``; x [B, ...] with B % microbatches == 0.
    Every rank of the axis calls it with the same arguments and gets the
    whole [B, ...] output."""
    n_stages = stage_params.shape[0]
    batch = x.shape[0]
    sched = get_schedule(schedule)
    shape = mesh_axes(mesh) if mesh is not None else {}
    plan = None
    if sched is not None and axis in shape and batch % microbatches == 0:
        plan = sched.build(n_stages=n_stages, n_ranks=shape[axis],
                           microbatches=microbatches,
                           virtual_stages=virtual_stages)
    if plan is None:
        return sequential_apply(stage_fn, stage_params, x)

    m, n_ranks, v = plan.microbatches, plan.n_ranks, plan.virtual_stages
    group = mesh.get_group(axis)
    rank = dist.get_rank(group)
    first = torch.tensor(rank == 0, device=x.device)
    last = torch.tensor(rank == n_ranks - 1, device=x.device)
    ws = col.replicated(stage_params, [group])
    mb = col.replicated(x, [group]).reshape((m, batch // m) + x.shape[1:])
    chunks = [ws[c * n_ranks + rank] for c in range(v)]  # stage c*R + r
    zero = torch.zeros_like(mb[0])
    carry = zero
    outs = [zero] * m
    # recirculation buffer: rank 0 parks chunk outputs wrapping around the
    # ring until their next pass starts (interleaved only)
    buf = [zero] * m
    for t, tick in enumerate(plan.ticks):
        if tick.stash_buf >= 0:
            buf[tick.stash_buf] = carry
        if tick.feed_mb >= 0:
            feed = mb[tick.feed_mb]
        elif tick.feed_buf >= 0:
            feed = buf[tick.feed_buf]
        else:
            feed = zero             # a bubble or drain tick: no real data
        x_in = torch.where(first, feed, carry)
        c = min(max((t - rank) // plan.entry_stride, 0), v - 1)
        y = stage_fn(chunks[c], x_in)
        if t + 1 < len(plan.ticks):
            carry = col.ring_shift(y, group)
        if tick.capture_out >= 0:
            outs[tick.capture_out] = torch.where(last, y, zero)
    out = col.sum_replicated(torch.stack(outs), group)
    return out.reshape(x.shape)
