"""Collectives for the port's SPMD code, where each rank runs the same
program on its part of the work and holds whole every value the reference
keeps replicated (``P()`` in a ``shard_map``): the parameters, the inputs,
the gathered outputs and the loss.

Under that convention the loss is one loss, held by every rank, not one
per rank, and the autograd functions here differentiate it as such
(``torch.distributed.nn.functional``'s collectives sum each rank's
cotangent, which would count a replicated loss once per rank):

  * :func:`sum_replicated` — all-reduce (sum) forward, identity backward:
    per-rank partials -> a replicated total (the reference's ``psum`` of a
    value leaving the ``shard_map`` replicated);
  * :func:`gather_replicated` — all-gather along dim 0 forward, this rank's
    slice of the cotangent backward;
  * :func:`replicated` — identity forward, all-reduce (sum) of the
    gradient backward over each group in turn: a replicated input whose
    uses are split between ranks gets its whole gradient on every rank;
  * :func:`sum_partials` — all-reduce (sum) forward and backward: per-rank
    partials -> a total that each rank uses for its own part of the work
    (a norm's sum of squares over a width the ranks split), so its
    gradient is the sum of every rank's;
  * :func:`ring_shift` — sends to the next rank of the group and receives
    from the previous one (``dist.batch_isend_irecv``); its gradient goes
    the other way (the reference's ``ppermute`` and its transpose).

A ``group`` of None is no group: the value is whole on this rank and
:func:`sum_replicated` and :func:`max_replicated` return it as it is.

Each collective runs on the group's backend.  Two ranks on one card need
gloo (NCCL refuses two ranks on one device).  Gloo reduces and gathers
card tensors itself, but takes none for its point-to-point ops: there
:func:`shift` moves a card tensor through host memory and back (transport
only; the computation stays on the card), and :func:`staged_ops` counts
each such call.  DTensor gathers a shard through the functional
``all_gather_into_tensor``, which gloo does not survive on a card tensor
(the process dies); :func:`stage_card_gathers` routes that op's card
tensors through host memory too, counted the same way.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

import torch
import torch.distributed as dist

_STAGED: Counter = Counter()
_GATHER_LIB = None      # the CUDA kernel of the staged functional all-gather


def staged_ops() -> Dict[str, int]:
    """Op name -> calls this process staged through host memory."""
    return dict(_STAGED)


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group``."""
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _staged_all_gather(inp: torch.Tensor, group_size: int,
                       group_name: str) -> torch.Tensor:
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    if dist.get_backend(group) != "gloo":
        raise RuntimeError(f"the staged all-gather serves gloo groups, "
                           f"{group_name} is {dist.get_backend(group)}")
    _STAGED["all_gather_into_tensor"] += 1
    return all_gather(inp.detach().to("cpu"), group).to(inp.device)


def stage_card_gathers() -> None:
    """From now on, in this process, the functional all-gather
    (``torch.ops._c10d_functional.all_gather_into_tensor``, what DTensor
    gathers a shard with) moves a card tensor through host memory over a
    gloo group, and raises over any other backend.  Called when a card
    mesh is built over gloo (``launch.mesh``); idempotent."""
    global _GATHER_LIB
    if _GATHER_LIB is None:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _staged_all_gather, "CUDA")
        _GATHER_LIB = lib


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in group-rank
    order."""
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


def shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """What the rank ``step`` places before this one in the group sent:
    each rank sends ``t`` to group rank ``(r + step) % n``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.detach().clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    if host:
        _STAGED["send/recv"] += 1
    send = (t.detach().to("cpu") if host else t.detach()).contiguous()
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group=group),
            dist.P2POp(dist.irecv, recv, src, group=group)]):
        work.wait()
    return recv.to(t.device) if host else recv


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.me = dist.get_rank(group)
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.me * ctx.rows:(ctx.me + 1) * ctx.rows], None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = all_reduce(g, group=group)
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


def sum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumReplicated.apply(x, group)


def max_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group``, detached (a stabiliser, as a
    log-sum-exp's shift, carries no gradient)."""
    x = x.detach()
    return x if group is None else all_reduce(x, dist.ReduceOp.MAX, group)


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherReplicated.apply(x, group)


def replicated(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    return _Replicated.apply(x, tuple(groups))


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    return (x if group is None
            else replicated(sum_replicated(x, group), (group,)))


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    return _RingShift.apply(x, group)

