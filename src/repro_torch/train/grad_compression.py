"""int8 error-feedback gradient compression: the port of
``repro.train.grad_compression``.

``compressed_psum`` quantizes each gradient leaf to int8 with a per-leaf
scale before the all-reduce, over a ``torch.distributed`` process group in
place of the reference's ``shard_map`` axis, and keeps the quantization
residual in an error-feedback buffer that is added back the next step.  As
in the reference, the ranks agree on the largest scale (``pmax``), each
rank's dequantized leaf is re-rounded to it and summed as int32, and the
re-rounding error joins the residual.  The trees are dicts of tensors
keyed by name.  ``train_step.make_pod_parallel_train_step`` runs it over
the mesh's "pod" group.  The collectives go through
:mod:`repro_torch.dist.collectives`.

A leaf may be a DTensor on a pod's sub-mesh (a partitioned LM's gradient):
each rank then reduces its own shard over the group and gets it back in
the same placements.  The scale is still the whole leaf's (the shards'
maxima reduced over the sub-mesh), as the reference's GSPMD sees the leaf
whole inside its ``shard_map``, so the int8 codes are the reference's; the
error feedback takes the gradient's placements (a whole buffer handed in
is cut to this rank's shard first).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.dist import collectives as col

Tree = Mapping[str, torch.Tensor]


def quantize_int8(x: torch.Tensor, groups: Sequence = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale max|x| / 127 + 1e-12), rounded half to
    even; ``x`` a shard of a leaf split over ``groups``, whose max is
    taken over the whole leaf."""
    xf = x.float()
    top = xf.abs().max()
    for group in groups:
        top = col.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    scale = top / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads: Tree) -> Dict[str, torch.Tensor]:
    """fp32 zeros beside each leaf (a DTensor's in its placements)."""
    return {k: torch.zeros_like(g, dtype=torch.float32, requires_grad=False)
            for k, g in grads.items()}


def _shard(g: torch.Tensor, ef: Optional[torch.Tensor] = None):
    """(``g``'s local shard, ``ef``'s part of it, a function that wraps a
    local tensor in ``g``'s placements, the groups ``g`` is split over).
    A plain ``g`` is its own shard; ``ef`` a DTensor is redistributed to
    ``g``'s placements, a whole buffer cut to this rank's shard, a scalar
    kept (it broadcasts)."""
    if not isinstance(g, DTensor):
        return g, ef, lambda t: t, ()
    mesh, placements = g.device_mesh, g.placements
    if isinstance(ef, DTensor):
        ef = ef.redistribute(mesh, placements).to_local()
    elif ef is not None and ef.dim():
        ef = distribute_tensor(ef.to(g.device), mesh, placements,
                               src_data_rank=None).to_local()

    def wrap(t: torch.Tensor) -> DTensor:
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=g.shape, stride=g.stride())

    groups = tuple(mesh.get_group(i) for i, p in enumerate(placements)
                   if isinstance(p, Shard))
    return g.to_local(), ef, wrap, groups


def compressed_psum(grads: Tree, ef_state: Tree,
                    group: Optional[dist.ProcessGroup] = None):
    """All-reduce ``grads`` over ``group`` (default: the world) in int8
    with error feedback: returns (summed fp32 grads, new error
    feedback), each leaf in its gradient's placements."""
    reduced, new_ef = {}, {}
    for name, g in grads.items():
        local, ef, wrap, shards = _shard(g, ef_state[name])
        gf = local.float() + ef
        q, scale = quantize_int8(gf, shards)
        deq = dequantize_int8(q, scale)
        scale_max = col.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q_rescaled = torch.round(deq / scale_max).to(torch.int32)
        total = col.all_reduce(q_rescaled, group=group)
        reduced[name] = wrap(total.float() * scale_max)
        # the quantization residual, and the rescaling error folded in
        new_ef[name] = wrap((gf - deq)
                            + (deq - q_rescaled.float() * scale_max))
    return reduced, new_ef


def plain_psum(grads: Tree, group: Optional[dist.ProcessGroup] = None
               ) -> Dict[str, torch.Tensor]:
    """``grads`` summed over ``group``, each rank its own shard."""
    out: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        local, _, wrap, _ = _shard(g)
        out[name] = wrap(col.all_reduce(local, group=group))
    return out
