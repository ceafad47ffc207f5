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
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist import collectives as col

Tree = Mapping[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 scale max|x| / 127 + 1e-12), rounded half to
    even."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(grads: Tree) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compressed_psum(grads: Tree, ef_state: Tree,
                    group: Optional[dist.ProcessGroup] = None):
    """All-reduce ``grads`` over ``group`` (default: the world) in int8
    with error feedback: returns (summed fp32 grads, new error
    feedback)."""
    reduced, new_ef = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef_state[name]
        q, scale = quantize_int8(gf)
        deq = dequantize_int8(q, scale)
        scale_max = col.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        q_rescaled = torch.round(deq / scale_max).to(torch.int32)
        total = col.all_reduce(q_rescaled, group=group)
        reduced[name] = total.float() * scale_max
        # the quantization residual, and the rescaling error folded in
        new_ef[name] = (gf - deq) + (deq - q_rescaled.float() * scale_max)
    return reduced, new_ef


def plain_psum(grads: Tree, group: Optional[dist.ProcessGroup] = None
               ) -> Dict[str, torch.Tensor]:
    return {name: col.all_reduce(g, group=group)
            for name, g in grads.items()}
