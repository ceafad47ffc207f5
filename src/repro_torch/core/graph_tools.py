"""Recorded op sequences and Deckard-style structural fingerprints, the port
of ``repro.core.jaxpr_tools``.

The paper's function-block discovery [41] uses DB name matching plus Deckard
(AST clone detection).  The PyTorch analogue of a jaxpr is the sequence of
aten ops a function really executes: :func:`trace` runs it under a
``TorchDispatchMode`` that records every op, so Python loops unroll on their
own, as scan bodies are multiplied by their trip count in the JAX package.
Fingerprints are hashed n-grams of that sequence (op names with output
ranks) and similarity is Jaccard over fingerprint sets.

Cost rules, as in the JAX package: a matrix product or convolution counts
2 x output elements x reduction length, every other op the element count of
its output; bytes are the inputs the function actually reads plus the
outputs it produces (pass-through state excluded).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, List, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# aten ops counted as products: the reduction length is the last dim of
# the operand at this argument position
_PRODUCT_OPERAND = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
                    "addmm": 1, "baddbmm": 1, "addmv": 1, "addbmm": 1}


def _numel(t: torch.Tensor) -> float:
    return float(t.numel() or 1)


@dataclass
class Op:
    name: str                       # aten overload packet, e.g. "mm"
    ranks: Tuple[int, ...]          # ranks of the tensor outputs
    flops: float


@dataclass
class OpTrace:
    """What one call of a function executed."""
    ops: List[Op] = field(default_factory=list)
    bytes: float = 0.0
    output: Any = None

    @property
    def flops(self) -> float:
        return sum(op.flops for op in self.ops)

    def sequence(self, with_shapes: bool = False) -> List[str]:
        """Op-name sequence; shapes abstracted to ranks."""
        if not with_shapes:
            return [op.name for op in self.ops]
        return [f"{op.name}#{','.join(map(str, op.ranks))}"
                for op in self.ops]


def _op_flops(name: str, args, outs: List[torch.Tensor]) -> float:
    if not outs:
        return 0.0
    if name in _PRODUCT_OPERAND:
        operand = args[_PRODUCT_OPERAND[name]]
        return 2.0 * _numel(outs[0]) * float(operand.shape[-1] or 1)
    if name in ("convolution", "_convolution"):
        weight = args[1]
        return 2.0 * _numel(outs[0]) * float(
            math.prod(weight.shape[1:]) or 1)
    return _numel(outs[0])


class _Recorder(TorchDispatchMode):
    def __init__(self, inputs: Sequence[torch.Tensor]):
        super().__init__()
        self.ops: List[Op] = []
        self._inputs = {id(t) for t in inputs}
        self.used: Set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and id(t) in self._inputs:
                self.used.add(id(t))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        name = func.overloadpacket.__name__
        self.ops.append(Op(name, tuple(t.dim() for t in outs),
                           _op_flops(name, args, outs)))
        return out


def trace(fn, *args) -> OpTrace:
    """Run ``fn(*args)`` once, recording every aten op it executes."""
    inputs = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    rec = _Recorder(inputs)
    with torch.no_grad(), rec:
        out = fn(*args)
    by_id = {id(t): t for t in inputs}
    total = sum(_numel(by_id[i]) * by_id[i].element_size() for i in rec.used)
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and id(t) not in by_id:
            total += _numel(t) * t.element_size()
    return OpTrace(ops=rec.ops, bytes=float(total), output=out)


def fingerprint(seq: Sequence[str], n: int = 3) -> Set[int]:
    """Hashed n-grams of the op sequence (Deckard vector analogue)."""
    if len(seq) < n:
        return {hash(tuple(seq))}
    return {hash(tuple(seq[i:i + n])) for i in range(len(seq) - n + 1)}


def similarity(fp_a: Set[int], fp_b: Set[int]) -> float:
    """Jaccard similarity of two fingerprint sets in [0, 1]."""
    if not fp_a or not fp_b:
        return 0.0
    return len(fp_a & fp_b) / len(fp_a | fp_b)


def fn_fingerprint(fn, *example_args, n: int = 3) -> Set[int]:
    return fingerprint(trace(fn, *example_args).sequence(with_shapes=True),
                       n=n)
