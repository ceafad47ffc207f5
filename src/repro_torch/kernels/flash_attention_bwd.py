"""Launch wrapper of the hand-written CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``): the gradient of
:func:`repro_torch.kernels.flash_attention.flash_attention` with respect to
q, k and v, given its output and the output's gradient.  The training path
reaches it through :class:`repro_torch.kernels.ops.FlashAttention`.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.
flash_attention_bwd` sends CPU tensors to the plain version
(:func:`repro_torch.kernels.ref.mha_backward_ref`) instead.  It takes what
the forward wrapper takes: float32 and bfloat16 (summed in fp32 either way,
returned in the inputs' dtype), D in ``HEAD_DIMS``, causal or not (then
``Sq != Skv`` too), ``kv_group``, ``window``, ragged lengths, and strided
q/k/v/o/do views whose last dimension is contiguous; it refuses, with a
message, what the forward refuses.  dk and dv of a KV head sum over its
``kv_group`` query heads in one block, in a fixed order: repeated calls
agree bit for bit.  One call is three kernel launches (the row statistics,
then dK/dV, then dQ) and counts as one.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS

# wrapper calls since the last reset (repro_torch.kernels.ops)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attended_pairs(sq: int, skv: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs one head attends: every pair without a mask, key
    k for query q only where k <= q under ``causal`` and q - k < ``window``
    under a window (0: none)."""
    total = 0
    for q in range(sq):
        hi = min(skv, q + 1) if causal else skv      # keys [lo, hi)
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def work(bh: int, sq: int, skv: int, d: int, kv_group: int, causal: bool,
         window: int = 0, itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of the backward's least work: 10 FLOP per attended
    pair and head dim (Q K^T recomputed, dO V^T, dV, dQ and dK), and q, o,
    do, k, v read once and dq, dk, dv written once."""
    pairs = attended_pairs(sq, skv, causal, window)
    n_kv = bh // kv_group
    flops = 10.0 * bh * pairs * d
    nbytes = itemsize * (4 * bh * sq * d + 4 * n_kv * skv * d)
    return flops, float(nbytes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.repro_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float]
        + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, kv_group: int = 1,
                        window: int = 0):
    """q, o, do [BH, Sq, D], k/v [BH // kv_group, Skv, D] -> (dq [BH, Sq,
    D], dk, dv [BH // kv_group, Skv, D]), contiguous, in ``q.dtype``;
    ``o`` is the forward's output at these inputs and ``do`` its
    gradient."""
    global launches
    ts = (q, k, v, o, do)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"CUDA flash attention backward needs q, k, v, o "
                         f"and do on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dim() != 3 for t in ts) or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash attention backward takes q, o, do [BH,S,D] "
                         f"and k/v [BH/kv_group,S,D], got "
                         f"{[tuple(t.shape) for t in ts]}")
    bh, sq, d = q.shape
    if kv_group < 1 or k.shape[0] * kv_group != bh or k.shape[2] != d:
        raise ValueError(f"k/v rows {k.shape[0]} x kv_group {kv_group} must "
                         f"equal q rows {bh}, with head dim {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"CUDA flash attention backward takes head dim D "
                         f"in {HEAD_DIMS}, got {d}")
    if not 0 <= window < 2 ** 31:
        raise ValueError(f"flash attention backward takes a window in "
                         f"[0, 2^31), got {window}")
    if len({t.dtype for t in ts}) != 1 or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA flash attention backward takes float32 or "
                        f"bfloat16 q/k/v/o/do of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if any(t.stride(2) != 1 for t in ts):
        raise ValueError("flash attention backward needs a contiguous last "
                         "(D) dim")
    skv = k.shape[1]
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if bh == 0 or sq == 0 or skv == 0:   # nothing attended: no gradient
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, bh, sq), dtype=torch.float32, device=q.device)
    strides = [x for t in ts for x in t.stride()[:2]]
    lib = _lib()
    with _build.on_device(q.device):
        err = lib.repro_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv)),
            stats[0].data_ptr(), stats[1].data_ptr(), bh, sq, skv, d,
            kv_group, int(causal), int(window), 1.0 / math.sqrt(d),
            *strides, _DTYPE_CODES[q.dtype],
            _build.raw_stream(q.device))
    _build.check(lib, err, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
