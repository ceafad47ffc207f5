"""Launch wrapper of the hand-written CUDA flash-attention backward
(``csrc/flash_attention_bwd.cu``): the gradient of
:func:`repro_torch.kernels.flash_attention.flash_attention` with respect to
q, k and v, given its output, the output's gradient and the row
log-sum-exps the forward saved (its ``lse``).  The training path reaches it
through :class:`repro_torch.kernels.ops.FlashAttention`.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.
flash_attention_bwd` sends CPU tensors to the plain version
(:func:`repro_torch.kernels.ref.mha_backward_ref`) instead.  It takes what
the forward wrapper takes: float32 and bfloat16 (summed in fp32 either way,
returned in the inputs' dtype), D in ``HEAD_DIMS``, causal or not (then
``Sq != Skv`` too), ``kv_group``, ``window``, ``softcap`` (the gradient
of the capped scores times the cap's derivative ``1 - tanh^2``),
``q_offset``, ragged lengths, and strided
q/k/v/o/do views whose last dimension is contiguous; it refuses, with a
message, what the forward refuses.  bf16 runs on the tensor cores
(``wgmma`` fed by TMA: bases and strides of q, k, v, o and do must be
16-byte aligned, as the forward's; at D = 256 the block's two warpgroups
split the head dim and exchange P and dS through shared memory), fp32 on
the CUDA cores (:func:`plan` says which, and with what tiles).  dk and dv
of a KV head sum over its ``kv_group`` query heads in a fixed order, in one
block (at D = 256 in several, each with a share of the heads
(:func:`heads_per_block`), whose fp32 partials the key tile's last block
adds up in split order): repeated calls agree bit for bit.  One call is
three kernel launches (Delta, then dK/dV, then dQ) and counts as one.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (HEAD_DIMS, _tma_strides,
                                                 check_masks)

# wrapper calls since the last reset (repro_torch.kernels.ops)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 head dims that run on the tensor cores (D = 80 on the D = 128 tile;
# D = 256 on a tile of its own, the head dim split between the warpgroups)
WGMMA_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# the D = 256 tile's exchange: a warpgroup's 64 x 64 fp32 score fragment
EXCHANGE_BYTES = 64 * 64 * 4
# the D = 256 route splits a KV head's group over dK/dV blocks until its
# grid holds about this many waves of the card's SMs
SPLIT_WAVES = 4
SMS = 132                       # H100 SXM: the plans' default
# rows of a tile of the Delta / L2 scratch
STAT_ROWS = 64
# the largest dynamic shared memory a block may opt into on the H100
SMEM_LIMIT = 232448


class Plan(NamedTuple):
    """The backward's launch plan at one head dim and dtype, as
    ``csrc/flash_attention_bwd.cu`` compiles it."""
    route: str          # "wgmma" (tensor cores) or "cuda-cores"
    dkdv_keys: int      # keys a dK/dV block
    dkdv_rows: int      # query rows a tile of its walk
    dkdv_stages: int    # stages of its Q/dO ring (0: staged by plain loads)
    dkdv_smem: int      # its shared-memory bytes
    dq_rows: int        # query rows a dQ block
    dq_keys: int        # keys a tile of its walk
    dq_stages: int      # stages of its K/V ring (0: staged by plain loads)
    dq_smem: int        # its shared-memory bytes


def plan(d: int, dtype: torch.dtype) -> Plan:
    """The backward's tiles, ring stages and shared memory at head dim ``d``
    and ``dtype`` (``Wg<DT>``, ``W256`` and ``Cfg<D>`` in the source).
    Tensor cores: 128 keys a dK/dV block over 64-row Q/dO tiles in a ring
    of 4 stages (3 from D = 128), 128 rows a dQ block over K/V tiles of 128
    keys (64 from D = 128) in 3 stages, D = 80 on the D = 128 tile; at D =
    256 64 keys a dK/dV block and 64 rows a dQ block (both warpgroups on
    them, each with half of D) over 64-row tiles in 2 stages, beside the
    warpgroups' exchange.  CUDA cores (fp32): 64-row and 64-key tiles (32 at
    D = 256) staged as fp32 with padded rows."""
    if d not in HEAD_DIMS or dtype not in _DTYPE_CODES:
        raise ValueError(f"the flash backward takes D in {HEAD_DIMS} and "
                         f"float32 or bfloat16, got D={d}, {dtype}")
    if dtype == torch.bfloat16 and d == 256:
        tile, stages, bars = 64 * d * 2, 2, 8 * 5
        dkdv = (1024 + 2 * tile + stages * (2 * tile + 2 * STAT_ROWS * 4)
                + EXCHANGE_BYTES + bars)
        dq = 1024 + 2 * tile + stages * 2 * tile + EXCHANGE_BYTES + bars
        return Plan("wgmma", 64, STAT_ROWS, stages, dkdv, 64, 64, stages, dq)
    if dtype == torch.bfloat16:
        dt = 128 if d == 80 else d
        stages = 3 if dt >= 128 else 4
        keys = 64 if dt >= 128 else 128
        dkdv = (1024 + 2 * 128 * dt * 2
                + stages * (2 * STAT_ROWS * dt * 2 + 2 * STAT_ROWS * 4)
                + 8 * (2 * stages + 1))
        dq = 1024 + 2 * 128 * dt * 2 + 3 * 2 * keys * dt * 2 + 8 * 7
        return Plan("wgmma", 128, STAT_ROWS, stages, dkdv, 128, keys, 3, dq)
    bq = 32 if d == 256 else 64
    row, score = d + 1, bq + 1
    dkdv = 4 * (4 * bq * row + 2 * bq * score + 2 * bq)
    dq = 4 * (4 * bq * row + bq * score + 2 * bq)
    return Plan("cuda-cores", bq, bq, 0, dkdv, bq, bq, 0, dq)


def heads_per_block(d: int, dtype: torch.dtype, bh: int, skv: int,
                    kv_group: int, sms: int = SMS) -> int:
    """Query heads of a KV head's group that one dK/dV block walks: the
    whole group, but on the bf16 D = 256 route, whose 64-key blocks would
    leave the card's SMs short at a small KV head count; there the group
    splits over ceil(kv_group / heads) blocks until the grid holds about
    ``SPLIT_WAVES`` waves of ``sms`` (each block's fp32 sums merged in
    order by the key tile's last block)."""
    if dtype != torch.bfloat16 or d != 256:
        return kv_group
    blocks = -(-skv // plan(d, dtype).dkdv_keys) * (bh // kv_group)
    split = min(kv_group, -(-SPLIT_WAVES * sms // max(blocks, 1)))
    return -(-kv_group // split)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    """The SMs of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def attended_pairs(sq: int, skv: int, causal: bool, window: int = 0,
                   q_offset: int = 0) -> int:
    """(query, key) pairs one head attends: every pair without a mask, key
    k for query q only where k <= q under ``causal`` and q - k < ``window``
    under a window (0: none), query row i at position q = i +
    ``q_offset``."""
    total = 0
    for q in range(q_offset, q_offset + sq):
        hi = min(skv, q + 1) if causal else skv      # keys [lo, hi)
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def work(bh: int, sq: int, skv: int, d: int, kv_group: int, causal: bool,
         window: int = 0, itemsize: int = 2, q_offset: int = 0) -> tuple:
    """(FLOPs, bytes) of the backward's least work: 10 FLOP per attended
    pair and head dim (Q K^T recomputed, dO V^T, dV, dQ and dK), and q, o,
    do, k, v read once and dq, dk, dv written once.  (The tensor-core
    design does 14: dQ recomputes Q K^T and dO V^T.)"""
    pairs = attended_pairs(sq, skv, causal, window, q_offset)
    n_kv = bh // kv_group
    flops = 10.0 * bh * pairs * d
    nbytes = itemsize * (4 * bh * sq * d + 4 * n_kv * skv * d)
    return flops, float(nbytes)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    lib.repro_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
        + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
    lib.repro_flash_attention_bwd.restype = ctypes.c_int
    lib.repro_flash_attention_bwd_plan.argtypes = [ctypes.c_int] * 3
    lib.repro_flash_attention_bwd_plan.restype = ctypes.c_int
    for dtype, code in _DTYPE_CODES.items():
        for d in HEAD_DIMS:
            built = tuple(lib.repro_flash_attention_bwd_plan(d, code, what)
                          for what in range(9))
            want = plan(d, dtype)
            want = (int(want.route == "wgmma"), *want[1:])
            if built != want:
                raise RuntimeError(
                    f"csrc/flash_attention_bwd.cu's plan at D={d} {dtype} "
                    f"is {built}, kernels/flash_attention_bwd.plan says "
                    f"{want}")
    return lib


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, kv_group: int = 1,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """q, o, do [BH, Sq, D], k/v [BH // kv_group, Skv, D], lse float32
    [BH, Sq] -> (dq [BH, Sq, D], dk, dv [BH // kv_group, Skv, D]),
    contiguous, in ``q.dtype``; ``o`` is the forward's output at these
    inputs, ``lse`` the log-sum-exp it saved (base 2, see
    :func:`repro_torch.kernels.flash_attention.flash_attention`) and ``do``
    the output's gradient."""
    global launches
    ts = (q, k, v, o, do)
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (*ts, lse)):
        raise ValueError(f"CUDA flash attention backward needs q, k, v, o, "
                         f"do and lse on one CUDA device, got "
                         f"{[str(t.device) for t in (*ts, lse)]}")
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
    check_masks(window, q_offset, softcap, "flash attention backward")
    if len({t.dtype for t in ts}) != 1 or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA flash attention backward takes float32 or "
                        f"bfloat16 q/k/v/o/do of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash attention backward takes the forward's lse "
                         f"as a contiguous float32 [{bh}, {sq}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.stride(2) != 1 for t in ts):
        raise ValueError("flash attention backward needs a contiguous last "
                         "(D) dim")
    if q.dtype == torch.bfloat16:
        strides = [x for t in ts for x in _tma_strides(
            t, "the bf16 flash backward loads q/k/v/o/do")]
    else:
        strides = [x for t in ts for x in t.stride()[:2]]
    skv = k.shape[1]
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if bh == 0 or sq == 0 or skv == 0:   # nothing attended: no gradient
        return dq.zero_(), dk.zero_(), dv.zero_()
    # per 64-row tile: its rows' L2, then their Delta (zero past Sq)
    stats = torch.empty((bh, -(-sq // STAT_ROWS), 2, STAT_ROWS),
                        dtype=torch.float32, device=q.device)
    # the D = 256 route's split group: each block's fp32 dK and dV, and a
    # merge counter a key tile (zeroed by the kernels' first launch)
    hpb = heads_per_block(d, q.dtype, bh, skv, kv_group,
                          _sms(q.device))
    part = counters = None
    if hpb < kv_group:
        keys = plan(d, q.dtype).dkdv_keys
        tiles = bh // kv_group * -(-skv // keys)
        part = torch.empty((tiles, -(-kv_group // hpb), 2, keys, d),
                           dtype=torch.float32, device=q.device)
        counters = torch.empty(tiles, dtype=torch.int32, device=q.device)
    lib = _lib()
    with _build.on_device(q.device):
        err = lib.repro_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                     stats)),
            *(None if t is None else t.data_ptr() for t in (part, counters)),
            bh, sq, skv, d, kv_group, int(causal), int(window), int(q_offset),
            hpb, 1.0 / math.sqrt(d), float(softcap), *strides,
            _DTYPE_CODES[q.dtype], _build.raw_stream(q.device))
    _build.check(lib, err, "flash_attention_bwd")
    launches += 1
    return dq, dk, dv
