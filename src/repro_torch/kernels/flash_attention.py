"""Launch wrapper of the hand-written CUDA flash-attention kernels
(``csrc/flash_attention.cu``), the prefill attention of the serving path:
bfloat16 runs on the tensor cores (wgmma tiles fed by TMA), float32 on the
CUDA cores (fp32 FMAs, so the fp32 contract holds without TF32).

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.flash_attention`
sends CPU tensors to the plain version instead.  The TPU signature is kept
(``q, k, v [BH, S, D]``), with ``kv_group`` added for grouped-query
attention: row ``bh`` of ``q`` reads K/V row ``bh // kv_group``, so the
model's KV heads are never repeated per query head.  ``window`` > 0 keeps
only keys with ``qpos - kpos < window`` (h2o-danube's sliding window; the
TPU kernel had none, the JAX layers mask it in jnp), and the walk skips the
key tiles left of every row's window.  ``softcap`` > 0 caps each scaled
score at ``c tanh(s / c)`` before the mask, and ``q_offset`` puts query row
``i`` at position ``i + q_offset`` for the causal and window compares (the
JAX ``dense_attention``'s arguments; its Pallas kernel had neither).  The
three run in one general kernel (``GENERAL`` in the sources, forward and
backward); without any of them the launch is the kernel it always was.  Ragged ``S`` is masked in the kernel
(the TPU wrapper asserted ``S % block == 0``), and q/k/v may be strided
views as long as their last dimension is contiguous.  The bf16 kernel reads
them through TMA tensor maps, which need 16-byte aligned base addresses and
row/head strides; a view that breaks that raises, it never takes another
path.  D = 80 runs the bf16 kernel's D = 128 tile, with TMA zero-filling the
columns past 80.  D = 256 (recurrentgemma) runs a tile of its own: 64 keys a
tile in a 2-stage ring (``csrc/flash_attention.cu`` ``Tile<256>``).

Training passes ``lse``, an out buffer for each row's log-sum-exp, which
the backward (:mod:`repro_torch.kernels.flash_attention_bwd`) reads in
place of a recompute; serving passes none and gets the same output bits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                   # a block's threads, both routes
BF16_ROWS = 128                 # query rows a tensor-core block (2 x 64)
F32_ROWS, F32_KEYS = 64, 32     # the CUDA-core block's rows and key tile
MAX_POS = 2 ** 30               # a window or query offset is below it


def check_masks(window: int, q_offset: int, softcap: float,
                what: str = "flash attention") -> None:
    """Raise ``ValueError`` for a window or query offset outside
    ``[0, 2^30)`` or a soft cap that is not a finite value >= 0, as the
    kernels refuse them."""
    if not 0 <= window < MAX_POS:
        raise ValueError(f"{what} takes a window in [0, 2^30), got {window}")
    if not 0 <= q_offset < MAX_POS:
        raise ValueError(f"{what} takes a query offset in [0, 2^30), got "
                         f"{q_offset}")
    if not (math.isfinite(softcap) and softcap >= 0):
        raise ValueError(f"{what} takes a soft cap >= 0 (0: none), got "
                         f"{softcap}")


def kv_ring(d: int) -> tuple[int, int]:
    """(keys a K/V tile, stages of the K/V ring) of the bf16 kernel at head
    dim ``d``, as ``Tile<D>`` in ``csrc/flash_attention.cu`` sets them:
    128-key tiles in 3 stages, 2 stages from D = 128 (D = 80 runs the
    D = 128 tile), 64-key tiles at D = 256.  :func:`_lib` holds them to the
    kernel's own when it loads."""
    width = 128 if d == 80 else d
    return (64 if width == 256 else 128), (2 if width >= 128 else 3)


class FlashPlan(NamedTuple):
    """The forward's launch at one shape, as ``csrc/flash_attention.cu``
    makes it."""
    route: str           # "wgmma" (tensor cores) or "cuda-cores"
    grid: Tuple[int, int, int]
    threads: int
    rows: int            # query rows a block
    keys: int            # keys a K/V tile
    stages: int          # stages of the K/V ring (0: staged by plain loads)
    smem: int            # dynamic shared memory bytes a block


def plan(bh: int, sq: int, d: int, dtype: torch.dtype) -> FlashPlan:
    """The launch for q [bh, sq, d] of ``dtype``.  bf16: a 1-D grid of
    ``ceil(sq / 128) * bh`` blocks of 256 threads (two consumer
    warpgroups of 64 rows), block x taking head ``x % bh`` and the
    ``x // bh``-th query tile from the last (the longest causal walks
    first); its Q tile, then :func:`kv_ring` stages of a K and a V tile,
    behind 1024 bytes of alignment slack and ``2 * stages + 1``
    mbarriers.  fp32: a ``(ceil(sq / 64), bh)`` grid of 256 threads; Q
    and K tiles with padded rows, a V tile, the 64 x 32 scores (padded)
    and three per-row statistics, in fp32."""
    if d not in HEAD_DIMS or dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention takes D in {HEAD_DIMS} and "
                         f"float32 or bfloat16, got D={d}, {dtype}")
    if dtype == torch.bfloat16:
        width = 128 if d == 80 else d
        keys, stages = kv_ring(d)
        smem = (1024 + BF16_ROWS * width * 2 + stages * 2 * keys * width * 2
                + 8 * (2 * stages + 1))
        return FlashPlan("wgmma", (-(-sq // BF16_ROWS) * bh, 1, 1), THREADS,
                         BF16_ROWS, keys, stages, smem)
    floats = (F32_ROWS * (d + 1) + F32_KEYS * (d + 1) + F32_KEYS * d
              + F32_ROWS * (F32_KEYS + 1) + 3 * F32_ROWS)
    return FlashPlan("cuda-cores", (-(-sq // F32_ROWS), bh, 1), THREADS,
                     F32_ROWS, F32_KEYS, 0, 4 * floats)


def work(bh: int, sq: int, skv: int, d: int, kv_group: int, causal: bool,
         window: int = 0, itemsize: int = 2, lse: bool = False,
         q_offset: int = 0) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch: 4 FLOP per attended (query, key) pair
    and head dim (``flash_attention_bwd.attended_pairs`` counts the causal
    and window masks at the query offset), q, k, v read once and o written
    once (and, with ``lse``, the fp32 log-sum-exps).  A soft cap adds no
    FLOP here: its tanh is a transcendental, as the exponential is.  The
    bound in PERF.md and the modeled cost
    (``repro_torch.core.trace_analysis``) both take it."""
    from repro_torch.kernels.flash_attention_bwd import attended_pairs
    pairs = attended_pairs(sq, skv, causal, window, q_offset)
    n_kv = bh // kv_group
    nbytes = itemsize * (2 * bh * sq * d + 2 * n_kv * skv * d)
    return 4.0 * bh * pairs * d, float(nbytes + (4 * bh * sq if lse else 0))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.repro_flash_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
        + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_flash_attention_kv_ring.argtypes = [ctypes.c_int] * 2
    lib.repro_flash_attention_kv_ring.restype = ctypes.c_int
    for d in HEAD_DIMS:
        if tuple(lib.repro_flash_attention_kv_ring(d, what)
                 for what in (0, 1)) != kv_ring(d):
            raise RuntimeError(f"csrc/flash_attention.cu's K/V ring at "
                               f"D={d} differs from kv_ring")
    return lib


def _tma_strides(t: torch.Tensor, what: str = "bf16 flash attention "
                 "loads q/k/v"):
    """(head, row) strides of a [N, S, D] view for its tensor map: a dim of
    size 1 is never stepped, so its stride is replaced by a dense one.
    Raises, naming ``what``, where TMA cannot take the view."""
    n, s, d = t.shape
    ss = t.stride(1) if s > 1 else d
    sb = t.stride(0) if n > 1 else s * ss
    if t.data_ptr() % 16 or (sb * t.element_size()) % 16 \
            or (ss * t.element_size()) % 16:
        raise ValueError(
            f"{what} by TMA, which needs 16-byte aligned base addresses and "
            f"strides; got a view at address {t.data_ptr():#x} with "
            f"head/row strides ({sb}, {ss}) elements")
    return sb, ss


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_group: int = 1, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    lse: torch.Tensor | None = None) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH // kv_group, Skv, D] -> [BH, Sq, D] in
    ``q.dtype``; scale ``1/sqrt(D)``, fp32 softmax carries; ``window`` 0 is
    no window, ``softcap`` 0 no cap, ``q_offset`` the first query row's
    position.

    ``lse``, a contiguous float32 [BH, Sq] on q's device, receives each
    row's log-sum-exp in base 2, L2 = log2(sum_k exp(s_qk)) over the keys
    the row attends (s = scale q k^T, capped under a cap), the units in
    which the backward
    exponentiates (P = exp2(scale log2(e) s - L2)); a row that attends no
    key gets 0 (:func:`repro_torch.kernels.ref.mha_ref` with
    ``return_lse=True`` gives the same)."""
    global launches
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"CUDA flash attention needs q, k and v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q [BH,S,D] and k/v "
                         f"[BH/kv_group,S,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if kv_group < 1 or k.shape[0] * kv_group != bh or k.shape[2] != d:
        raise ValueError(f"k/v rows {k.shape[0]} x kv_group {kv_group} must "
                         f"equal q rows {bh}, with head dim {d}")
    if d not in HEAD_DIMS:
        raise ValueError(f"CUDA flash attention takes head dim D in "
                         f"{HEAD_DIMS}, got {d}")
    check_masks(window, q_offset, softcap)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA flash attention takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if any(t.stride(2) != 1 for t in (q, k, v)):
        raise ValueError("flash attention needs a contiguous last (D) dim")
    if lse is not None and (lse.shape != (bh, sq)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"flash attention's lse must be a contiguous "
                         f"float32 [{bh}, {sq}] on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if q.dtype == torch.bfloat16:
        strides = [x for t in (q, k, v) for x in _tma_strides(t)]
    else:
        strides = [x for t in (q, k, v) for x in t.stride()[:2]]
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    if bh == 0 or sq == 0:
        return out
    if k.shape[1] == 0:         # softmax over no keys: the plain version's 0
        if lse is not None:
            lse.zero_()
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq,
            k.shape[1], d, kv_group, int(causal), int(window), int(q_offset),
            1.0 / math.sqrt(d), float(softcap),
            *strides, _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return out
