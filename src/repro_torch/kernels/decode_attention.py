"""Launch wrapper of the hand-written CUDA split-K decode-attention kernel
(``csrc/decode_attention.cu``), the decode attention of the serving path.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.decode_attention`
sends CPU tensors to the plain version instead.  The cache is read in place
in the serving pool's grouped layout ``[B, S, KV, D]`` (query head ``h``
reads KV head ``h // (H // KV)``), and every row has its own valid length,
because the continuous batcher's slots sit at different positions.  The
TPU kernel's ``[BH, D]`` / ``[BH, S, D]`` form is the case ``H = KV = 1``.
One call is one launch of the kernel pair (split pass + merge pass).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP_WIDTH = 2048          # (H // KV) * D the kernel's block can hold
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.repro_decode_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_int, ctypes.c_void_p])
    lib.repro_decode_attention.restype = ctypes.c_int
    lib.repro_decode_attention_chunk.argtypes = []
    lib.repro_decode_attention_chunk.restype = ctypes.c_int
    return lib


def lens_tensor(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """``cache_len`` (an int, or an int tensor of 1 or ``b`` entries) as a
    contiguous int32 [b] tensor on ``device``."""
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return lens.reshape(-1).expand(b).contiguous()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q [B, H, D]; k/v_cache [B, S, KV, D]; ``cache_len`` int or int
    tensor [B] (each >= 1) -> [B, H, D] in ``q.dtype``."""
    global launches
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"CUDA decode attention needs q and the caches on "
                         f"one CUDA device, got {q.device}, {k_cache.device},"
                         f" {v_cache.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode attention takes q [B,H,D] and caches "
                         f"[B,S,KV,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s_len, kvh, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not group over the cache "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS or (h // kvh) * d > MAX_GROUP_WIDTH:
        raise ValueError(f"CUDA decode attention takes head dim D in "
                         f"{HEAD_DIMS} with (H/KV)*D <= {MAX_GROUP_WIDTH}, "
                         f"got D={d}, H/KV={h // kvh}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA decode attention takes float32 or bfloat16 "
                        f"q/caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("CUDA decode attention takes contiguous q and "
                         "caches")
    lens = lens_tensor(cache_len, b, dev)
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    if b == 0 or h == 0:
        return out
    lib = _lib()
    chunk = lib.repro_decode_attention_chunk()
    n_splits = max(1, -(-s_len // chunk))
    part_m = torch.empty((b * h * n_splits,), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * h * n_splits * d,), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), b, h, kvh, s_len, d,
            n_splits, 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, err, "decode_attention")
    launches += 1
    return out
