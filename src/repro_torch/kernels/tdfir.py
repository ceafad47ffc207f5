"""Launch wrapper of the hand-written CUDA tdFIR kernel (``csrc/tdfir.cu``),
the paper's function-block offload target on the FPGA-analogue destination.

y[f, n] = sum_k h[f, k] * x[f, n - k]   (causal, per-filter bank)

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.tdfir` sends CPU
tensors to the plain version instead.  Complex data stays planar re/im and
:func:`tdfir_complex` stays four real launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

MAX_TILE = 1024                    # threads per block
SMEM_LIMIT_BYTES = 48 * 1024       # shared memory of a default launch


def _lib() -> ctypes.CDLL:
    lib = _build.load("tdfir")
    lib.repro_tdfir.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p])
    lib.repro_tdfir.restype = ctypes.c_int
    return lib


def tdfir(x: torch.Tensor, h: torch.Tensor, *,
          block_n: int = 512) -> torch.Tensor:
    """x [F, N] float32, h [F, K] float32 -> y [F, N] (causal FIR).

    ``block_n`` is the number of output samples per block (capped at N);
    unlike the TPU kernel it need not cover the K taps.
    """
    global launches
    if x.device.type != "cuda" or h.device != x.device:
        raise ValueError(f"CUDA tdfir needs x and h on one CUDA device, got "
                         f"{x.device} and {h.device}")
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"tdfir shapes x {tuple(x.shape)}, h "
                         f"{tuple(h.shape)}")
    if x.dtype != torch.float32 or h.dtype != torch.float32:
        raise TypeError(f"CUDA tdfir takes float32, got {x.dtype} and "
                        f"{h.dtype}")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError("CUDA tdfir takes contiguous operands")
    f, n = x.shape
    k = h.shape[1]
    y = torch.empty_like(x)
    if f == 0 or n == 0 or k == 0:
        return y.zero_()
    tile = min(block_n, n)
    smem = 4 * (2 * k + tile - 1)
    if not 0 < tile <= MAX_TILE or smem > SMEM_LIMIT_BYTES or f > 65535:
        raise ValueError(f"tdfir: tile {tile} (<= {MAX_TILE}), {k} taps "
                         f"({smem} B of shared memory, <= "
                         f"{SMEM_LIMIT_BYTES}) or {f} filters (<= 65535) "
                         f"out of range")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_tdfir(x.data_ptr(), h.data_ptr(), y.data_ptr(),
                              f, n, k, tile, stream)
    _build.check(lib, err, "tdfir")
    launches += 1
    return y


def tdfir_complex(x_re, x_im, h_re, h_im, **kw):
    """Complex FIR via 4 real FIRs (planar layout)."""
    rr = tdfir(x_re, h_re, **kw)
    ii = tdfir(x_im, h_im, **kw)
    ri = tdfir(x_re, h_im, **kw)
    ir = tdfir(x_im, h_re, **kw)
    return rr - ii, ri + ir
