"""Launch wrapper of the hand-written CUDA GEMM (``csrc/matmul.cu``), the
FPGA-analogue replacement of the 3mm matmul nests.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.matmul` sends CPU
tensors to the plain version instead.  The kernel picks its own 64x64x16
tiling and masks ragged edges itself, so any M, N, K work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    lib.repro_matmul.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    lib.repro_matmul.restype = ctypes.c_int
    return lib


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> [M, N] in ``a.dtype``, fp32 accumulation."""
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"CUDA matmul needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA matmul takes float32 or bfloat16 operands of "
                        f"one dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("CUDA matmul takes contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, k, _DTYPE_CODES[a.dtype], stream)
    _build.check(lib, err, "matmul")
    launches += 1
    return out
