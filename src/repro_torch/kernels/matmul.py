"""Launch wrapper of the hand-written CUDA GEMM (``csrc/matmul.cu``), the
FPGA-analogue replacement of the 3mm matmul nests.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.matmul` sends CPU
tensors to the plain version instead.  The fp32 kernel runs one block per
64x32 tile of C and splits K over the block's warps (:func:`plan`).  Ragged
edges are masked in the kernel, so any M, N, K work.  bf16 takes the first
port's kernel and ignores the plan.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_M, BLOCK_N = 64, 32         # csrc/matmul.cu's fp32 block tile
SLAB_K = 8                         # k-steps of one warp's slab
MAX_WARPS = 8


class MatmulPlan(NamedTuple):
    grid_m: int
    grid_n: int
    warps: int           # warps of a block; warp w takes slabs w, w+warps..

    @property
    def blocks(self) -> int:
        return self.grid_m * self.grid_n


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int) -> MatmulPlan:
    """The fp32 kernel's launch for C[m, n] = A[m, k] B[k, n]: one block per
    64x32 tile of C (512^3: 8 x 16 = 128 blocks on the 132 SMs), and as
    many warps (1, 2, 4 or 8) as keep at least two 8-deep K slabs each.
    Block (j, i) owns rows [64 i, 64 i + 64) and columns [32 j, 32 j + 32);
    its warp w sums the products of K slabs w, w + warps, ..."""
    slabs = -(-k // SLAB_K)
    warps = 1
    while warps < MAX_WARPS and slabs >= 4 * warps:
        warps *= 2
    return MatmulPlan(-(-m // BLOCK_M), -(-n // BLOCK_N), warps)


def work(m: int, n: int, k: int, itemsize: int = 4) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch for C[m, n] = A[m, k] B[k, n]: 2 m n k
    fp32 FMA operations (the bf16 form also sums in fp32 on the CUDA
    cores), each operand read once and C written once.  The bound in
    PERF.md and the modeled cost (``repro_torch.core.trace_analysis``)
    both take it."""
    return 2.0 * m * n * k, float(itemsize * (m * k + k * n + m * n))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    lib.repro_matmul.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p])
    lib.repro_matmul.restype = ctypes.c_int
    lib.repro_matmul_tile.argtypes = [ctypes.c_int]
    lib.repro_matmul_tile.restype = ctypes.c_int
    tile = tuple(lib.repro_matmul_tile(i) for i in range(3))
    if tile != (BLOCK_M, BLOCK_N, SLAB_K):
        raise RuntimeError(f"csrc/matmul.cu tile {tile}, the plan assumes "
                           f"{(BLOCK_M, BLOCK_N, SLAB_K)}")
    return lib


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] -> [M, N] in ``a.dtype``, fp32 accumulation."""
    global launches
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
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
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    with _build.on_device(dev):
        err = lib.repro_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPE_CODES[a.dtype], plan(m, n, k).warps,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "matmul")
    launches += 1
    return out
