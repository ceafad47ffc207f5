"""Launch wrapper of the hand-written CUDA GEMM (``csrc/matmul.cu``), the
FPGA-analogue replacement of the 3mm matmul nests.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.matmul` sends CPU
tensors to the plain version instead.  The fp32 kernel runs one block per
64x32 tile of C and splits K over the block's warps (:func:`plan`).  bf16
runs on the tensor cores: wgmma fed by a TMA ring where TMA can map the
operands, fed from registers where it cannot (:func:`bf16_plan`).  Ragged
edges are masked in the kernels, so any M, N, K work.
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


GROUP_M = 8                        # tile rows a group of bf16 blocks walks
# the least grid of 128 x 256 tiles the bf16 plan takes over 64 x 64:
# half the H100's 132 SMs (scripts/matmul_routes.py, PERF.md: at 2048^3,
# 128 blocks of 128 x 256 beat 256 of 128 x 128 and 1024 of 64 x 64)
WIDE_BLOCKS = 64
TMA_K = 64                         # k of one bf16 ring stage


class Bf16Tile(NamedTuple):
    code: int            # csrc/matmul.cu's ROUTE_* (``kw`` of the C entry)
    tile_m: int
    tile_n: int
    stages: int          # shared-memory stages of K tiles
    threads: int         # warpgroups (and a TMA route's producer warp)
    smem: int            # dynamic shared bytes: 1024 of alignment slack,
                         # the stages (a TMA ring's two mbarriers a stage)


def _ring(tile_m: int, tile_n: int, stages: int) -> Bf16Tile:
    code = {(64, 64): 1, (128, 256): 2}[tile_m, tile_n]
    stage = 2 * TMA_K * (tile_m + tile_n)
    return Bf16Tile(code, tile_m, tile_n, stages, 2 * tile_m + 32,
                    1024 + stages * stage + 16 * stages)


# csrc/matmul.cu's bf16 routes (held to the library's at load): wgmma over
# a TMA ring, or for operands TMA cannot map ("unaligned") over two stages
# one warpgroup fills from registers
BF16_ROUTES = {"unaligned": Bf16Tile(0, 64, 64, 2, 128,
                                     1024 + 2 * 2 * TMA_K * (64 + 64)),
               "small": _ring(64, 64, 4),
               "wide": _ring(128, 256, 4)}


class Bf16Plan(NamedTuple):
    route: str           # a key of BF16_ROUTES
    tile: Bf16Tile
    grid_m: int
    grid_n: int

    @property
    def blocks(self) -> int:
        return self.grid_m * self.grid_n


def bf16_mappable(n: int, k: int, a_ptr: int = 0, b_ptr: int = 0) -> bool:
    """Whether TMA can map A [M, K] and B [K, N]: 16-byte aligned bases and
    row strides (K % 8 == 0 and N % 8 == 0 in bf16), and K > 0."""
    return k > 0 and k % 8 == 0 and n % 8 == 0 and a_ptr % 16 == 0 \
        and b_ptr % 16 == 0


@functools.lru_cache(maxsize=256)
def bf16_plan(m: int, n: int, k: int, mappable: bool = True) -> Bf16Plan:
    """The bf16 launch for C[m, n] = A[m, k] B[k, n] (``mappable``: the
    bases are, see :func:`bf16_mappable`; the shape is checked here):
    128 x 256 TMA tiles on two consumer warpgroups where that grid holds
    at least WIDE_BLOCKS blocks, else 64 x 64 on one (512^3: 64 blocks,
    not 16); operands TMA cannot map take the "unaligned" route.  The grid
    is one-dimensional, its blocks ordered by :func:`tile_of`."""
    if not (mappable and bf16_mappable(n, k)):
        route = "unaligned"
    else:
        wide = BF16_ROUTES["wide"]
        route = ("wide" if -(-m // wide.tile_m) * -(-n // wide.tile_n)
                 >= WIDE_BLOCKS else "small")
    t = BF16_ROUTES[route]
    return Bf16Plan(route, t, -(-m // t.tile_m), -(-n // t.tile_n))


def tile_of(p: Bf16Plan, block):
    """(row tile, column tile) of bf16 block ``block`` (ints or numpy
    arrays), as csrc/matmul.cu's ``tile_origin`` finds it: consecutive
    blocks walk GROUP_M tile rows column by column, so the blocks in
    flight share A and B panels in L2."""
    per_group = GROUP_M * p.grid_n
    first = block // per_group * GROUP_M
    rows = p.grid_m - first
    rows = rows - (rows - GROUP_M) * (rows > GROUP_M)   # min(rows, GROUP_M)
    i = block % per_group
    return first + i % rows, i // rows


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
    operations (fp32 FMAs on the CUDA cores; bf16 products on the tensor
    cores, summed in fp32),
    each operand read once and C written once.  The bound in PERF.md and
    the modeled cost (``repro_torch.core.trace_analysis``) both take
    it."""
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
    lib.repro_matmul_bf16_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_matmul_bf16_tile.restype = ctypes.c_int
    for route, t in BF16_ROUTES.items():
        got = tuple(lib.repro_matmul_bf16_tile(t.code, i) for i in range(5))
        if got != t[1:]:
            raise RuntimeError(f"csrc/matmul.cu bf16 route {route} {got}, "
                               f"the plan assumes {t[1:]}")
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
    if a.dtype == torch.bfloat16:
        kw = bf16_plan(m, n, k, bf16_mappable(
            n, k, a.data_ptr(), b.data_ptr())).tile.code
    else:
        kw = plan(m, n, k).warps
    lib = _lib()
    with _build.on_device(dev):
        err = lib.repro_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPE_CODES[a.dtype], kw,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "matmul")
    launches += 1
    return out
