"""Launch wrapper of the hand-written CUDA tdFIR kernel (``csrc/tdfir.cu``),
the paper's function-block offload target on the FPGA-analogue destination.

y[f, n] = sum_k h[f, k] * x[f, n - k]   (causal, per-filter bank)

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.tdfir` sends CPU
tensors to the plain version instead.  Complex data stays planar re/im, and
:func:`tdfir_complex` is one launch that stages both planes once.
:func:`plan` sizes the launch: each thread owns ``OUTPUTS_PER_THREAD``
consecutive outputs and walks the taps in groups of ``TAP_GROUP``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

OUTPUTS_PER_THREAD = 8           # csrc/tdfir.cu's kR
TAP_GROUP = 4                    # taps per 16-byte load of h
MAX_THREADS = 128
MAX_TILE = MAX_THREADS * OUTPUTS_PER_THREAD
SMEM_LIMIT_BYTES = 227 * 1024    # an H100 block's opt-in shared memory
SMS = 132                        # H100 SXM


def padded_taps(k: int) -> int:
    """K rounded up to whole tap groups (the padded taps are zeros)."""
    return -(-k // TAP_GROUP) * TAP_GROUP


def max_taps(planes: int) -> int:
    """The most taps whose tap rows and windows (``planes`` of each: 1 real,
    2 complex) fit in 227 KB at the largest tile: 28544 real, 14016
    complex (a multiple of 8, so that K' and the window's 8-float blocks
    both fit)."""
    per_plane = SMEM_LIMIT_BYTES // (4 * planes)
    return (per_plane - MAX_TILE) // 2 // 8 * 8


class TdfirPlan(NamedTuple):
    threads: int         # a block's threads, a multiple of 32
    grid_n: int          # N-tiles; the grid is grid_n x F
    grid_f: int
    taps: int            # K' = K rounded up to TAP_GROUP

    @property
    def tile(self) -> int:
        """Outputs of one block: thread t owns [8 t, 8 t + 8) of them."""
        return self.threads * OUTPUTS_PER_THREAD

    @property
    def window(self) -> int:
        """Input samples a block stages: x[n0 - K', n0 + tile)."""
        return self.tile + self.taps

    @property
    def stride(self) -> int:
        """Shared slots of a plane's window: the window rounded up to whole
        8-float blocks, inside which the swizzle moves its quads."""
        return self.tile + -(-self.taps // 8) * 8

    def smem_bytes(self, planes: int) -> int:
        """Shared memory of a launch: per plane K' taps and a window."""
        return 4 * planes * (self.taps + self.stride)

    @property
    def blocks(self) -> int:
        return self.grid_n * self.grid_f


@functools.lru_cache(maxsize=256)
def plan(f: int, n: int, k: int) -> TdfirPlan:
    """The launch for F filters of N samples and K taps: 128 threads a
    block (1024 outputs; F=64, N=4096 gives 4 x 64 = 256 blocks, 1024 warps,
    7.8 a SM), halved (down to 32) while half the tile still covers N or
    the grid would not give every SM a block."""
    threads = MAX_THREADS
    while threads > 32 and (threads * OUTPUTS_PER_THREAD // 2 >= n
                            or f * -(-n // (threads * OUTPUTS_PER_THREAD))
                            < SMS):
        threads //= 2
    tile = threads * OUTPUTS_PER_THREAD
    return TdfirPlan(threads, -(-n // tile), f, padded_taps(k))


def work(f: int, n: int, k: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one real launch: 2 F N K fp32 operations, x and h
    read once and y written once.  The bound in PERF.md and the modeled
    cost (``repro_torch.core.trace_analysis``) both take it."""
    return 2.0 * f * n * k, 4.0 * (2 * f * n + f * k)


def complex_work(f: int, n: int, k: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one :func:`tdfir_complex` launch: four real FIRs
    and the two combines (2 F N), both planes of x and h read once and both
    planes of y written once."""
    return 4 * work(f, n, k)[0] + 2.0 * f * n, 4.0 * (4 * f * n + 2 * f * k)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("tdfir")
    lib.repro_tdfir.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                + [ctypes.c_void_p])
    lib.repro_tdfir.restype = ctypes.c_int
    lib.repro_tdfir_complex.argtypes = ([ctypes.c_void_p] * 6
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
    lib.repro_tdfir_complex.restype = ctypes.c_int
    lib.repro_tdfir_outputs_per_thread.restype = ctypes.c_int
    if lib.repro_tdfir_outputs_per_thread() != OUTPUTS_PER_THREAD:
        raise RuntimeError("csrc/tdfir.cu's outputs per thread differ from "
                           "OUTPUTS_PER_THREAD")
    return lib


def _refusal(xs, hs) -> Exception:
    """The error for operands that ``_checked`` refused."""
    ts = (*xs, *hs)
    if any(t.device.type != "cuda" or t.device != ts[0].device for t in ts):
        return ValueError(f"CUDA tdfir needs x and h on one CUDA device, "
                          f"got {[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        return TypeError(f"CUDA tdfir takes float32, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        return ValueError("CUDA tdfir takes contiguous operands")
    return ValueError(f"tdfir shapes x {[tuple(t.shape) for t in xs]}, h "
                      f"{[tuple(t.shape) for t in hs]}")


def _checked(xs, hs, planes: int):
    """Validate the operands in one pass (the checks are a large part of a
    call's host time); returns (f, n, k)."""
    x, h = xs[0], hs[0]
    dev = x.device
    for group, shape in ((xs, x.shape), (hs, h.shape)):
        for t in group:
            if (t.device != dev or t.shape != shape
                    or t.dtype != torch.float32 or not t.is_contiguous()):
                raise _refusal(xs, hs)
    if dev.type != "cuda" or x.dim() != 2 or h.dim() != 2 \
            or x.shape[0] != h.shape[0]:
        raise _refusal(xs, hs)
    (f, n), k = x.shape, h.shape[1]
    if k > max_taps(planes) or f > 65535:
        raise ValueError(f"tdfir: {k} taps (<= {max_taps(planes)} with "
                         f"{planes} plane(s) in {SMEM_LIMIT_BYTES} B of "
                         f"shared memory) or {f} filters (<= 65535) out of "
                         f"range")
    return f, n, k


def tdfir(x: torch.Tensor, h: torch.Tensor, *,
          block_n: int = 512) -> torch.Tensor:
    """x [F, N] float32, h [F, K] float32 -> y [F, N] (causal FIR).

    ``block_n`` is the TPU kernel's blocking knob, kept for parity with the
    JAX function; on the card :func:`plan` sets the tile.  K is not tied to
    the tile: any K up to ``max_taps(1)`` works.
    """
    global launches
    f, n, k = _checked((x,), (h,), 1)
    y = torch.empty_like(x)
    if f == 0 or n == 0 or k == 0:
        return y.zero_()
    lib = _lib()
    dev = x.device
    with _build.on_device(dev):
        err = lib.repro_tdfir(x.data_ptr(), h.data_ptr(), y.data_ptr(), f, n,
                              k, plan(f, n, k).threads,
                              _build.raw_stream(dev))
    _build.check(lib, err, "tdfir")
    launches += 1
    return y


def tdfir_complex(x_re, x_im, h_re, h_im, *, block_n: int = 512):
    """The complex FIR bank on planar re/im data in one launch:
    (x_re*h_re - x_im*h_im, x_re*h_im + x_im*h_re), bitwise what four real
    launches and the two fp32 combines give.  ``block_n`` as in
    :func:`tdfir`; K up to ``max_taps(2)``."""
    global launches
    f, n, k = _checked((x_re, x_im), (h_re, h_im), 2)
    y_re, y_im = torch.empty_like(x_re), torch.empty_like(x_re)
    if f == 0 or n == 0 or k == 0:
        return y_re.zero_(), y_im.zero_()
    lib = _lib()
    dev = x_re.device
    with _build.on_device(dev):
        err = lib.repro_tdfir_complex(
            x_re.data_ptr(), x_im.data_ptr(), h_re.data_ptr(),
            h_im.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), f, n, k,
            plan(f, n, k).threads, _build.raw_stream(dev))
    _build.check(lib, err, "tdfir_complex")
    launches += 1
    return y_re, y_im
