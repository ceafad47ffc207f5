"""Device dispatch for the kernels, and their launch counters.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the hand-written CUDA kernel, and a build or launch
failure raises — there is no fallback.  Each kernel module counts its own
launches; :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import tdfir as _fir


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return ref.matmul_ref(a, b)
    return _mm.matmul(a, b)


def tdfir(x: torch.Tensor, h: torch.Tensor, block_n: int = 512
          ) -> torch.Tensor:
    if _on_cpu(x, h):
        return ref.tdfir_ref(x, h)
    return _fir.tdfir(x, h, block_n=block_n)


def tdfir_complex(x_re, x_im, h_re, h_im, block_n: int = 512):
    if _on_cpu(x_re, x_im, h_re, h_im):
        return ref.tdfir_complex_ref(x_re, x_im, h_re, h_im)
    return _fir.tdfir_complex(x_re, x_im, h_re, h_im, block_n=block_n)


def launch_counts() -> Dict[str, int]:
    return {"matmul": _mm.launches, "tdfir": _fir.launches}


def reset_launch_counts() -> None:
    _mm.launches = 0
    _fir.launches = 0
