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

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import tdfir as _fir

_KERNELS = {"matmul": _mm, "tdfir": _fir, "flash_attention": _fa,
            "decode_attention": _da}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_group: int = 1) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH // kv_group, Skv, D] -> [BH, Sq, D]."""
    if _on_cpu(q, k, v):
        return ref.mha_ref(q, k, v, causal=causal, kv_group=kv_group)
    return _fa.flash_attention(q, k, v, causal=causal, kv_group=kv_group)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """q [B, H, D]; caches [B, S, KV, D]; per-row ``cache_len`` -> [B, H, D]."""
    if _on_cpu(q, k_cache, v_cache):
        return ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
    return _da.decode_attention(q, k_cache, v_cache, cache_len)


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
