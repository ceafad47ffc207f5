"""Device dispatch for the kernels, and their launch counters.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the hand-written CUDA kernel, and a build or launch
failure raises — there is no fallback.  Each kernel module counts its own
launches; :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0.  A wrapper counts a launch when Python calls it, so a CUDA
graph (:class:`CountedGraph`) takes back the launches its capture recorded
(nothing ran) and adds them again on every replay (they all run).
"""
from __future__ import annotations

from contextlib import contextmanager
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
                    causal: bool = True, kv_group: int = 1,
                    window: int = 0) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH // kv_group, Skv, D] -> [BH, Sq, D];
    ``window`` > 0 keeps keys with ``qpos - kpos < window``."""
    if _on_cpu(q, k, v):
        return ref.mha_ref(q, k, v, causal=causal, kv_group=kv_group,
                           window=window)
    return _fa.flash_attention(q, k, v, causal=causal, kv_group=kv_group,
                               window=window)


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


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the kernel launches it
    holds: :meth:`capture` records how many launches each kernel's wrapper
    made while capturing (and takes them back out of the counters, since a
    captured launch does not run); :meth:`replay` runs the graph and adds
    them.  The decode kernel's scratch in the graph is the graph's own
    (``scratch``), so graphs replayed on any streams never share it."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        self.scratch: dict = {}

    @contextmanager
    def capture(self, stream: torch.cuda.Stream):
        """Capture the block's work on ``stream`` (which must have run the
        same work once before, so that kernels are built and library
        workspaces made outside the capture)."""
        before = launch_counts()
        try:
            with _da.graph_scratch(self.scratch), \
                    torch.cuda.graph(self.graph, stream=stream):
                yield self
        finally:
            after = launch_counts()
            for name, mod in _KERNELS.items():
                n = after[name] - before[name]
                mod.launches -= n
                self.launches[name] = n

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            _KERNELS[name].launches += n
