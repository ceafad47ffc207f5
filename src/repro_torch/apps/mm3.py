"""polybench 3mm: G = (A·B)·(C·D)  (paper §III.A), the port of
``repro.apps.mm3``.

Loop nests mirror the C benchmark: four init loops + three matmul triple
nests.  ``seq`` runs each matmul as a Python loop over output rows (the
single-core loop structure); ``dp`` is one library matmul; ``tp`` splits the
reduction into partial products with an explicit combine (the
transfer-disciplined GPU analogue); ``pallas`` is the hand-written CUDA GEMM
(CPU tensors take its plain version).
"""
from __future__ import annotations

import torch

from repro_torch import device as _device
from repro_torch.core.offloadable import LoopNest, OffloadableApp
from repro_torch.kernels import ops

N_FULL = 512
N_SMALL = 64


def _seq_matmul(a, b):
    return torch.stack([a[i] @ b for i in range(a.shape[0])])


def _tp_matmul(a, b, parts: int = 4):
    k = a.shape[1]
    assert k % parts == 0
    aa = a.reshape(a.shape[0], parts, k // parts)
    bb = b.reshape(parts, k // parts, b.shape[1])
    partial = torch.einsum("mpk,pkn->pmn", aa, bb)   # p partial products
    return partial.sum(dim=0)                        # explicit combine


def _pallas_matmul(a, b):
    return ops.matmul(a, b)


def _init_nest(name, key_idx):
    def seq(state):
        iv = state["iv"]                       # [n] float index vector
        m = torch.stack([torch.sin(iv[i] * 0.37 + key_idx)
                         * torch.cos(iv * 0.11 + key_idx)
                         for i in range(iv.shape[0])])
        return dict(state, **{name.split("_")[1]: m})

    def dp(state):
        iv = state["iv"]
        m = (torch.sin(iv * 0.37 + key_idx)[:, None]
             * torch.cos(iv * 0.11 + key_idx)[None, :])
        return dict(state, **{name.split("_")[1]: m})

    return LoopNest(name=name, impls={"seq": seq, "dp": dp, "tp": dp},
                    trip_count=2, doc="matrix init double loop")


def _mm_nest(name, lhs, rhs, out):
    def seq(state):
        return dict(state, **{out: _seq_matmul(state[lhs], state[rhs])})

    def dp(state):
        return dict(state, **{out: state[lhs] @ state[rhs]})

    def tp(state):
        return dict(state, **{out: _tp_matmul(state[lhs], state[rhs])})

    def pallas(state):
        return dict(state, **{out: _pallas_matmul(state[lhs], state[rhs])})

    return LoopNest(name=name,
                    impls={"seq": seq, "dp": dp, "tp": tp,
                           "pallas": pallas},
                    trip_count=3, doc="matmul triple nest")


def make_inputs(seed: int = 0, small: bool = False, device=None):
    n = N_SMALL if small else N_FULL
    dev = _device.resolve(device)
    return {"iv": torch.arange(n, dtype=torch.float32, device=dev)}


def build_app() -> OffloadableApp:
    nests = [
        _init_nest("init_A", 1),
        _init_nest("init_B", 2),
        _init_nest("init_C", 3),
        _init_nest("init_D", 4),
        _mm_nest("mm1_E_AB", "A", "B", "E"),
        _mm_nest("mm2_F_CD", "C", "D", "F"),
        _mm_nest("mm3_G_EF", "E", "F", "out"),
    ]
    return OffloadableApp(name="3mm", nests=nests, make_inputs=make_inputs,
                          doc="polybench 3mm (3 chained matmuls)")
