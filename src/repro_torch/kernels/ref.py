"""Plain PyTorch versions of every kernel: what the CPU path runs and what
the CUDA kernels are held against on the card."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float64 and rounded once to ``a.dtype``.

    The JAX reference sums in fp32 (``matmul_ref`` there), which on its
    CPU comes out close to the exact product; a library fp32 GEMM sums in
    another order and drifts past the reference tests' 1e-5 at K=256.
    Summing in float64 makes the plain version the correctly rounded
    product, which both fp32 kernels are held against.
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(a.dtype)


def tdfir_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal per-filter FIR: y[f,n] = sum_k h[f,k] x[f,n-k]."""
    n = x.shape[1]
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for kk in range(k):
        y = y + h[:, kk:kk + 1] * xp[:, k - 1 - kk:k - 1 - kk + n]
    return y.to(x.dtype)


def tdfir_complex_ref(x_re, x_im, h_re, h_im):
    rr = tdfir_ref(x_re, h_re)
    ii = tdfir_ref(x_im, h_im)
    ri = tdfir_ref(x_re, h_im)
    ir = tdfir_ref(x_im, h_re)
    return rr - ii, ri + ir


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH, Skv, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)
