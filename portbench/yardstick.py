"""The benchmark's frozen yardstick: the H100's published peaks, the work
of each attention kernel and of a model's token, and the percentile.

These are copies, fixed here so that a change to the program cannot move
the ruler it is measured with: the kernels' ``work`` formulas follow
``repro_torch.kernels.{flash_attention,flash_attention_bwd,
decode_attention}.work`` and ``percentile`` follows
``repro_torch.serve.metrics.percentile``.  Nothing here imports the
program.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Nearest-rank percentile, ``k = ceil(p / 100 * n)``; None when
    empty."""
    if not values:
        return None
    xs = sorted(values)
    if p <= 0:
        return xs[0]
    k = math.ceil(p / 100.0 * len(xs))
    return xs[min(max(k, 1), len(xs)) - 1]


def causal_pairs(s: int) -> int:
    """(query, key) pairs one head attends under a causal mask over ``s``
    positions with no window."""
    return s * (s + 1) // 2


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_fwd_work(bh: int, s: int, d: int, kv_group: int,
                   itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one causal flash forward over ``bh`` query rows
    of ``s`` positions: 4 FLOP a pair and head dim; q, k, v read once and
    o written once."""
    n_kv = bh // kv_group
    return (4.0 * bh * causal_pairs(s) * d,
            float(itemsize * (2 * bh * s * d + 2 * n_kv * s * d)))


def flash_bwd_work(bh: int, s: int, d: int, kv_group: int,
                   itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one causal flash backward's least work: 10 FLOP a
    pair and head dim; q, o, do, k, v read once, dq, dk, dv written
    once."""
    n_kv = bh // kv_group
    return (10.0 * bh * causal_pairs(s) * d,
            float(itemsize * (4 * bh * s * d + 4 * n_kv * s * d)))


def decode_work(b: int, h: int, kvh: int, d: int, valid: int,
                itemsize: int = 2) -> tuple:
    """(FLOPs, bytes) of one decode-attention call over ``valid`` cache
    rows in all: 4 FLOP a query head, head dim and valid key; the valid
    rows of K and V read once, q read and the output written once."""
    return (4.0 * h * d * valid,
            float(itemsize * (2 * valid * kvh * d + 2 * b * h * d)))


def matmul_params(cfg: dict) -> int:
    """Weights a token multiplies through: every projection of every layer
    and the unembedding over the real vocabulary (the embedding lookup is
    no product)."""
    d, h, kv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        cfg["d_head"]
    gated = cfg["ffn_act"] in ("swiglu", "geglu")
    attn = d * h * hd * 2 + d * kv * hd * 2
    ffn = d * cfg["d_ff"] * (3 if gated else 2)
    return cfg["n_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def forward_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Model FLOPs of a forward pass over ``tokens`` tokens whose heads
    attend ``pairs`` (query, key) pairs in all (per head, summed over the
    sequences): 2 a weight a token, 4 a pair, head dim, head and layer."""
    return (2.0 * matmul_params(cfg) * tokens
            + 4.0 * pairs * cfg["d_head"] * cfg["n_heads"] * cfg["n_layers"])


def train_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """Model FLOPs of a training step: three times the forward's (the
    forward, and the backward's two products a weight)."""
    return 3.0 * forward_flops(cfg, tokens, pairs)
