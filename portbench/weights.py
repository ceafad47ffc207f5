"""Random weights drawn from ``--seed`` on the device, in the layout the
port's dense LM takes (``blocks.{i}.attn.wq`` and so on).

The benchmark makes them and hands the same tensors to the program; the
reference draws them again from the same seed once the program is gone.
Each kind of leaf is drawn for every layer in one call, in the type the
model is served in, and cut into per-layer views: N(0, 1/fan_in) for the
projections and the untied unembedding, N(0, 0.02^2) for the embedding,
ones for norm scales and zeros for norm biases (the distributions of
``repro_torch.models.lm.init_params``; the values differ).  Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``seed`` (weights, a batch, a
    request), so that no two uses share a stream."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 63, *tags])
    return int(ss.generate_state(1, np.uint64)[0] % (2 ** 63))


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def leaf_shapes(cfg: dict) -> Dict[str, tuple]:
    """Per-layer leaf name -> (shape, fan_in); fan_in 0 is a norm leaf."""
    d, h, kv, hd, f = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["d_head"], cfg["d_ff"])
    out = {"attn.wq": ((d, h, hd), d), "attn.wk": ((d, kv, hd), d),
           "attn.wv": ((d, kv, hd), d), "attn.wo": ((h, hd, d), h * hd),
           "ffn.w_in": ((d, f), d), "ffn.w_out": ((f, d), f)}
    if cfg["ffn_act"] in ("swiglu", "geglu"):
        out["ffn.w_gate"] = ((d, f), d)
    if cfg.get("use_bias"):
        raise ValueError("biased projections are not drawn here")
    for norm in ("attn_norm", "ffn_norm"):
        out[f"{norm}.scale"] = ((d,), 0)
        if cfg["norm"] == "layernorm":
            out[f"{norm}.bias"] = ((d,), 0)
    return out


@torch.no_grad()
def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The LM's state dict for ``cfg`` drawn from ``seed`` on ``device``."""
    dt = DTYPES[cfg["param_dtype"]]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    n, d, v = cfg["n_layers"], cfg["d_model"], padded_vocab(cfg)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device).mul_(std)

    params = {"embed": normal((v, d), 0.02)}
    params["final_norm.scale"] = torch.ones(d, dtype=dt, device=device)
    if cfg["norm"] == "layernorm":
        params["final_norm.bias"] = torch.zeros(d, dtype=dt, device=device)
    if not cfg["tie_embeddings"]:
        params["unembed"] = normal((d, v), 1.0 / math.sqrt(d))
    for name, (shape, fan_in) in leaf_shapes(cfg).items():
        if fan_in:
            stacked = normal((n, *shape), 1.0 / math.sqrt(fan_in))
        else:
            fill = 1.0 if name.endswith("scale") else 0.0
            stacked = torch.full((n, *shape), fill, dtype=dt, device=device)
        for i, leaf in enumerate(stacked.unbind(0)):
            params[f"blocks.{i}.{name}"] = leaf
    return params
