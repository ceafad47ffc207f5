"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427); the
port of ``repro.models.rglru``.

The diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` runs as a
log-depth scan in plain torch (Hillis-Steele doubling: ceil(log2 S) passes
of whole-tensor products), where the JAX module calls
``jax.lax.associative_scan``; both combine ``(a1, b1), (a2, b2) -> (a1 a2,
b1 a2 + b2)`` and differ only in the order of float32 roundings.  The
projections around it are ``torch.matmul``.  Everything here is plain
torch, as the JAX module is jnp outside any Pallas kernel.

Weights keep the JAX tree's names and layouts: ``w_x``, ``w_gate`` ``[d,
W]``, ``conv_w [K, W]``, ``w_rg``, ``w_ig`` ``[W, W]``, ``lam [W]`` in
float32 whatever the model's dtype, ``w_out [W, d]``.  The decode cache is
``{"conv": [B, K-1, W]`` in the activation dtype, ``"h": [B, 1, W]`` in
float32}.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, ssm

_C = 8.0  # Griffin's fixed recurrence-sharpness constant

# leaves that stay float32 whatever the model's parameter dtype
FP32_LEAVES = ("lam",)


def _width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru(cfg: ModelConfig, generator: torch.Generator, device,
               dtype: torch.dtype) -> dict:
    """One block's RG-LRU weights with the JAX distributions
    (``repro.models.rglru.init_rglru``): ``N(0, 1/fan_in)`` projections, a
    ``N(0, 0.1²)`` conv, and ``lam`` so that ``a^c`` spans about (0.9,
    0.999)."""
    d, w = cfg.d_model, _width(cfg)

    def dense(shape, fan_in):
        return layers.dense_init(shape, fan_in, dtype, generator, device)

    conv = torch.randn((cfg.hybrid.conv_kernel, w), generator=generator,
                       device=device, dtype=torch.float32) * 0.1
    return {
        "w_x": dense((d, w), d),
        "w_gate": dense((d, w), d),
        "conv_w": conv.to(dtype),
        "w_rg": dense((w, w), w),
        "w_ig": dense((w, w), w),
        "lam": torch.log(torch.expm1(torch.linspace(0.3, 1.4, w,
                                                    device=device))),
        "w_out": dense((w, d), w),
    }


def rglru_axes(cfg: ModelConfig) -> dict:
    """One block's logical axes (``repro.models.rglru.rglru_axes``)."""
    return {"w_x": ("embed", "lru"), "w_gate": ("embed", "lru"),
            "conv_w": (None, "lru"), "w_rg": ("lru", None),
            "w_ig": ("lru", None), "lam": (None,),
            "w_out": ("lru", "embed")}


def _gates(p, x, rg, ig):
    """(a, b) of the recurrence for the conv output x [B, S, W] and its
    gate projections ``rg = x w_rg``, ``ig = x w_ig``, float32:
    ``a = exp(-c r softplus(lam))``, ``b = sqrt(max(1 - a², 1e-9)) i x``."""
    r = torch.sigmoid(rg.float())
    i = torch.sigmoid(ig.float())
    log_a = -_C * r * F.softplus(p["lam"])                # [b, s, w] <= 0
    a = torch.exp(log_a)
    gated_x = x.float() * i
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * gated_x
    return a, b


def _conv(x, w, state=None):
    return ssm._causal_conv(x, w, state)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 with h_{-1} = 0, for a, b [B, S,
    W]: Hillis-Steele doubling, each pass folding in the element ``off``
    back (log2 S passes)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def apply_rglru(p: Mapping[str, torch.Tensor], cfg: ModelConfig, hidden,
                return_state: bool = False):
    """The full-sequence path: hidden [B, S, d] -> [B, S, d] (and the
    decode state ``{"conv", "h"}`` with ``return_state``)."""
    x = torch.matmul(hidden, p["w_x"])
    gate = F.gelu(torch.matmul(hidden, p["w_gate"]), approximate="tanh")
    x, conv_state = _conv(x, p["conv_w"])
    a, b = _gates(p, x, torch.matmul(x, p["w_rg"]),
                  torch.matmul(x, p["w_ig"]))
    h = linear_scan(a, b)
    out = torch.matmul(h.to(hidden.dtype) * gate, p["w_out"])
    if return_state:
        return out, {"conv": conv_state.to(hidden.dtype), "h": h[:, -1:, :]}
    return out


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    """Zeroed decode state: ``conv`` [B, K-1, W] in ``dtype``, ``h`` [B, 1,
    W] in float32."""
    w = _width(cfg)
    return {"conv": torch.zeros((batch, cfg.hybrid.conv_kernel - 1, w),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, 1, w), dtype=torch.float32,
                             device=device)}


def decode_rglru(p: Mapping[str, torch.Tensor], cfg: ModelConfig, hidden,
                 cache: Mapping[str, torch.Tensor]):
    """One decode step: hidden [B, 1, d] -> [B, 1, d]; writes the new
    ``conv`` and ``h`` into ``cache`` in place (the JAX module returns
    them).  The conv and the recurrence (the gates' elementwise math, the
    ``h`` update; not the projections) run under the profiler range
    ``rglru.state``."""
    x = torch.matmul(hidden, p["w_x"])
    gate = F.gelu(torch.matmul(hidden, p["w_gate"]), approximate="tanh")
    with record_function("rglru.state"):
        x, conv_state = _conv(x, p["conv_w"], cache["conv"])
    rg, ig = torch.matmul(x, p["w_rg"]), torch.matmul(x, p["w_ig"])
    with record_function("rglru.state"):
        a, b = _gates(p, x, rg, ig)
        h = a * cache["h"] + b
        cache["conv"].copy_(conv_state)
        cache["h"].copy_(h)
    return torch.matmul(h.to(hidden.dtype) * gate, p["w_out"])
