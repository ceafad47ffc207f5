"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427); the
port of ``repro.models.rglru``.

The diagonal linear recurrence ``h_t = a_t * h_{t-1} + b_t`` runs as a
log-depth scan in plain torch (Hillis-Steele doubling: ceil(log2 S) passes
of whole-tensor products), where the JAX module calls
``jax.lax.associative_scan``; both combine ``(a1, b1), (a2, b2) -> (a1 a2,
b1 a2 + b2)`` and differ only in the order of float32 roundings.  Under a
mesh each rank runs the conv and the scan on its own "lru" channels
(:func:`apply_rglru`).  The
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
from repro_torch.dist.sharding import NullRules
from repro_torch.models import layers, ssm

_C = 8.0  # Griffin's fixed recurrence-sharpness constant

# leaves that stay float32 whatever the model's parameter dtype
FP32_LEAVES = ("lam",)

# logical axes under a mesh: the channels [B, S, W] split on "lru", or
# whole (the gate products, summed over the channels' ranks)
LRU = ("batch", None, "lru")
WHOLE = ("batch", None, None)


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


def _gates(lam, x, rg, ig):
    """(a, b) of the recurrence for the conv output x [B, S, W] and its
    gate projections ``rg = x w_rg``, ``ig = x w_ig``, float32:
    ``a = exp(-c r softplus(lam))``, ``b = sqrt(max(1 - a², 1e-9)) i x``."""
    r = torch.sigmoid(rg.float())
    i = torch.sigmoid(ig.float())
    log_a = -_C * r * F.softplus(lam)                     # [b, s, w] <= 0
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
                return_state: bool = False, rules=None):
    """The full-sequence path: hidden [B, S, d] -> [B, S, d] (and the
    decode state ``{"conv", "h"}`` with ``return_state``).

    Under a mesh (``rules`` of a partitioned LM) the conv and the scan run
    on each rank's "lru" channels (:meth:`Rules.local`); the gate
    projections ``w_rg`` / ``w_ig`` are split on their input channels, so
    each rank's product is a partial sum, summed over the channels' ranks
    before the gates."""
    rules = rules or NullRules()
    x = torch.matmul(hidden, p["w_x"])
    gate = F.gelu(torch.matmul(hidden, p["w_gate"]), approximate="tanh")
    x, conv_state = rules.local(_conv, (LRU, (None, "lru")), [LRU, LRU])(
        x, p["conv_w"])
    rg, ig = _gate_products(p, x, rules)

    def scan(x, rg, ig, lam):
        a, b = _gates(lam, x, rg, ig)
        return linear_scan(a, b)

    h = rules.local(scan, (LRU, LRU, LRU, ("lru",)), LRU)(x, rg, ig,
                                                         p["lam"])
    out = torch.matmul(h.to(hidden.dtype) * gate, p["w_out"])
    if return_state:
        return out, {"conv": conv_state.to(hidden.dtype),
                     "h": h[:, -1:, :]}
    return out


def _gate_products(p, x, rules):
    """``x w_rg`` and ``x w_ig``, whole over "lru" (the sums of the ranks'
    partial products)."""
    return tuple(rules.constrain(torch.matmul(x, p[n]), WHOLE)
                 for n in ("w_rg", "w_ig"))


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
                 cache: Mapping[str, torch.Tensor], rules=None):
    """One decode step: hidden [B, 1, d] -> [B, 1, d]; writes the new
    ``conv`` and ``h`` into ``cache`` in place (the JAX module returns
    them).  The conv and the recurrence (the gates' elementwise math, the
    ``h`` update; not the projections) run under the profiler range
    ``rglru.state``.  Under a mesh each rank updates its own "lru"
    channels of the state, as in :func:`apply_rglru`."""
    rules = rules or NullRules()
    x = torch.matmul(hidden, p["w_x"])
    gate = F.gelu(torch.matmul(hidden, p["w_gate"]), approximate="tanh")

    def conv(x, w, state):
        with record_function("rglru.state"):
            x, new = _conv(x, w, state)
            state.copy_(new)
        return x

    x = rules.local(conv, (LRU, (None, "lru"), LRU), LRU)(x, p["conv_w"],
                                                         cache["conv"])
    rg, ig = _gate_products(p, x, rules)

    def step(x, rg, ig, lam, h):
        with record_function("rglru.state"):
            a, b = _gates(lam, x, rg, ig)
            h_new = a * h + b
            h.copy_(h_new)
        return h_new

    h = rules.local(step, (LRU, LRU, LRU, ("lru",), LRU), LRU)(
        x, rg, ig, p["lam"], cache["h"])
    return torch.matmul(h.to(hidden.dtype) * gate, p["w_out"])
