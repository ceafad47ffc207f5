"""Mamba-2 (SSD, state-space duality) block in its chunked matrix form; the
port of ``repro.models.ssm``.

The SSD algorithm (arXiv:2405.21060) as chunk-local masked products plus a
recurrence over the ``S / chunk`` chunk states: no per-token scan, so the
large products carry nearly all the FLOPs and the recurrence touches only
the ``[B, nh, N, P]`` states.  Everything here is plain torch, as the JAX
module is jnp outside any Pallas kernel: the products are ``torch.matmul``
and ``torch.einsum``, and the inter-chunk recurrence is a Python loop over
the chunks (the JAX ``lax.scan``).

Weights keep the JAX tree's names and layouts: ``w_in [d, 2 di + 2 G N +
nh]`` (z, x, B, C, dt), ``conv_w [K, di + 2 G N]``, ``A_log``, ``D`` and
``dt_bias`` ``[nh]`` in float32 whatever the model's dtype, ``w_out [di,
d]``, ``norm_scale [di]``.  The decode cache is ``{"conv": [B, K-1, di + 2
G N]`` in the activation dtype, ``"state": [B, nh, N, P]`` in float32}.

Under ``Plan.ssd_bf16`` the large ``[B, nc, q, q, nh]`` intermediates are
bfloat16, with float32 sums where the JAX einsums ask for them
(``preferred_element_type``); the port computes those products on float32
copies of the bfloat16 operands, which is what the preferred type means.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch.autograd.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

# leaves that stay float32 whatever the model's parameter dtype
FP32_LEAVES = ("A_log", "D", "dt_bias")


def init_ssm(cfg: ModelConfig, generator: torch.Generator, device,
             dtype: torch.dtype) -> dict:
    """One layer's SSD weights with the JAX distributions
    (``repro.models.ssm.init_ssm``): ``N(0, 1/fan_in)`` projections, a
    ``N(0, 0.1²)`` conv, ``A_log = log(linspace(1, nh))``, ``D`` ones,
    ``dt_bias`` zeros, ``norm_scale`` ones."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    conv = torch.randn((s.conv_kernel, di + 2 * gn), generator=generator,
                       device=device, dtype=torch.float32) * 0.1
    return {
        "w_in": layers.dense_init((d, 2 * di + 2 * gn + nh), d, dtype,
                                  generator, device),
        "conv_w": conv.to(dtype),
        "A_log": torch.log(torch.linspace(1.0, float(nh), nh,
                                          device=device)),
        "D": torch.ones(nh, device=device),
        "dt_bias": torch.zeros(nh, device=device),
        "w_out": layers.dense_init((di, d), di, dtype, generator, device),
        "norm_scale": torch.ones(di, dtype=dtype, device=device),
    }


def ssm_axes(cfg: ModelConfig) -> dict:
    """One layer's logical axes (``repro.models.ssm.ssm_axes``)."""
    return {"w_in": ("embed", "lru"), "conv_w": (None, "lru"),
            "A_log": (None,), "D": (None,), "dt_bias": (None,),
            "w_out": ("lru", "embed"), "norm_scale": (None,)}


def _split_in(cfg: ModelConfig, h):
    """The input projection [..., 2 di + 2 G N + nh] -> (z, x, B, C, dt)."""
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    z, x, b_, c_, dt = torch.split(h, [di, di, gn, gn, s.n_heads(cfg.d_model)],
                                   dim=-1)
    return z, x, b_, c_, dt


def _causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv then SiLU: x [B, S, C], w [K, C]; ``state``
    [B, K-1, C] (the previous K-1 inputs, for decode) or zeros.  Returns
    (out [B, S, C], the new state: the last K-1 inputs, in x's dtype)."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return F.silu(out), new_state


def _gated_norm(p, y, z, dtype):
    """Mamba-2's gated RMSNorm: norm(y * silu(z)) in float32, cast to
    ``dtype``."""
    y = y * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-6)
            * p["norm_scale"].float()).to(dtype)


def _heads(cfg: ModelConfig, b_, c_):
    """B and C [..., G*N] -> [..., nh, N]: each group's state broadcast to
    its ``nh / G`` heads."""
    s = cfg.ssm
    rep = s.n_heads(cfg.d_model) // s.n_groups
    lead = b_.shape[:-1]
    return (b_.reshape(*lead, s.n_groups, s.d_state)
            .repeat_interleave(rep, dim=-2),
            c_.reshape(*lead, s.n_groups, s.d_state)
            .repeat_interleave(rep, dim=-2))


def apply_ssm(p: Mapping[str, torch.Tensor], cfg: ModelConfig, hidden,
              return_state: bool = False, chunk: int = 0,
              bf16: bool = False):
    """The prefill path: hidden [B, S, d] -> [B, S, d] (and the decode
    state ``{"conv", "state"}`` with ``return_state``).  ``chunk`` (0: the
    config's) must divide S once capped at S, as the JAX module asserts."""
    s = cfg.ssm
    b, seq, _ = hidden.shape
    q = min(chunk or s.chunk, seq)
    if seq % q:
        raise ValueError(f"seq {seq} must divide chunk {q}")
    nc = seq // q
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    P, N = s.headdim, s.d_state

    z, x, b_, c_, dt = _split_in(cfg, torch.matmul(hidden, p["w_in"]))
    xbc, conv_state = _causal_conv(torch.cat([x, b_, c_], dim=-1),
                                   p["conv_w"])
    x, b_, c_ = torch.split(xbc, [di, gn, gn], dim=-1)
    x = x.reshape(b, seq, nh, P)
    bh, ch = _heads(cfg, b_, c_)                         # [b, S, nh, N]

    dt = F.softplus(dt.float() + p["dt_bias"])           # [b, S, nh]
    da = dt * -torch.exp(p["A_log"])                     # log-decay

    xc = x.reshape(b, nc, q, nh, P)
    bc = bh.reshape(b, nc, q, nh, N)
    cc = ch.reshape(b, nc, q, nh, N)
    dtc = dt.reshape(b, nc, q, nh)
    cum = torch.cumsum(da.reshape(b, nc, q, nh), dim=2)  # [b, nc, q, nh]

    # intra-chunk (diagonal block): L[i, j] = exp(cum_i - cum_j), i >= j
    ct = torch.bfloat16 if bf16 else torch.float32
    mask = torch.ones((q, q), dtype=torch.bool,
                      device=hidden.device).tril()[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(mask, diff, float("-inf"))).to(ct)
    scores = torch.einsum("bcihn,bcjhn->bcijh", cc.to(ct), bc.to(ct)) * decay
    xdt = (xc.float() * dtc[..., None]).to(ct)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores.float(), xdt.float())

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (x_j dt_j)^T
    seg = torch.exp(cum[:, :, -1:, :] - cum).to(ct)      # [b, nc, q, nh]
    states = torch.einsum("bcjhn,bcjhp->bchnp",
                          bc.to(ct).float() * seg.float()[..., None],
                          xdt.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])            # [b, nc, nh]

    # inter-chunk recurrence over the nc chunk states
    prev = torch.zeros((b, nh, N, P), dtype=torch.float32,
                       device=hidden.device)
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev
    prev_states = torch.stack(prevs, dim=1)              # [b, nc, nh, N, P]

    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           cc.float() * torch.exp(cum)[..., None],
                           prev_states)
    y = (y_diag + y_inter).reshape(b, seq, nh, P)
    y = y + x.float() * p["D"][None, None, :, None]
    y = _gated_norm(p, y.reshape(b, seq, di).to(hidden.dtype), z,
                    hidden.dtype)
    out = torch.matmul(y, p["w_out"])
    if return_state:
        return out, {"conv": conv_state.to(hidden.dtype), "state": prev}
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> dict:
    """Zeroed decode state: ``conv`` [B, K-1, di + 2 G N] in ``dtype``,
    ``state`` [B, nh, N, P] in float32."""
    s = cfg.ssm
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, di + 2 * gn),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, nh, s.d_state, s.headdim),
                                 dtype=torch.float32, device=device)}


def decode_ssm(p: Mapping[str, torch.Tensor], cfg: ModelConfig, hidden,
               cache: Mapping[str, torch.Tensor]):
    """One decode step: hidden [B, 1, d] -> [B, 1, d]; writes the new
    ``conv`` and ``state`` into ``cache`` in place (the JAX module returns
    them).  The recurrence between the two projections (conv, state update
    and readout, as elementwise products and sums: no GEMM) runs under the
    profiler range ``ssm.state``."""
    s = cfg.ssm
    b = hidden.shape[0]
    di, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state
    z, x, b_, c_, dt = _split_in(cfg, torch.matmul(hidden, p["w_in"]))
    with record_function("ssm.state"):
        xbc, conv_state = _causal_conv(torch.cat([x, b_, c_], dim=-1),
                                       p["conv_w"], cache["conv"])
        x, b_, c_ = torch.split(xbc, [di, gn, gn], dim=-1)
        x = x.reshape(b, nh, s.headdim).float()
        bh, ch = _heads(cfg, b_.reshape(b, gn), c_.reshape(b, gn))
        dt = F.softplus(dt.float().reshape(b, nh) + p["dt_bias"])
        da = torch.exp(dt * -torch.exp(p["A_log"]))      # [b, nh]
        st = cache["state"] * da[:, :, None, None] \
            + (bh.float() * dt[..., None])[..., None] * x[:, :, None, :]
        y = (ch.float()[..., None] * st).sum(dim=2)      # [b, nh, P]
        y = y + x * p["D"][None, :, None]
        cache["conv"].copy_(conv_state)
        cache["state"].copy_(st)
    y = _gated_norm(p, y.reshape(b, 1, di).to(hidden.dtype), z,
                    hidden.dtype)
    return torch.matmul(y, p["w_out"])
