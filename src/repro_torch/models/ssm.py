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
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import NullRules
from repro_torch.models import layers

# leaves that stay float32 whatever the model's parameter dtype
FP32_LEAVES = ("A_log", "D", "dt_bias")

# logical axes under a mesh: the input projection's output gathered whole,
# the per-head leaves and the SSD state split by heads, the gated norm's
# output [B, S, di] by its heads' channels, the decode conv window by
# "lru" (the cache's, models.lm.cache_axes)
WHOLE_IN = ("batch", None, None)
HEADS = ("heads",)
STATE_AXES = ("batch", "heads", None, None)
Y_AXES = ("batch", None, "heads")
CONV_AXES = ("batch", None, "lru")


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


def _gated_norm(scale, y, z, dtype, group=None, width: int = 0):
    """Mamba-2's gated RMSNorm: norm(y * silu(z)) in float32, cast to
    ``dtype``.  With ``group`` the ranks hold slices of the width (their
    heads' channels, ``width`` in all): the sum of squares is summed over
    the group (:func:`collectives.sum_partials`)."""
    y = y * F.silu(z)
    yf = y.float()
    sq = yf.square()
    if group is None:
        ms = sq.mean(dim=-1, keepdim=True)
    else:
        ms = col.sum_partials(sq.sum(dim=-1, keepdim=True), group) / width
    return (yf * torch.rsqrt(ms + 1e-6) * scale.float()).to(dtype)


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


def _head_slices(p, rules):
    """(A_log, D, dt_bias) constrained by the heads, and (h0, the group
    over which the heads are split): each rank runs the SSD on heads
    ``[h0, h0 + n_local)``, n_local their local length."""
    heads = [rules.constrain(p[n], HEADS) for n in ("A_log", "D", "dt_bias")]
    return heads, rules.offset(heads[0], 0), rules.group(heads[0], 0)


def _local_heads(cfg: ModelConfig, zxbcdt, conv_w, conv_prev, h0: int,
                 n: int):
    """The projection's whole ``[..., 2 di + 2 G N + nh]``, after the
    causal conv of its x|B|C part (over ``conv_prev``, or zeros), as the
    pieces of heads ``[h0, h0 + n)``: (z [..., n P], x [..., n, P], B and
    C [..., n, N], dt [..., n]) and the conv's new state."""
    s = cfg.ssm
    di, gn, P = s.d_inner(cfg.d_model), s.n_groups * s.d_state, s.headdim
    z, x, b_, c_, dt = _split_in(cfg, zxbcdt)
    xbc, conv_state = _causal_conv(torch.cat([x, b_, c_], dim=-1), conv_w,
                                   conv_prev)
    x, b_, c_ = torch.split(xbc, [di, gn, gn], dim=-1)
    bh, ch = _heads(cfg, b_, c_)                        # [..., nh, N]
    cols = slice(h0 * P, (h0 + n) * P)
    return (z[..., cols], x[..., cols].reshape(*x.shape[:-1], n, P),
            bh[..., h0:h0 + n, :], ch[..., h0:h0 + n, :],
            dt[..., h0:h0 + n], conv_state)


def apply_ssm(p: Mapping[str, torch.Tensor], cfg: ModelConfig, hidden,
              return_state: bool = False, chunk: int = 0,
              bf16: bool = False, rules=None):
    """The prefill path: hidden [B, S, d] -> [B, S, d] (and the decode
    state ``{"conv", "state"}`` with ``return_state``).  ``chunk`` (0: the
    config's) must divide S once capped at S, as the JAX module asserts.

    Under a mesh (``rules`` of a partitioned LM) the input projection's
    columns split on "lru" do not fall on its z|x|B,C|dt boundaries, and
    every head reads the whole B and C: its output is gathered whole (the
    reshard GSPMD places there), the conv runs whole, and each rank runs
    the SSD chunks on its own heads (:meth:`Rules.local`), the gated norm
    summing its squares over the heads' ranks."""
    rules = rules or NullRules()
    s = cfg.ssm
    seq = hidden.shape[1]
    q = min(chunk or s.chunk, seq)
    if seq % q:
        raise ValueError(f"seq {seq} must divide chunk {q}")
    nc = seq // q
    di, P, N = s.d_inner(cfg.d_model), s.headdim, s.d_state
    zxbcdt = rules.constrain(torch.matmul(hidden, p["w_in"]), WHOLE_IN)
    heads, h0, group = _head_slices(p, rules)

    def local(zxbcdt, conv_w, a_log, d_skip, dt_bias, norm_scale):
        b, nh = zxbcdt.shape[0], a_log.shape[0]     # this rank's rows, heads
        z, x, bh, ch, dt, conv_state = _local_heads(cfg, zxbcdt, conv_w,
                                                    None, h0, nh)
        dt = F.softplus(dt.float() + dt_bias)            # [b, S, nh]
        da = dt * -torch.exp(a_log)                      # log-decay

        xc = x.reshape(b, nc, q, nh, P)
        bc = bh.reshape(b, nc, q, nh, N)
        cc = ch.reshape(b, nc, q, nh, N)
        dtc = dt.reshape(b, nc, q, nh)
        cum = torch.cumsum(da.reshape(b, nc, q, nh), dim=2)

        # intra-chunk (diagonal block): L[i, j] = exp(cum_i - cum_j), i >= j
        ct = torch.bfloat16 if bf16 else torch.float32
        mask = torch.ones((q, q), dtype=torch.bool,
                          device=x.device).tril()[None, None, :, :, None]
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        decay = torch.exp(torch.where(mask, diff, float("-inf"))).to(ct)
        scores = torch.einsum("bcihn,bcjhn->bcijh", cc.to(ct),
                              bc.to(ct)) * decay
        xdt = (xc.float() * dtc[..., None]).to(ct)
        y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores.float(),
                              xdt.float())

        # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (x_j dt_j)^T
        seg = torch.exp(cum[:, :, -1:, :] - cum).to(ct)  # [b, nc, q, nh]
        states = torch.einsum("bcjhn,bcjhp->bchnp",
                              bc.to(ct).float() * seg.float()[..., None],
                              xdt.float())
        chunk_decay = torch.exp(cum[:, :, -1, :])        # [b, nc, nh]

        # inter-chunk recurrence over the nc chunk states
        prev = torch.zeros((b, nh, N, P), dtype=torch.float32,
                           device=x.device)
        prevs = []
        for c in range(nc):
            prevs.append(prev)
            prev = states[:, c] + chunk_decay[:, c, :, None, None] * prev
        prev_states = torch.stack(prevs, dim=1)          # [b, nc, nh, N, P]

        y_inter = torch.einsum("bcihn,bchnp->bcihp",
                               cc.float() * torch.exp(cum)[..., None],
                               prev_states)
        y = (y_diag + y_inter).reshape(b, seq, nh, P)
        y = y + x.float() * d_skip[None, None, :, None]
        y = _gated_norm(norm_scale[h0 * P:(h0 + nh) * P],
                        y.reshape(b, seq, nh * P).to(hidden.dtype), z,
                        hidden.dtype, group, di)
        return y, conv_state.to(hidden.dtype), prev

    y, conv_state, prev = rules.local(
        local, (WHOLE_IN, (None, None), HEADS, HEADS, HEADS, (None,)),
        [Y_AXES, WHOLE_IN, STATE_AXES])(
        zxbcdt, p["conv_w"], *heads, p["norm_scale"])
    out = torch.matmul(y, p["w_out"])
    if return_state:
        return out, {"conv": conv_state, "state": prev}
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
               cache: Mapping[str, torch.Tensor], rules=None):
    """One decode step: hidden [B, 1, d] -> [B, 1, d]; writes the new
    ``conv`` and ``state`` into ``cache`` in place (the JAX module returns
    them).  The recurrence between the two projections (conv, state update
    and readout, as elementwise products and sums: no GEMM) runs under the
    profiler range ``ssm.state``.  Under a mesh the heads split as in
    :func:`apply_ssm`: the conv window is gathered whole, and each rank
    updates its heads' state and its part of the window in place."""
    rules = rules or NullRules()
    s = cfg.ssm
    di, P = s.d_inner(cfg.d_model), s.headdim
    zxbcdt = rules.constrain(torch.matmul(hidden, p["w_in"]), WHOLE_IN)
    heads, h0, group = _head_slices(p, rules)
    conv_prev = rules.constrain(cache["conv"], WHOLE_IN)

    def local(zxbcdt, conv_w, conv_prev, state, a_log, d_skip, dt_bias,
              norm_scale):
        b, nh = zxbcdt.shape[0], a_log.shape[0]     # this rank's rows, heads
        with record_function("ssm.state"):
            z, x, bh, ch, dt, conv_state = _local_heads(
                cfg, zxbcdt, conv_w, conv_prev, h0, nh)
            x = x.reshape(b, nh, P).float()
            bh, ch = bh.reshape(b, nh, -1), ch.reshape(b, nh, -1)
            dt = F.softplus(dt.float().reshape(b, nh) + dt_bias)
            da = torch.exp(dt * -torch.exp(a_log))           # [b, nh]
            st = state * da[:, :, None, None] \
                + (bh.float() * dt[..., None])[..., None] * x[:, :, None, :]
            y = (ch.float()[..., None] * st).sum(dim=2)      # [b, nh, P]
            y = y + x * d_skip[None, :, None]
            state.copy_(st)
        y = _gated_norm(norm_scale[h0 * P:(h0 + nh) * P],
                        y.reshape(b, 1, nh * P).to(hidden.dtype), z,
                        hidden.dtype, group, di)
        return y, conv_state

    y, conv_state = rules.local(
        local, (WHOLE_IN, (None, None), WHOLE_IN, STATE_AXES, HEADS, HEADS,
                HEADS, (None,)), [Y_AXES, WHOLE_IN])(
        zxbcdt, p["conv_w"], conv_prev, cache["state"], *heads,
        p["norm_scale"])
    with record_function("ssm.state"):
        layers.write_state(cache["conv"], conv_state, CONV_AXES, rules)
    return torch.matmul(y, p["w_out"])
