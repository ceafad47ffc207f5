"""The language model, dense and MoE families: the port of
``repro.models.lm``.

Serving entry points, as in the JAX ``Model``:

  * ``LM.prefill(batch, cache_len)``          -> (last_logits, cache)
  * ``LM.decode_step(cache, tokens, pos)``    -> (logits, cache)

The port runs the dense family (granite-3-2b, h2o-danube-1.8b,
nemotron-4-15b, command-r-plus-104b) and the MoE family (moonshot-v1-16b-a3b,
arctic-480b: the dense block with :mod:`repro_torch.models.moe` as its FFN);
the hybrid, SSM, VLM and audio families wait (ROADMAP queue 1 item 8).

Parameters keep the JAX tree's names and layouts (``embed [V, d]``,
``final_norm.scale``, and per layer ``attn_norm.scale``, ``attn.{wq,wk,wv,
wo}``, ``ffn_norm.scale``, ``ffn.{w_in,w_gate,w_out}``, or under MoE
``ffn.router``, ``ffn.experts.{w_in,w_gate,w_out}`` ``[E, ...]``,
``ffn.shared.*``, ``ffn.dense.*``); the JAX tree stacks the layers on a
leading axis where the port keeps one :class:`DenseBlock` per layer
(``blocks.{i}.…``).  :mod:`repro_torch.models.convert` carries weights
across.

The cache is the JAX one: ``{"attn": {"k", "v"}}`` of ``[L, B, W, KV, Dh]``
with ``W = min(cache_len, window)`` under a sliding window (a ring: token
``t`` at slot ``t % W``) and ``W = cache_len`` without one; under
``plan.kv_cache_quant`` ``k``/``v`` are int8 with fp32 ``k_scale`` /
``v_scale`` ``[L, B, W, KV, 1]``.

Differences from the JAX model, none of which changes a result:

  * ``decode_step`` writes the new token's K/V into ``cache`` in place (JAX
    returns a new cache), so the serving pool is allocated once.  It makes
    no tensor from host data when ``tokens`` and ``pos`` are device tensors
    and never synchronises, so the serving engine can capture it in a CUDA
    graph.
  * ``pos`` may be one position per row (an int tensor ``[B]``): the
    continuous batcher's slots sit at different positions, where the JAX
    engine ``vmap``s a scalar-``pos`` step over the slots.  For the same
    reason ``decode_step(..., route_per_row=True)`` routes each row's token
    through the MoE as a group of its own (capacity ``k``, so no drops and
    no row sways another's routing), as the ``vmap``ped JAX step does;
    ``generate`` routes its batch jointly in both packages.
  * Attention always runs the flash-attention kernel (prefill) and the
    split-K decode kernel (decode) through :mod:`repro_torch.kernels.ops`;
    the JAX model's dense/blockwise switch computes the same function.  The
    int8 cache's decode attention is plain torch, as the JAX one is jnp.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.dist.plan import Plan
from repro_torch.models import layers, moe
from repro_torch.models.layers import not_ported

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig, plan: Optional[Plan] = None) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet:
    the families past dense and MoE, and logit soft caps (no config sets
    one, and the JAX blockwise path ignores them)."""
    del plan     # every plan runs: kv_cache_quant, both moe_impl values
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"the {cfg.family!r} family", 8)
    if cfg.logit_softcap > 0:
        raise not_ported("logit soft caps", 8)


def _window_of(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attn_kind == "swa" else 0


def _kv_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Slots a layer's K/V buffer holds for ``seq_len`` positions: the
    window's ring under a sliding window, all of them otherwise."""
    w = _window_of(cfg)
    return min(seq_len, w) if w else seq_len


# ===========================================================================
# init (the JAX distributions, repro.models.layers:25-31)
# ===========================================================================

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` as the LM's state dict, drawn on ``device``
    (default ``cuda``) from ``generator`` (default seed 0): ``N(0, 1/fan_in)``
    for projections (each expert's too), ``N(0, 0.02²)`` for the embedding,
    ones for norm scales, zeros for biases.  Values differ from
    ``jax.random``'s."""
    check_supported(cfg)
    dev = resolve(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape, fan_in):
        return layers.dense_init(shape, fan_in, dt, gen, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm(prefix):
        out = {f"{prefix}.scale": torch.ones(d, dtype=dt, device=dev)}
        if cfg.norm == "layernorm":
            out[f"{prefix}.bias"] = zeros(d)
        return out

    p: Params = {"embed": layers.embed_init((cfg.padded_vocab, d), dt, gen,
                                            dev)}
    p.update(norm("final_norm"))
    if not cfg.tie_embeddings:
        p["unembed"] = dense((d, cfg.padded_vocab), d)
    for i in range(cfg.n_layers):
        b = f"blocks.{i}"
        p.update(norm(f"{b}.attn_norm"))
        p[f"{b}.attn.wq"] = dense((d, h, hd), d)
        p[f"{b}.attn.wk"] = dense((d, kv, hd), d)
        p[f"{b}.attn.wv"] = dense((d, kv, hd), d)
        p[f"{b}.attn.wo"] = dense((h, hd, d), h * hd)
        if cfg.use_bias:
            p[f"{b}.attn.bq"] = zeros(h, hd)
            p[f"{b}.attn.bk"] = zeros(kv, hd)
            p[f"{b}.attn.bv"] = zeros(kv, hd)
            p[f"{b}.attn.bo"] = zeros(d)
        p.update(norm(f"{b}.ffn_norm"))
        ffn = (moe.init_moe(cfg, gen, dev, dt) if cfg.moe is not None
               else layers.init_ffn(d, cfg.d_ff, cfg.ffn_act, cfg.use_bias,
                                    dt, gen, dev))
        for name, leaf in ffn.items():
            if isinstance(leaf, dict):
                p.update({f"{b}.ffn.{name}.{k}": t for k, t in leaf.items()})
            else:
                p[f"{b}.ffn.{name}"] = leaf
    return p


def _group(params: Params, prefix: str) -> nn.ParameterDict:
    return nn.ParameterDict({
        k[len(prefix):]: nn.Parameter(v, requires_grad=False)
        for k, v in params.items() if k.startswith(prefix)})


# ===========================================================================
# modules
# ===========================================================================

class DenseBlock(nn.Module):
    """One pre-norm decoder layer: GQA attention + FFN (dense, or the MoE
    under ``cfg.moe``), residual each."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str,
                 plan: Plan):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.window = _window_of(cfg)
        self.attn_norm = _group(params, f"{prefix}.attn_norm.")
        self.attn = _group(params, f"{prefix}.attn.")
        self.ffn_norm = _group(params, f"{prefix}.ffn_norm.")
        self.ffn = (moe.MoEWeights(params, f"{prefix}.ffn.")
                    if cfg.moe is not None
                    else _group(params, f"{prefix}.ffn."))
        # LM.count_moe_drops: int64 [2, 3], rows prefill and decode
        self.moe_drops: Optional[torch.Tensor] = None

    def _ffn(self, h, step: int, route_per_row: bool = False):
        """``step`` 0 in prefill, 1 in decode (the row of ``moe_drops``)."""
        cfg, plan = self.cfg, self.plan
        x = layers.apply_norm(self.ffn_norm, h, cfg.norm)
        if cfg.moe is None:
            return h + layers.apply_ffn(self.ffn, x, cfg.ffn_act,
                                        cfg.use_bias)
        kw = dict(drops=None if self.moe_drops is None
                  else self.moe_drops[step])
        if route_per_row:       # one group a row: the JAX engine's vmap
            y, _ = moe.apply_moe(self.ffn, cfg, x, plan.moe_capacity_factor,
                                 groups=x.shape[0] * x.shape[1], **kw)
        elif plan.moe_impl == "shardmap_ep":
            y, _ = moe.apply_moe_ep(self.ffn, cfg, x,
                                    plan.moe_capacity_factor, **kw)
        else:
            y, _ = moe.apply_moe(self.ffn, cfg, x, plan.moe_capacity_factor,
                                 groups=plan.moe_groups, **kw)
        return h + y

    def _qkv(self, h, rope):
        cfg = self.cfg
        x = layers.apply_norm(self.attn_norm, h, cfg.norm)
        q = layers.q_project(self.attn, cfg, x)
        k, v = layers.kv_project(self.attn, cfg, x)
        return layers.apply_rope(q, rope), layers.apply_rope(k, rope), v

    def prefill(self, h, rope):
        """h [B, S, d] -> (h, (k, v)) with the layer's post-RoPE K/V."""
        q, k, v = self._qkv(h, rope)
        attn_out = layers.attention(q, k, v, causal=True, window=self.window,
                                    softcap=self.cfg.logit_softcap,
                                    plan=self.plan)
        h = h + layers.out_project(self.attn, self.cfg, attn_out)
        return self._ffn(h, 0), (k, v)

    def decode(self, h, cache, pos, cache_len, rope,
               route_per_row: bool = False):
        """h [B, 1, d]; ``cache`` this layer's buffers ``{"k", "v"[,
        "k_scale", "v_scale"]}`` [B, W, KV, ·] (written in place at each
        row's slot); pos, cache_len int tensors [B]; ``route_per_row``
        routes each row through the MoE on its own."""
        q, k, v = self._qkv(h, rope)
        k_cache, v_cache = cache["k"], cache["v"]
        w = k_cache.shape[1]
        # the JAX rule: the ring slot pos % w under a window, else
        # min(pos, w - 1)
        slot = pos % w if self.window else torch.clamp(pos, max=w - 1)
        rows = torch.arange(h.shape[0], device=h.device)
        quant = "k_scale" in cache
        if quant:
            k, k_s = layers.quantize_kv(k)
            v, v_s = layers.quantize_kv(v)
            cache["k_scale"][rows, slot] = k_s[:, 0]
            cache["v_scale"][rows, slot] = v_s[:, 0]
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        if quant:
            attn_out = layers.decode_attention_quant(
                q, k_cache, cache["k_scale"], v_cache, cache["v_scale"],
                cache_len, softcap=self.cfg.logit_softcap)
        else:
            attn_out = layers.decode_attention(
                q, k_cache, v_cache, cache_len, window=self.window,
                softcap=self.cfg.logit_softcap)
        h = h + layers.out_project(self.attn, self.cfg, attn_out)
        return self._ffn(h, 1, route_per_row)


class LM(nn.Module):
    """The dense or MoE LM over ``params`` (a state dict from :func:`init_params`
    or :func:`repro_torch.models.convert.params_from_numpy`); it runs where
    its parameters lie, and its weights take no gradient."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 plan: Optional[Plan] = None):
        super().__init__()
        self.plan = plan or Plan()
        check_supported(cfg, self.plan)
        self.cfg = cfg
        # sqrt(d_model) rounded to the activation type once, as the JAX
        # _embed rounds it: a Python float multiplies with no host copy
        self._embed_scale = float(torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=torch_dtype(cfg.dtype)))
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = _group(params, "final_norm.")
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(params["unembed"],
                                        requires_grad=False)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, params, f"blocks.{i}", self.plan)
            for i in range(cfg.n_layers))
        if set(self.state_dict()) != set(params):
            raise ValueError(
                f"params do not fit {cfg.name}: extra "
                f"{sorted(set(params) - set(self.state_dict()))[:5]}")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------- pieces
    def _embed(self, tokens):
        return self.embed[tokens.long()].to(self.dtype) * self._embed_scale

    def _rope(self, positions):
        return layers.rope_table(positions, self.cfg.head_dim,
                                 self.cfg.rope_theta)

    def logits_for(self, hidden):
        """Full fp32 logits for a short hidden slice, padded vocab masked."""
        cfg = self.cfg
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = torch.matmul(hidden, w).float()
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = layers.NEG_INF
        return logits

    def count_moe_drops(self) -> torch.Tensor:
        """Count the MoE's routed and dropped (token, k) pairs from now on:
        returns the int64 ``[2, 3]`` counter on the model's device (rows
        prefill and decode; columns pairs routed, pairs dropped, and
        experts routed to, per layer and call), which every MoE layer adds
        to in place, inside a captured decode step too (an engine's graph
        keeps the counter set when it was captured, so call this before
        building the engine).  Zero it to start again."""
        counts = torch.zeros((2, 3), dtype=torch.long, device=self.device)
        for blk in self.blocks:
            blk.moe_drops = counts
        return counts

    def init_cache(self, batch: int, seq_len: int) -> Cache:
        return init_cache(self.cfg, batch, seq_len, device=self.device,
                          quant=self.plan.kv_cache_quant)

    # --------------------------------------------------------- entry points
    def prefill(self, batch, cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Full-prompt pass over ``batch["tokens"]`` [B, S]; returns the last
        position's logits [B, V] and a decode cache of ``cache_len``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, s = tokens.shape
        h = self._embed(tokens)
        rope = self._rope(torch.arange(s, device=self.device))
        collected: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for blk in self.blocks:
            h, kv = blk.prefill(h, rope)
            collected.append(kv)
        last = layers.apply_norm(self.final_norm, h[:, -1:], self.cfg.norm)
        cache = assemble_cache(self.cfg, collected, cache_len,
                               quant=self.plan.kv_cache_quant)
        return self.logits_for(last)[:, 0], cache

    def decode_step(self, cache: Cache, tokens, pos, *,
                    route_per_row: bool = False
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. ``tokens`` [B, 1]; ``pos`` the absolute position,
        an int or an int tensor [B] (one per row).  Writes ``cache`` in
        place and returns it with the logits [B, V].  ``route_per_row``
        routes each row through the MoE as its own group (the continuous
        batcher's slots, as the JAX engine's ``vmap``); otherwise the rows
        are routed together, as ``generate`` does."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1)
        pos = pos.expand(b).contiguous()
        w = cache["attn"]["k"].shape[2]
        cache_len = torch.clamp(pos + 1, max=w).to(torch.int32)
        h = self._embed(tokens)
        rope = self._rope(pos[:, None])
        for i, blk in enumerate(self.blocks):
            h = blk.decode(h, {name: buf[i] for name, buf
                               in cache["attn"].items()}, pos, cache_len,
                           rope, route_per_row)
        h = layers.apply_norm(self.final_norm, h, self.cfg.norm)
        return self.logits_for(h)[:, 0], cache

    def train_loss(self, batch):
        raise not_ported("training (train_loss)", 9)


# ===========================================================================
# decode caches
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None, quant: bool = False) -> Cache:
    """Zeroed K/V buffers ``{"attn": {"k", "v": [L, B, W, KV, Dh]}}`` with
    ``W = min(seq_len, window)`` (``seq_len`` without a window), in
    ``cfg.dtype``; with ``quant`` int8 ``k``/``v`` and fp32 ``k_scale`` /
    ``v_scale`` ``[L, B, W, KV, 1]``."""
    check_supported(cfg)
    dev = resolve(device)
    shape = (cfg.n_layers, batch, _kv_cache_len(cfg, seq_len),
             cfg.n_kv_heads, cfg.head_dim)
    if quant:
        scales = shape[:-1] + (1,)
        return {"attn": {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(scales, dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(scales, dtype=torch.float32, device=dev)}}
    dt = torch_dtype(cfg.dtype)
    return {"attn": {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}}


def _ring_place(k_seq, buf_len: int, dtype):
    """Place collected K/V [..., S, KV, D] into a ring buffer of
    ``buf_len``: token t lives at slot t % buf_len and only the last
    ``buf_len`` tokens are kept (zero padding at the end when
    ``buf_len >= S``)."""
    s = k_seq.shape[-3]
    if buf_len >= s:
        out = k_seq.new_zeros((*k_seq.shape[:-3], buf_len,
                               *k_seq.shape[-2:]), dtype=dtype)
        out[..., :s, :, :] = k_seq
        return out
    kept = k_seq[..., s - buf_len:, :, :]
    positions = torch.arange(buf_len, device=k_seq.device) + (s - buf_len)
    inv = torch.argsort(positions % buf_len)
    return kept.index_select(-3, inv).to(dtype)


def assemble_cache(cfg: ModelConfig, collected, cache_len: int,
                   quant: bool = False) -> Cache:
    """Turn the prefill's per-layer (k, v) [B, S, KV, Dh] into a decode
    cache at position S for ``cache_len`` positions (the window's ring
    under a sliding window), in ``cfg.dtype``; with ``quant`` the K/V are
    quantized first (int8 and fp32 scales), as the JAX cache is."""
    kvl = _kv_cache_len(cfg, cache_len)
    ks = torch.stack([k for k, _ in collected])
    vs = torch.stack([v for _, v in collected])
    if quant:
        (kq, k_s), (vq, v_s) = layers.quantize_kv(ks), layers.quantize_kv(vs)
        return {"attn": {"k": _ring_place(kq, kvl, torch.int8),
                         "v": _ring_place(vq, kvl, torch.int8),
                         "k_scale": _ring_place(k_s, kvl, torch.float32),
                         "v_scale": _ring_place(v_s, kvl, torch.float32)}}
    dt = torch_dtype(cfg.dtype)
    return {"attn": {"k": _ring_place(ks, kvl, dt),
                     "v": _ring_place(vs, kvl, dt)}}
