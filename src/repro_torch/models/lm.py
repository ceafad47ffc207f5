"""The language model, dense family: the port of ``repro.models.lm``.

Serving entry points, as in the JAX ``Model``:

  * ``LM.prefill(batch, cache_len)``          -> (last_logits, cache)
  * ``LM.decode_step(cache, tokens, pos)``    -> (logits, cache)

Parameters keep the JAX tree's names and layouts (``embed [V, d]``,
``final_norm.scale``, and per layer ``attn_norm.scale``, ``attn.{wq,wk,wv,
wo}``, ``ffn_norm.scale``, ``ffn.{w_in,w_gate,w_out}``); the JAX tree stacks
the layers on a leading axis where the port keeps one :class:`DenseBlock`
per layer (``blocks.{i}.…``).  :mod:`repro_torch.models.convert` carries
weights across.

Differences from the JAX model, none of which changes a result:

  * ``decode_step`` writes the new token's K/V into ``cache`` in place (JAX
    returns a new cache), so the serving pool is allocated once.
  * ``pos`` may be one position per row (an int tensor ``[B]``): the
    continuous batcher's slots sit at different positions, where the JAX
    engine ``vmap``s a scalar-``pos`` step over the slots.
  * Attention always runs the flash-attention kernel (prefill) and the
    split-K decode kernel (decode) through :mod:`repro_torch.kernels.ops`;
    the JAX model's dense/blockwise switch computes the same function.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.dist.plan import Plan
from repro_torch.models import layers
from repro_torch.models.layers import not_ported

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig, plan: Optional[Plan] = None) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    if cfg.family != "dense":
        raise not_ported(f"the {cfg.family!r} family", 8)
    if cfg.attn_kind == "swa" or cfg.logit_softcap > 0:
        raise not_ported("sliding-window attention and logit soft caps", 8)
    if plan is not None and plan.kv_cache_quant:
        raise NotImplementedError(
            "the int8 KV cache (plan.kv_cache_quant, the JAX "
            "decode_attention_quant) is not ported to repro_torch yet")


# ===========================================================================
# init (the JAX distributions, repro.models.layers:25-31)
# ===========================================================================

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` as the LM's state dict, drawn on ``device``
    (default ``cuda``) from ``generator`` (default seed 0): ``N(0, 1/fan_in)``
    for projections, ``N(0, 0.02²)`` for the embedding, ones for norm
    scales, zeros for biases.  Values differ from ``jax.random``'s."""
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
    gated = cfg.ffn_act in ("swiglu", "geglu")
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
        p[f"{b}.ffn.w_in"] = dense((d, cfg.d_ff), d)
        p[f"{b}.ffn.w_out"] = dense((cfg.d_ff, d), cfg.d_ff)
        if gated:
            p[f"{b}.ffn.w_gate"] = dense((d, cfg.d_ff), d)
        if cfg.use_bias:
            p[f"{b}.ffn.b_in"] = zeros(cfg.d_ff)
            p[f"{b}.ffn.b_out"] = zeros(d)
    return p


def _group(params: Params, prefix: str) -> nn.ParameterDict:
    return nn.ParameterDict({
        k[len(prefix):]: nn.Parameter(v, requires_grad=False)
        for k, v in params.items() if k.startswith(prefix)})


# ===========================================================================
# modules
# ===========================================================================

class DenseBlock(nn.Module):
    """One pre-norm decoder layer: GQA attention + FFN, residual each."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = _group(params, f"{prefix}.attn_norm.")
        self.attn = _group(params, f"{prefix}.attn.")
        self.ffn_norm = _group(params, f"{prefix}.ffn_norm.")
        self.ffn = _group(params, f"{prefix}.ffn.")

    def _ffn(self, h):
        cfg = self.cfg
        x = layers.apply_norm(self.ffn_norm, h, cfg.norm)
        return h + layers.apply_ffn(self.ffn, x, cfg.ffn_act, cfg.use_bias)

    def _qkv(self, h, positions):
        cfg = self.cfg
        x = layers.apply_norm(self.attn_norm, h, cfg.norm)
        q = layers.q_project(self.attn, cfg, x)
        k, v = layers.kv_project(self.attn, cfg, x)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def prefill(self, h, positions, plan):
        """h [B, S, d] -> (h, (k, v)) with the layer's post-RoPE K/V."""
        q, k, v = self._qkv(h, positions)
        attn_out = layers.attention(q, k, v, causal=True,
                                    softcap=self.cfg.logit_softcap, plan=plan)
        h = h + layers.out_project(self.attn, self.cfg, attn_out)
        return self._ffn(h), (k, v)

    def decode(self, h, k_cache, v_cache, pos, cache_len):
        """h [B, 1, d]; caches [B, W, KV, Dh] (written in place at each
        row's slot); pos, cache_len int tensors [B]."""
        q, k, v = self._qkv(h, pos[:, None])
        # the JAX rule without a window: slot min(pos, w - 1)
        slot = torch.clamp(pos, max=k_cache.shape[1] - 1)
        rows = torch.arange(h.shape[0], device=h.device)
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        attn_out = layers.decode_attention(q, k_cache, v_cache, cache_len,
                                           softcap=self.cfg.logit_softcap)
        h = h + layers.out_project(self.attn, self.cfg, attn_out)
        return self._ffn(h)


class LM(nn.Module):
    """The dense LM over ``params`` (a state dict from :func:`init_params`
    or :func:`repro_torch.models.convert.params_from_numpy`); it runs where
    its parameters lie, and its weights take no gradient."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 plan: Optional[Plan] = None):
        super().__init__()
        self.plan = plan or Plan()
        check_supported(cfg, self.plan)
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = _group(params, "final_norm.")
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(params["unembed"],
                                        requires_grad=False)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, params, f"blocks.{i}")
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
        h = self.embed[tokens.long()].to(self.dtype)
        scale = torch.tensor(math.sqrt(self.cfg.d_model), dtype=self.dtype,
                             device=h.device)
        return h * scale

    def logits_for(self, hidden):
        """Full fp32 logits for a short hidden slice, padded vocab masked."""
        cfg = self.cfg
        w = self.embed.T if cfg.tie_embeddings else self.unembed
        logits = torch.matmul(hidden, w).float()
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = layers.NEG_INF
        return logits

    def init_cache(self, batch: int, seq_len: int) -> Cache:
        return init_cache(self.cfg, batch, seq_len, device=self.device)

    # --------------------------------------------------------- entry points
    def prefill(self, batch, cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Full-prompt pass over ``batch["tokens"]`` [B, S]; returns the last
        position's logits [B, V] and a decode cache of ``cache_len``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        b, s = tokens.shape
        h = self._embed(tokens)
        positions = torch.arange(s, device=self.device)
        collected: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for blk in self.blocks:
            h, kv = blk.prefill(h, positions, self.plan)
            collected.append(kv)
        last = layers.apply_norm(self.final_norm, h[:, -1:], self.cfg.norm)
        cache = assemble_cache(self.cfg, collected, cache_len)
        return self.logits_for(last)[:, 0], cache

    def decode_step(self, cache: Cache, tokens, pos
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. ``tokens`` [B, 1]; ``pos`` the absolute position,
        an int or an int tensor [B] (one per row).  Writes ``cache`` in
        place and returns it with the logits [B, V]."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1)
        pos = pos.expand(b).contiguous()
        w = cache["attn"]["k"].shape[2]
        cache_len = torch.clamp(pos + 1, max=w).to(torch.int32)
        h = self._embed(tokens)
        for i, blk in enumerate(self.blocks):
            h = blk.decode(h, cache["attn"]["k"][i], cache["attn"]["v"][i],
                           pos, cache_len)
        h = layers.apply_norm(self.final_norm, h, self.cfg.norm)
        return self.logits_for(h)[:, 0], cache

    def train_loss(self, batch):
        raise not_ported("training (train_loss)", 9)


# ===========================================================================
# decode caches
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Cache:
    """Zeroed K/V buffers ``{"attn": {"k", "v": [L, B, W, KV, Dh]}}`` in
    ``cfg.dtype``; the dense family keeps ``W = seq_len`` (no window)."""
    check_supported(cfg)
    dev = resolve(device)
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
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


def assemble_cache(cfg: ModelConfig, collected, cache_len: int) -> Cache:
    """Turn the prefill's per-layer (k, v) [B, S, KV, Dh] into a decode
    cache at position S with buffer size ``cache_len``, in
    ``cfg.dtype``."""
    dt = torch_dtype(cfg.dtype)
    ks = torch.stack([k for k, _ in collected])
    vs = torch.stack([v for _, v in collected])
    return {"attn": {"k": _ring_place(ks, cache_len, dt),
                     "v": _ring_place(vs, cache_len, dt)}}
