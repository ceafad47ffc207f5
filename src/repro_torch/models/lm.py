"""The language model, every family of ``repro.models.lm``: the port of
that module.

Entry points, as in the JAX ``Model``:

  * ``LM.prefill(batch, cache_len)``          -> (last_logits, cache)
  * ``LM.decode_step(cache, tokens, pos)``    -> (logits, cache)
  * ``LM.train_loss(batch)``                  -> (total, {"loss",
    "aux_loss"}), differentiable once the weights take gradients
    (``requires_grad_(True)``; ``repro_torch.train.train_step``)

Prefill and training share the layer walk (:meth:`LM.backbone`); in
training each block runs under the plan's remat (:func:`remat`) and the
loss is the chunked cross-entropy (:meth:`LM.chunked_softmax_xent`).

The port runs the dense family (granite-3-2b, h2o-danube-1.8b,
nemotron-4-15b, command-r-plus-104b), the MoE family (moonshot-v1-16b-a3b,
arctic-480b: the dense block with :mod:`repro_torch.models.moe` as its FFN),
the SSM family (mamba2-1.3b: :class:`SSMBlock` over
:mod:`repro_torch.models.ssm`) and the hybrid (recurrentgemma-2b: groups of
``cfg.hybrid.pattern`` blocks, :class:`RecurrentBlock` over
:mod:`repro_torch.models.rglru` and the dense block as its local attention,
then a tail), the VLM family (llama-3.2-vision-90b: groups of
``cross_attn_every`` dense blocks and one :class:`CrossBlock` over the
image embeddings) and the audio family (seamless-m4t-medium: a non-causal
encoder over the frames, then decoder layers of a dense block and a
:class:`CrossBlock` over the encoder output).  Both take their context
(``batch["img_embed"]`` or ``batch["frames"]``, from the reference's stub
frontends) in every prefill; a batch without it raises.

Parameters keep the JAX tree's names and layouts (``embed [V, d]``,
``final_norm.scale``, and per layer ``attn_norm.scale``, ``attn.{wq,wk,wv,
wo}``, ``ffn_norm.scale``, ``ffn.{w_in,w_gate,w_out}``, or under MoE
``ffn.router``, ``ffn.experts.{w_in,w_gate,w_out}`` ``[E, ...]``,
``ffn.shared.*``, ``ffn.dense.*``; an SSM layer's ``norm.scale``,
``ssm.*``; a recurrent block's ``norm.scale``, ``lru.*``, ``ffn_norm.scale``,
``ffn.*``; a cross block's ``attn_norm``, ``attn``, ``ffn_norm``,
``ffn``); the JAX tree stacks the layers (the hybrid's groups) on a
leading axis where the port keeps one module per layer: ``blocks.{i}.…``,
for the hybrid ``blocks.{g}.b{j}.…`` and ``tail.{i}.…``, for the VLM
``self_blocks.{g}.{j}.…`` and ``cross_blocks.{g}.…``, for the audio
family ``enc_blocks.{i}.…``, ``enc_norm.…``, ``dec_blocks.{i}.self.…`` and
``dec_blocks.{i}.cross.…``.
:mod:`repro_torch.models.convert` carries weights across.

The cache is the JAX one:

  * dense and MoE: ``{"attn": {"k", "v"}}`` of ``[L, B, W, KV, Dh]`` with
    ``W = min(cache_len, window)`` under a sliding window (a ring: token
    ``t`` at slot ``t % W``) and ``W = cache_len`` without one; under
    ``plan.kv_cache_quant`` ``k``/``v`` are int8 with fp32 ``k_scale`` /
    ``v_scale`` ``[L, B, W, KV, 1]``;
  * SSM: ``{"blocks": {"conv", "state"}}`` of ``[L, B, ...]``;
  * hybrid: ``{"groups": {"b{j}": ...}, "tail": [...]}``, each group block's
    leaves stacked over the groups: a recurrent block's ``{"conv", "h"}``,
    the local attention's ring ``{"k", "v"}`` of ``min(cache_len,
    window)`` slots (never quantized, as in JAX);
  * VLM: ``{"attn": [groups, per, B, W, KV, Dh], "cross": [groups, B,
    n_img_tokens, KV, Dh]}``; audio: ``{"attn": [L, B, W, KV, Dh],
    "cross": [L, B, n_frames, KV, Dh]}``.  The cross K/V are the context's,
    written at prefill (or by :meth:`LM.init_context_cache`), read by
    every decode step over the whole context and never written by it;
    they are never quantized.

Differences from the JAX model, none of which changes a result:

  * ``decode_step`` writes the new token's K/V and recurrent state into
    ``cache`` in place (JAX returns a new cache), so the serving pool is
    allocated once.  It makes no tensor from host data when ``tokens`` and
    ``pos`` are device tensors and never synchronises, so the serving
    engine can capture it in a CUDA graph.
  * ``pos`` may be one position per row (an int tensor ``[B]``): the
    continuous batcher's slots sit at different positions, where the JAX
    engine ``vmap``s a scalar-``pos`` step over the slots.  For the same
    reason ``decode_step(..., route_per_row=True)`` routes each row's token
    through the MoE as a group of its own (capacity ``k``, so no drops and
    no row sways another's routing), as the ``vmap``ped JAX step does;
    ``generate`` routes its batch jointly in both packages.
  * Attention always runs the flash-attention kernel (prefill and
    training, whose gradient is the flash backward kernel) and the
    split-K decode kernel (decode) through :mod:`repro_torch.kernels.ops`;
    the JAX model's dense/blockwise switch computes the same function.  The
    int8 cache's decode attention is plain torch, as the JAX one is jnp,
    and so are the SSD and RG-LRU bodies.

Under a mesh (``LM(cfg, params, plan, rules=Rules(mesh, plan))`` with an
axis past one device) every family is partitioned as the reference's
GSPMD partitions it: the parameters become DTensors placed by
:func:`param_axes` (``embed`` over "data", FSDP-style, gathered where a
product uses it; ``heads`` / ``kv_heads`` / ``ff`` / ``vocab`` /
``experts`` / ``lru`` over "model"), the inputs and the modality context
are placed by their batch axes, activations are constrained at the
reference's sites (the embedding, q and k, the attention, FFN, MoE and
mixer outputs, the logits), DTensor places the collectives of the plain
ops, and each rank runs the kernels and the plain-torch recurrences on
its own part (``models.layers``: attention, cross attention and the int8
cache on its heads or ``kv_seq`` slice; ``models.moe``: its data rank's
routing groups and its own experts; ``models.ssm``: its SSD heads;
``models.rglru``: its "lru" channels).  The vocabulary stays split in the
loss and the logits' mask: each rank's log-sum-exp is merged over "model"
and the gold logit comes from the rank that holds it.  The entry points
take whole inputs on every rank and return whole logits and loss; the
decode cache (K/V, int8 scales, cross K/V, recurrent states) stays placed
by :func:`cache_axes`.  The mesh path is eager (no CUDA graph).  The MoE
family under ``moe_impl="shardmap_ep"`` keeps the explicit expert-parallel
path and whole parameters.  On a mesh with a "pod" axis (the pod-parallel
step's, ``train.train_step``) the LM is partitioned on its pod's ("data",
"model") sub-mesh (``Rules.without("pod")``), as the reference's GSPMD
partitions its inner model inside the ``shard_map`` over "pod": nothing
it places names "pod", and the step reduces across pods itself.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.dist.plan import Plan
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import NullRules, whole
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models.layers import not_ported

BATCH_SEQ = ("batch", None)             # tokens, labels [B, S]
HIDDEN = ("batch", None, None)          # the residual stream [B, S, d]
LOGITS = ("batch", None, "vocab")       # logits [B, S, V]

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Any]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the batch key of each family's modality context
CONTEXT_KEYS = {"vlm": "img_embed", "audio": "frames"}


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig, plan: Optional[Plan] = None) -> None:
    """Raise ``NotImplementedError`` for a family the JAX package does not
    have either; every plan and every logit soft cap runs."""
    del plan     # every plan runs: kv_cache_quant, moe_impl, ssd_*
    if cfg.family not in FAMILIES:
        raise not_ported(f"the {cfg.family!r} family", 8)


def vlm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups, dense blocks a group): each group ends in a cross block."""
    per = cfg.cross_attn_every
    return cfg.n_layers // (per + 1), per


def hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(groups of the whole pattern, blocks in the tail after them)."""
    pat = cfg.hybrid.pattern
    groups = cfg.n_layers // len(pat)
    return groups, cfg.n_layers - groups * len(pat)


def _window_of(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attn_kind == "swa" else 0


def _kv_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Slots a layer's K/V buffer holds for ``seq_len`` positions: the
    window's ring under a sliding window and in the hybrid's local
    attention, all of them otherwise."""
    w = _window_of(cfg) or (cfg.window if cfg.family == "hybrid" else 0)
    return min(seq_len, w) if w else seq_len


def flatten(tree: dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> one dict of dotted names (``prefix`` before each)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ===========================================================================
# init (the JAX distributions, repro.models.layers:25-31)
# ===========================================================================

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random weights for ``cfg`` as the LM's state dict, drawn on ``device``
    (default ``cuda``) from ``generator`` (default seed 0): ``N(0, 1/fan_in)``
    for projections (each expert's too), ``N(0, 0.02²)`` for the embedding,
    ones for norm scales, zeros for biases, and the SSD and RG-LRU
    constants of :func:`ssm.init_ssm` and :func:`rglru.init_rglru`.  Values
    differ from ``jax.random``'s."""
    check_supported(cfg)
    dev = resolve(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)
    dt = torch_dtype(cfg.param_dtype)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(shape, fan_in):
        return layers.dense_init(shape, fan_in, dt, gen, dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm():
        out = {"scale": torch.ones(d, dtype=dt, device=dev)}
        if cfg.norm == "layernorm":
            out["bias"] = zeros(d)
        return out

    def ffn():
        return layers.init_ffn(d, cfg.d_ff, cfg.ffn_act, cfg.use_bias, dt,
                               gen, dev)

    def attn():
        out = {"wq": dense((d, h, hd), d), "wk": dense((d, kv, hd), d),
               "wv": dense((d, kv, hd), d), "wo": dense((h, hd, d), h * hd)}
        if cfg.use_bias:
            out.update(bq=zeros(h, hd), bk=zeros(kv, hd), bv=zeros(kv, hd),
                       bo=zeros(d))
        return out

    def dense_block():
        return {"attn_norm": norm(), "attn": attn(), "ffn_norm": norm(),
                "ffn": (moe.init_moe(cfg, gen, dev, dt)
                        if cfg.moe is not None else ffn())}

    def block(kind):
        if kind == "cross":
            return {"attn_norm": norm(), "attn": attn(), "ffn_norm": norm(),
                    "ffn": ffn()}
        if kind == "recurrent":
            return {"norm": norm(), "lru": rglru.init_rglru(cfg, gen, dev, dt),
                    "ffn_norm": norm(), "ffn": ffn()}
        if kind == "ssm":
            return {"norm": norm(), "ssm": ssm.init_ssm(cfg, gen, dev, dt)}
        return dense_block()

    p: Params = {"embed": layers.embed_init((cfg.padded_vocab, d), dt, gen,
                                            dev)}
    p.update(flatten(norm(), "final_norm."))
    if not cfg.tie_embeddings:
        p["unembed"] = dense((d, cfg.padded_vocab), d)
    if cfg.family == "audio":
        p.update(flatten(norm(), "enc_norm."))
    for name, kind in _layer_names(cfg):
        p.update(flatten(block(kind), f"{name}."))
    return p


def _layer_names(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(state-dict prefix, block kind) of every layer in execution order;
    kinds ``dense`` (the MoE's too), ``ssm``, ``recurrent``,
    ``local_attn``, ``cross`` (attention over the context) and
    ``encoder`` (the audio encoder's non-causal layers, run in prefill
    only, before the decoder's)."""
    if cfg.family == "vlm":
        groups, per = vlm_groups(cfg)
        return [layer for g in range(groups) for layer in
                [(f"self_blocks.{g}.{j}", "dense") for j in range(per)]
                + [(f"cross_blocks.{g}", "cross")]]
    if cfg.family == "audio":
        return ([(f"enc_blocks.{i}", "encoder")
                 for i in range(cfg.encoder_layers)]
                + [(f"dec_blocks.{i}.{part}", kind)
                   for i in range(cfg.n_layers)
                   for part, kind in (("self", "dense"), ("cross", "cross"))])
    if cfg.family == "ssm":
        return [(f"blocks.{i}", "ssm") for i in range(cfg.n_layers)]
    if cfg.family != "hybrid":
        return [(f"blocks.{i}", "dense") for i in range(cfg.n_layers)]
    pat = cfg.hybrid.pattern
    groups, tail = hybrid_groups(cfg)
    return ([(f"blocks.{g}.b{j}", kind) for g in range(groups)
             for j, kind in enumerate(pat)]
            + [(f"tail.{i}", pat[i % len(pat)]) for i in range(tail)])


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """One block's logical axes (``repro.models.lm._*_block_axes``)."""
    if kind == "ssm":
        return {"norm": layers.norm_axes(cfg.norm), "ssm": ssm.ssm_axes(cfg)}
    if kind == "recurrent":
        return {"norm": layers.norm_axes(cfg.norm),
                "lru": rglru.rglru_axes(cfg),
                "ffn_norm": layers.norm_axes(cfg.norm),
                "ffn": layers.ffn_axes(cfg.ffn_act, cfg.use_bias)}
    ffn = (moe.moe_axes(cfg) if cfg.moe is not None and kind != "cross"
           else layers.ffn_axes(cfg.ffn_act, cfg.use_bias))
    return {"attn_norm": layers.norm_axes(cfg.norm),
            "attn": layers.attn_axes(cfg),
            "ffn_norm": layers.norm_axes(cfg.norm), "ffn": ffn}


def param_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each parameter's logical axes, keyed by the LM's state-dict names
    (``repro.models.lm.param_axes``, whose stacked leading ``"layers"``
    axes the port drops: it keeps one module a layer)."""
    p = {"embed": ("vocab", "embed")}
    p.update(flatten(layers.norm_axes(cfg.norm), "final_norm."))
    if not cfg.tie_embeddings:
        p["unembed"] = ("embed", "vocab")
    if cfg.family == "audio":
        p.update(flatten(layers.norm_axes(cfg.norm), "enc_norm."))
    for name, kind in _layer_names(cfg):
        p.update(flatten(_block_axes(cfg, kind), f"{name}."))
    return p


def cache_axes(cfg: ModelConfig, quant: bool = False) -> Cache:
    """The decode cache's logical axes, the tree of :func:`init_cache`
    (``repro.models.lm.cache_axes``: the port's cache is the JAX one, its
    layers stacked on a leading ``"layers"`` axis)."""
    def kvbuf(*lead, quantized=quant):
        ax = tuple(lead) + ("batch", "kv_seq", "kv_heads", None)
        out = {"k": ax, "v": ax}
        if quantized:
            out["k_scale"] = ax
            out["v_scale"] = ax
        return out

    def rec_axes(*lead):
        return {"conv": tuple(lead) + ("batch", None, "lru"),
                "h": tuple(lead) + ("batch", None, "lru")}

    fam = cfg.family
    if fam in ("dense", "moe"):
        return {"attn": kvbuf("layers")}
    if fam == "vlm":
        return {"attn": kvbuf("layers", None),
                "cross": kvbuf("layers", quantized=False)}
    if fam == "audio":
        return {"attn": kvbuf("layers"),
                "cross": kvbuf("layers", quantized=False)}
    if fam == "hybrid":
        pat = cfg.hybrid.pattern
        out = {"groups": {f"b{i}": (rec_axes("layers") if kind == "recurrent"
                                    else kvbuf("layers"))
                          for i, kind in enumerate(pat)}}
        _, tail = hybrid_groups(cfg)
        if tail:
            out["tail"] = [rec_axes() if pat[i % len(pat)] == "recurrent"
                           else kvbuf() for i in range(tail)]
        return out
    if fam == "ssm":
        return {"blocks": {"conv": ("layers", "batch", None, "lru"),
                           "state": ("layers", "batch", "heads", None,
                                     None)}}
    raise ValueError(fam)


# a recurrent layer's prefill state by kind, as its layer of the cache
# (:func:`cache_axes` without the stacked leading axes)
STATE_AXES = {"recurrent": {"conv": ("batch", None, "lru"),
                            "h": ("batch", None, "lru")},
              "ssm": {"conv": ("batch", None, "lru"),
                      "state": ("batch", "heads", None, None)}}


def _leaves(tree) -> list:
    """A tree's leaves (dicts in sorted key order, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(template, leaves: list):
    """``leaves`` (consumed from the front) in ``template``'s structure,
    a logical-axes tree whose leaves are tuples."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, list):
        return [_rebuild(t, leaves) for t in template]
    return leaves.pop(0)


def _group(params: Params, prefix: str) -> nn.ParameterDict:
    return nn.ParameterDict({
        k[len(prefix):]: nn.Parameter(v, requires_grad=False)
        for k, v in params.items() if k.startswith(prefix)})


# ===========================================================================
# remat (repro.models.lm._maybe_remat)
# ===========================================================================

# the matrix products a [B, S, d] x [d, n] projection dispatches to: what
# the "block" policy keeps, as jax's dots_with_no_batch_dims_saveable keeps
# the dots without a batch dim (attention's and the experts' batched
# products are recomputed)
_SAVED_PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _save_products(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(plan: Plan, fn, *args):
    """``fn(*args)`` under ``plan.remat`` when autograd records it:
    ``none`` saves what autograd saves, ``block`` recomputes the block in
    the backward pass but for its projections' products
    (``torch.utils.checkpoint`` with a selective policy), ``full`` saves
    nothing but the block's inputs."""
    if plan.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if plan.remat == "block":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_products))
    if plan.remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    raise ValueError(f"unknown remat {plan.remat!r}")


# ===========================================================================
# modules
# ===========================================================================

def _used(rules, group, axes) -> dict:
    """A parameter group's weights as the products use them
    (:meth:`Rules.gathered`; the parameters themselves off a mesh)."""
    return {n: rules.gathered(w, axes[n]) for n, w in group.items()}


class DenseBlock(nn.Module):
    """One pre-norm decoder layer: GQA attention + FFN (dense, or the MoE
    under ``cfg.moe``), residual each; ``window`` > 0 is a sliding window
    (h2o-danube's, the hybrid's local attention) whose decode cache is a
    ring; ``causal=False`` is the audio encoder's layer (prefill only,
    never soft-capped: ``cfg.logit_softcap`` caps the decoder's self
    attention alone, as in the JAX package)."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str,
                 plan: Plan, window: int = 0, causal: bool = True,
                 rules=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.rules = rules or NullRules()
        self.window = window
        self.causal = causal
        # the decoder's self attention is capped; the audio encoder's is
        # not (the JAX encoder calls dense_attention without a cap)
        self.softcap = cfg.logit_softcap if causal else 0.0
        self.attn_norm = _group(params, f"{prefix}.attn_norm.")
        self.attn = _group(params, f"{prefix}.attn.")
        self.ffn_norm = _group(params, f"{prefix}.ffn_norm.")
        self.ffn = (moe.MoEWeights(params, f"{prefix}.ffn.")
                    if cfg.moe is not None
                    else _group(params, f"{prefix}.ffn."))
        self._attn_axes = layers.attn_axes(cfg)
        self._ffn_axes = layers.ffn_axes(cfg.ffn_act, cfg.use_bias)
        # LM.count_moe_drops: int64 [2, 3], rows prefill and decode
        self.moe_drops: Optional[torch.Tensor] = None

    def _moe_used(self) -> dict:
        """The MoE's weights as :func:`moe.apply_moe` takes them, gathered
        as :func:`_used` gathers a group."""
        axes = moe.moe_axes(self.cfg)
        out = {"router": self.rules.gathered(self.ffn.router,
                                             axes["router"])}
        for part in ("experts", "shared", "dense"):
            if part in axes:
                out[part] = _used(self.rules, self.ffn[part], axes[part])
        return out

    def _ffn(self, h, step: int, route_per_row: bool = False):
        """(h, aux): ``step`` 0 in prefill and training, 1 in decode (the
        row of ``moe_drops``); ``aux`` the MoE's Switch load-balance term
        (0.0 for a dense FFN)."""
        cfg, plan = self.cfg, self.plan
        x = layers.apply_norm(self.ffn_norm, h, cfg.norm)
        if cfg.moe is None:
            y = layers.apply_ffn(_used(self.rules, self.ffn, self._ffn_axes), x,
                                 cfg.ffn_act, cfg.use_bias)
            return h + self.rules.constrain(y, HIDDEN), 0.0
        kw = dict(drops=None if self.moe_drops is None
                  else self.moe_drops[step])
        if plan.moe_impl == "shardmap_ep" and not route_per_row:
            y, aux = moe.apply_moe_ep(self.ffn, cfg, x,
                                      plan.moe_capacity_factor,
                                      rules=self.rules, **kw)
        else:   # the grouped dispatch; per row, a group a row (the JAX
            # engine's vmap)
            groups = x.shape[0] * x.shape[1] if route_per_row \
                else plan.moe_groups
            y, aux = moe.apply_moe(self._moe_used(), cfg, x,
                                   plan.moe_capacity_factor, groups=groups,
                                   rules=self.rules, **kw)
        return h + self.rules.constrain(y, HIDDEN), aux

    def _qkv(self, h, rope, p):
        cfg = self.cfg
        x = layers.apply_norm(self.attn_norm, h, cfg.norm)
        q = layers.q_project(p, cfg, x)
        k, v = layers.kv_project(p, cfg, x)
        return layers.apply_rope(q, rope), layers.apply_rope(k, rope), v

    def _out(self, h, p, attn_out):
        y = layers.out_project(p, self.cfg, attn_out)
        return h + self.rules.constrain(y, HIDDEN)

    def _attend(self, h, rope):
        p = _used(self.rules, self.attn, self._attn_axes)
        q, k, v = self._qkv(h, rope, p)
        q = self.rules.constrain(q, layers.Q_AXES)
        k = self.rules.constrain(k, layers.KV_AXES)
        attn_out = layers.attention(q, k, v, causal=self.causal,
                                    window=self.window, softcap=self.softcap,
                                    plan=self.plan, rules=self.rules)
        return self._out(h, p, attn_out), (k, v)

    def prefill(self, h, rope):
        """h [B, S, d] -> (h, (k, v)) with the layer's post-RoPE K/V."""
        h, kv = self._attend(h, rope)
        return self._ffn(h, 0)[0], kv

    def train_forward(self, h, rope):
        """h [B, S, d] -> (h, the MoE's aux term or 0.0)."""
        return self._ffn(self._attend(h, rope)[0], 0)

    def decode(self, h, cache, pos, cache_len, rope,
               route_per_row: bool = False):
        """h [B, 1, d]; ``cache`` this layer's buffers ``{"k", "v"[,
        "k_scale", "v_scale"]}`` [B, W, KV, ·] (written in place at each
        row's slot); pos, cache_len int tensors [B]; ``route_per_row``
        routes each row through the MoE on its own."""
        p = _used(self.rules, self.attn, self._attn_axes)
        q, k, v = self._qkv(h, rope, p)
        k_cache, v_cache = cache["k"], cache["v"]
        w = k_cache.shape[1]
        # the JAX rule: the ring slot pos % w under a window, else
        # min(pos, w - 1)
        slot = pos % w if self.window else torch.clamp(pos, max=w - 1)
        if "k_scale" in cache:
            bufs = (k_cache, v_cache, cache["k_scale"], cache["v_scale"])
            layers.write_kv(bufs, (k, v), slot, self.rules, quant=True)
            attn_out = layers.decode_attention_quant(
                q, k_cache, cache["k_scale"], v_cache, cache["v_scale"],
                cache_len, softcap=self.softcap, rules=self.rules)
        else:
            layers.write_kv((k_cache, v_cache), (k, v), slot, self.rules)
            attn_out = layers.decode_attention(
                q, k_cache, v_cache, cache_len, window=self.window,
                softcap=self.softcap, rules=self.rules)
        return self._ffn(self._out(h, p, attn_out), 1, route_per_row)[0]


class CrossBlock(nn.Module):
    """Cross-attention over a context (the VLM's image embeddings, the
    audio encoder's output): pre-norm attention whose K/V are projected
    from the context (no RoPE, no norm on the context, never causal), then
    the block's own FFN, residual each
    (``repro.models.lm._apply_cross_block``).  Under a mesh each rank
    attends with its own heads (and the KV heads they read), over the
    whole context in prefill and its heads or ``kv_seq`` slice of the
    cross cache in decode."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str,
                 plan: Plan, rules=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.rules = rules or NullRules()
        self.attn_norm = _group(params, f"{prefix}.attn_norm.")
        self.attn = _group(params, f"{prefix}.attn.")
        self.ffn_norm = _group(params, f"{prefix}.ffn_norm.")
        self.ffn = _group(params, f"{prefix}.ffn.")
        self._attn_axes = layers.attn_axes(cfg)
        self._ffn_axes = layers.ffn_axes(cfg.ffn_act, cfg.use_bias)

    def _q(self, h, p):
        q = layers.q_project(p, self.cfg,
                             layers.apply_norm(self.attn_norm, h,
                                               self.cfg.norm))
        return self.rules.constrain(q, layers.Q_AXES)

    def _out(self, h, p, attn_out):
        cfg, rules = self.cfg, self.rules
        h = h + rules.constrain(layers.out_project(p, cfg, attn_out), HIDDEN)
        x = layers.apply_norm(self.ffn_norm, h, cfg.norm)
        y = layers.apply_ffn(_used(rules, self.ffn, self._ffn_axes), x,
                             cfg.ffn_act, cfg.use_bias)
        return h + rules.constrain(y, HIDDEN)

    def context_kv(self, ctx, p=None):
        """The context's K/V [B, S_ctx, KV, Dh]: what the cross cache
        holds (``p``: the attention's weights as :func:`_used` gives
        them)."""
        p = p or _used(self.rules, self.attn, self._attn_axes)
        k, v = layers.kv_project(p, self.cfg, ctx)
        return (self.rules.constrain(k, layers.KV_AXES),
                self.rules.constrain(v, layers.KV_AXES))

    def prefill(self, h, ctx):
        """h [B, S, d] over ctx [B, S_ctx, d] -> (h, (k, v)) with the
        context's K/V."""
        p = _used(self.rules, self.attn, self._attn_axes)
        k, v = self.context_kv(ctx, p)
        attn_out = layers.attention(self._q(h, p), k, v, causal=False,
                                    plan=self.plan, rules=self.rules)
        return self._out(h, p, attn_out), (k, v)

    def train_forward(self, h, ctx):
        return self.prefill(h, ctx)[0], 0.0

    def decode(self, h, cache, ctx_len):
        """h [B, 1, d]; ``cache`` this layer's ``{"k", "v"}`` [B, S_ctx,
        KV, Dh] (read, never written); ``ctx_len`` an int32 device tensor
        [B] of S_ctx (every row's whole context)."""
        p = _used(self.rules, self.attn, self._attn_axes)
        attn_out = layers.decode_attention(self._q(h, p), cache["k"],
                                           cache["v"], ctx_len,
                                           rules=self.rules)
        return self._out(h, p, attn_out)


class SSMBlock(nn.Module):
    """One mamba2 layer: pre-norm SSD mixer, residual
    (``repro.models.lm``'s ssm branch)."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str,
                 plan: Plan, rules=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.rules = rules or NullRules()
        self.norm = _group(params, f"{prefix}.norm.")
        self.ssm = _group(params, f"{prefix}.ssm.")
        self._axes = ssm.ssm_axes(cfg)

    def _mix(self, h, **kw):
        x = layers.apply_norm(self.norm, h, self.cfg.norm)
        return ssm.apply_ssm(_used(self.rules, self.ssm, self._axes),
                             self.cfg, x, chunk=self.plan.ssd_chunk,
                             bf16=self.plan.ssd_bf16, rules=self.rules, **kw)

    def prefill(self, h, rope=None):
        """h [B, S, d] -> (h, the decode state ``{"conv", "state"}``)."""
        y, st = self._mix(h, return_state=True)
        return h + self.rules.constrain(y, HIDDEN), st

    def train_forward(self, h, rope=None):
        return h + self.rules.constrain(self._mix(h), HIDDEN), 0.0

    def decode(self, h, cache, *_, **__):
        """h [B, 1, d]; ``cache`` this layer's ``{"conv", "state"}``,
        written in place."""
        x = layers.apply_norm(self.norm, h, self.cfg.norm)
        y = ssm.decode_ssm(_used(self.rules, self.ssm, self._axes),
                           self.cfg, x, cache, rules=self.rules)
        return h + self.rules.constrain(y, HIDDEN)


class RecurrentBlock(nn.Module):
    """The hybrid's recurrent block: pre-norm RG-LRU, then the FFN,
    residual each (``repro.models.lm._apply_recurrent_block``)."""

    def __init__(self, cfg: ModelConfig, params: Params, prefix: str,
                 plan: Plan, rules=None):
        super().__init__()
        self.cfg = cfg
        self.rules = rules or NullRules()
        self.norm = _group(params, f"{prefix}.norm.")
        self.lru = _group(params, f"{prefix}.lru.")
        self.ffn_norm = _group(params, f"{prefix}.ffn_norm.")
        self.ffn = _group(params, f"{prefix}.ffn.")
        self._lru_axes = rglru.rglru_axes(cfg)
        self._ffn_axes = layers.ffn_axes(cfg.ffn_act, cfg.use_bias)

    def _ffn(self, h, y):
        """The residual of the recurrence's output ``y``, then the FFN's."""
        cfg, rules = self.cfg, self.rules
        h = h + rules.constrain(y, HIDDEN)
        x = layers.apply_norm(self.ffn_norm, h, cfg.norm)
        y = layers.apply_ffn(_used(rules, self.ffn, self._ffn_axes), x,
                             cfg.ffn_act, cfg.use_bias)
        return h + rules.constrain(y, HIDDEN)

    def _lru(self):
        return _used(self.rules, self.lru, self._lru_axes)

    def prefill(self, h, rope=None):
        """h [B, S, d] -> (h, the decode state ``{"conv", "h"}``)."""
        x = layers.apply_norm(self.norm, h, self.cfg.norm)
        y, st = rglru.apply_rglru(self._lru(), self.cfg, x,
                                  return_state=True, rules=self.rules)
        return self._ffn(h, y), st

    def train_forward(self, h, rope=None):
        x = layers.apply_norm(self.norm, h, self.cfg.norm)
        return self._ffn(h, rglru.apply_rglru(self._lru(), self.cfg, x,
                                              rules=self.rules)), 0.0

    def decode(self, h, cache, *_, **__):
        """h [B, 1, d]; ``cache`` this block's ``{"conv", "h"}``, written
        in place."""
        x = layers.apply_norm(self.norm, h, self.cfg.norm)
        return self._ffn(h, rglru.decode_rglru(self._lru(), self.cfg, x,
                                               cache, rules=self.rules))


class LM(nn.Module):
    """The LM over ``params`` (a state dict from :func:`init_params` or
    :func:`repro_torch.models.convert.params_from_numpy`); it runs where
    its parameters lie.  Its weights take no gradient (serving) until
    ``requires_grad_(True)`` (``repro_torch.train.train_step``).  ``rules``
    (default :class:`NullRules`) with a sharded mesh partition every
    family (the module docstring: ``params``, whole on every rank, are
    placed here; on a mesh with a "pod" axis, on this rank's pod's
    sub-mesh, which ``rules`` then holds) but the MoE under
    ``plan.moe_impl == "shardmap_ep"``, whose experts then run
    expert-parallel over the rules' mesh (:func:`moe.apply_moe_ep`) on
    whole parameters (:meth:`_partitions`)."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 plan: Optional[Plan] = None, rules=None):
        super().__init__()
        self.plan = plan or Plan()
        self.rules = rules or NullRules()
        check_supported(cfg, self.plan)
        self.cfg = cfg
        if self._partitions():
            if "pod" in self.rules.shape:
                self.rules = self.rules.without("pod")
            params = self.rules.distribute(params, param_axes(cfg))
        # sqrt(d_model) rounded to the activation type once, as the JAX
        # _embed rounds it: a Python float multiplies with no host copy
        self._embed_scale = float(torch.tensor(math.sqrt(cfg.d_model),
                                               dtype=torch_dtype(cfg.dtype)))
        self.embed = nn.Parameter(params["embed"], requires_grad=False)
        self.final_norm = _group(params, "final_norm.")
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(params["unembed"],
                                        requires_grad=False)
        built = [(kind, self._block(params, name, kind))
                 for name, kind in _layer_names(cfg)]
        # every decoder layer in execution order; the audio encoder's apart
        self.layers: List[nn.Module] = [blk for kind, blk in built
                                        if kind != "encoder"]
        if cfg.family == "vlm":
            groups, per = vlm_groups(cfg)
            self.self_blocks = nn.ModuleList(
                nn.ModuleList(self.layers[g * (per + 1):][:per])
                for g in range(groups))
            self.cross_blocks = nn.ModuleList(
                self.layers[g * (per + 1) + per] for g in range(groups))
        elif cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(blk for kind, blk in built
                                            if kind == "encoder")
            self.enc_norm = _group(params, "enc_norm.")
            self.dec_blocks = nn.ModuleList(
                nn.ModuleDict({"self": self.layers[2 * i],
                               "cross": self.layers[2 * i + 1]})
                for i in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            n = len(cfg.hybrid.pattern)
            groups, _ = hybrid_groups(cfg)
            self.blocks = nn.ModuleList(
                nn.ModuleDict({f"b{j}": self.layers[g * n + j]
                               for j in range(n)})
                for g in range(groups))
            self.tail = nn.ModuleList(self.layers[groups * n:])
        else:
            self.blocks = nn.ModuleList(self.layers)
        if set(self.state_dict()) != set(params):
            raise ValueError(
                f"params do not fit {cfg.name}: extra "
                f"{sorted(set(params) - set(self.state_dict()))[:5]}, "
                f"missing {sorted(set(self.state_dict()) - set(params))[:5]}")

    def _partitions(self) -> bool:
        """Whether the rules partition this LM: a mesh axis other than
        "pod" past one device, but not the expert-parallel MoE (whole
        parameters, explicit collectives)."""
        rules = self.rules
        excluded = ("pod",) + tuple(getattr(rules, "exclude_axes", ()))
        inner = [n for a, n in getattr(rules, "shape", {}).items()
                 if a not in excluded]
        return (any(n > 1 for n in inner)
                and not (self.cfg.moe is not None
                         and self.plan.moe_impl == "shardmap_ep"))

    def _block(self, params: Params, prefix: str, kind: str) -> nn.Module:
        cfg, plan, rules = self.cfg, self.plan, self.rules
        if kind == "ssm":
            return SSMBlock(cfg, params, prefix, plan, rules)
        if kind == "recurrent":
            return RecurrentBlock(cfg, params, prefix, plan, rules)
        if kind == "cross":
            return CrossBlock(cfg, params, prefix, plan, rules)
        if kind == "encoder":
            return DenseBlock(cfg, params, prefix, plan, causal=False,
                              rules=rules)
        # the hybrid's local attention runs at cfg.window although its
        # attn_kind is "local", as the JAX hybrid branch passes it
        window = cfg.window if cfg.family == "hybrid" else _window_of(cfg)
        return DenseBlock(cfg, params, prefix, plan, window,
                          rules=self.rules)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    @property
    def partitioned(self) -> bool:
        """Whether the parameters are DTensors over the rules' mesh."""
        return isinstance(self.embed, DTensor)

    def _place(self, x, axes):
        """A whole input (the same on every rank) placed by its logical
        axes when the LM is partitioned; unchanged otherwise."""
        return self.rules.place(x, axes) if self.partitioned else x

    # ------------------------------------------------------------- pieces
    def _embed(self, tokens):
        """The scaled embedding of ``tokens`` [B, S].  Over a vocabulary
        split across ranks each rank looks up the tokens its rows hold and
        the rows are summed over the split (``_embed`` in the reference:
        ``take``, then the constraint)."""
        rules = self.rules
        table = rules.gathered(self.embed, ("vocab", "embed"))
        tokens = self._place(tokens, BATCH_SEQ)
        start, group = rules.offset(table, 0), rules.group(table, 0)

        def lookup(table, tokens):
            if group is None:
                return table[tokens.long()]
            local = tokens.long() - start
            hit = (local >= 0) & (local < table.shape[0])
            rows = torch.nn.functional.embedding(
                torch.where(hit, local, 0), table)
            return col.sum_replicated(
                torch.where(hit[..., None], rows, 0.0), group)

        h = rules.local(lookup, (("vocab", None), BATCH_SEQ), HIDDEN)(
            table, tokens)
        return rules.constrain(h.to(self.dtype) * self._embed_scale, HIDDEN)

    def _rope(self, positions):
        rope = layers.rope_table(positions, self.cfg.head_dim,
                                 self.cfg.rope_theta)
        lead = ("batch",) if positions.dim() == 2 else ()
        return tuple(self._place(t, lead + (None,) * (t.dim() - len(lead)))
                     for t in rope)

    def _unembed_matrix(self):
        """[d, V_pad] as the logits' product uses it."""
        if self.cfg.tie_embeddings:
            return self.rules.gathered(self.embed, ("vocab", "embed")).T
        return self.rules.gathered(self.unembed, ("embed", "vocab"))

    def logits_for(self, hidden):
        """Full fp32 logits for a short hidden slice, padded vocab masked
        (on each rank's part of the vocabulary under a mesh)."""
        logits = torch.matmul(hidden, self._unembed_matrix()).float()
        logits = self.rules.constrain(logits, LOGITS)
        return self._mask_pad(logits)

    def _mask_pad(self, logits):
        """``logits`` [B, S, V_pad] with the padded vocabulary at
        ``NEG_INF``."""
        v = self.cfg.vocab_size
        if self.cfg.padded_vocab == v:
            return logits
        start = self.rules.offset(logits, 2)

        def mask(logits):
            cols = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(cols + start >= v, layers.NEG_INF, logits)

        return self.rules.local(mask, (LOGITS,), LOGITS)(logits)

    def count_moe_drops(self) -> torch.Tensor:
        """Count the MoE's routed and dropped (token, k) pairs from now on:
        returns the int64 ``[2, 3]`` counter on the model's device (rows
        prefill and decode; columns pairs routed, pairs dropped, and
        experts routed to, per layer and call), which every MoE layer adds
        to in place, inside a captured decode step too (an engine's graph
        keeps the counter set when it was captured, so call this before
        building the engine).  Zero it to start again."""
        counts = torch.zeros((2, 3), dtype=torch.long, device=self.device)
        for blk in self.layers:
            if isinstance(blk, DenseBlock):
                blk.moe_drops = counts
        return counts

    def init_cache(self, batch: int, seq_len: int) -> Cache:
        cache = init_cache(self.cfg, batch, seq_len, device=self.device,
                           quant=self.plan.kv_cache_quant)
        if self.partitioned:
            cache = self.rules.distribute(
                cache, cache_axes(self.cfg, self.plan.kv_cache_quant))
        return cache

    def context(self, batch, b: int) -> Optional[torch.Tensor]:
        """The modality context of a VLM or audio ``batch`` (None for the
        other families) on the model's device in its activation type, [B,
        S_ctx, d]: the image embeddings, or the audio encoder's output over
        the frames.  Any dtype and device is taken (numpy too); a batch
        without its context, or with one of another batch or width,
        raises."""
        key = CONTEXT_KEYS.get(self.cfg.family)
        if key is None:
            return None
        if batch.get(key) is None:
            raise ValueError(f"a {self.cfg.family} batch needs its context "
                             f"{key!r} [B, S, d_model]")
        ctx = batch[key]
        if not isinstance(ctx, torch.Tensor):
            arr = np.asarray(ctx)
            if arr.dtype.kind not in "biuf":    # bfloat16 and the like
                arr = arr.astype(np.float32)
            ctx = torch.from_numpy(arr)
        ctx = ctx.to(self.device, self.dtype)
        if ctx.dim() != 3 or ctx.shape[0] != b \
                or ctx.shape[2] != self.cfg.d_model:
            raise ValueError(f"{key} of shape {tuple(ctx.shape)} does not "
                             f"fit a batch of {b} at d_model "
                             f"{self.cfg.d_model}")
        ctx = self._place(ctx, HIDDEN)
        return self.encode(ctx) if self.cfg.family == "audio" else ctx

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The audio encoder (``repro.models.lm.encode_audio``): frames [B,
        S, d] through the non-causal layers (each under the plan's remat
        when autograd records it), RoPE at positions 0..S-1, then
        ``enc_norm``."""
        rope = self._rope(torch.arange(frames.shape[1], device=self.device))
        h = frames
        for blk in self.enc_blocks:
            h, _ = remat(self.plan, blk.train_forward, h, rope)
        return layers.apply_norm(self.enc_norm, h, self.cfg.norm)

    def backbone(self, h, rope, ctx, collect: bool = False):
        """The layer walk that prefill and training share
        (``repro.models.lm._backbone``): h [B, S, d] -> (h, aux, states).
        With ``collect`` each layer's prefill state (K/V or recurrent
        state) is kept in ``states``; otherwise (training) each layer runs
        under the plan's remat, ``states`` is None and ``aux`` sums the
        MoE layers' load-balance terms (fp32)."""
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        states = [] if collect else None
        for blk in self.layers:
            arg = ctx if isinstance(blk, CrossBlock) else rope
            if collect:
                h, st = blk.prefill(h, arg)
                states.append(st)
            else:
                h, a = remat(self.plan, blk.train_forward, h, arg)
                aux = aux + a
        return h, aux, states

    def chunked_softmax_xent(self, hidden, labels) -> torch.Tensor:
        """Mean cross-entropy of ``hidden`` [B, S, d] (final-normed) against
        ``labels`` [B, S] (``repro.models.lm.chunked_softmax_xent``): the
        sequence in chunks of ``plan.vocab_chunk`` positions (0, or one that
        does not divide S: one chunk), each chunk's fp32 logits [B, chunk,
        V] recomputed in the backward pass (``torch.utils.checkpoint``, as
        ``jax.checkpoint``), so the [B, S, V] logits never exist; the
        padded vocabulary is masked."""
        b, s, _ = hidden.shape
        chunk = min(self.plan.vocab_chunk or s, s)
        if s % chunk:
            chunk = s
        labels = self._place(labels, BATCH_SEQ)
        total = None
        for c0 in range(0, s, chunk):
            part = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk])
            if torch.is_grad_enabled():
                got = ckpt.checkpoint(self._xent_sum, *part,
                                      use_reentrant=False)
            else:
                got = self._xent_sum(*part)
            total = got if total is None else total + got
        return total / (b * s)

    def _xent_sum(self, hidden, labels):
        """The chunk's summed cross-entropy.  Over a vocabulary split
        across ranks the log-sum-exp is merged over the split (a max, then a
        sum of each rank's exponentials) and the gold logit is summed from
        the rank that holds it."""
        logits = torch.matmul(hidden, self._unembed_matrix()).float()
        logits = self._mask_pad(self.rules.constrain(logits, LOGITS))
        start = self.rules.offset(logits, 2)
        group = self.rules.group(logits, 2)

        def rows(logits, labels):
            if group is None:
                lse = torch.logsumexp(logits, dim=-1)
                gold = logits.gather(-1, labels[..., None].long())[..., 0]
                return lse - gold
            top = col.max_replicated(logits.amax(-1), group)
            lse = torch.log(col.sum_replicated(
                torch.exp(logits - top[..., None]).sum(-1), group)) + top
            local = labels.long() - start
            hit = (local >= 0) & (local < logits.shape[-1])
            gold = logits.gather(-1, torch.where(hit, local, 0)[..., None])
            gold = col.sum_replicated(torch.where(hit, gold[..., 0], 0.0),
                                      group)
            return lse - gold

        return torch.sum(self.rules.local(rows, (LOGITS, BATCH_SEQ),
                                          BATCH_SEQ)(logits, labels))

    @contextlib.contextmanager
    def rules_as(self, rules) -> Iterator[None]:
        """Run with ``rules`` in place of the LM's own, in every layer that
        holds rules (the pod-parallel step's inner rules over an LM with
        whole parameters, which exclude the "pod" axis its ranks have
        already split)."""
        held = [(m, m.rules) for m in self.modules() if hasattr(m, "rules")]
        for m, _ in held:
            m.rules = rules
        try:
            yield
        finally:
            for m, old in held:
                m.rules = old

    def params(self) -> Dict[str, nn.Parameter]:
        """The LM's parameters by state-dict name (what the optimizer
        state and a checkpoint are keyed by)."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def load_params(self, params) -> Dict[str, nn.Parameter]:
        """Copy ``params`` (name -> tensor or array, e.g. a restored
        checkpoint) into the LM's parameters, but for those that already
        are them; returns :meth:`params`."""
        own = self.params()
        if set(params) != set(own):
            raise ValueError(f"params do not fit {self.cfg.name}: "
                             f"{sorted(set(params) ^ set(own))[:5]}")
        for name, p in own.items():
            if params[name] is not p:
                p.copy_(torch.as_tensor(params[name]))
        return own

    # --------------------------------------------------------- entry points
    def prefill(self, batch, cache_len: int) -> Tuple[torch.Tensor, Cache]:
        """Full-prompt pass over ``batch["tokens"]`` [B, S] (and, for the
        VLM and audio families, its context: :meth:`context`); returns the
        last position's logits [B, V] and a decode cache of
        ``cache_len``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        h, rope, ctx = self._inputs(batch, tokens)
        h, _, collected = self.backbone(h, rope, ctx, collect=True)
        last = layers.apply_norm(self.final_norm, h[:, -1:], self.cfg.norm)
        if self.partitioned:
            cache = self._assemble_placed(collected, cache_len)
        else:
            cache = assemble_cache(self.cfg, collected, cache_len,
                                   quant=self.plan.kv_cache_quant)
        return whole(self.logits_for(last)[:, 0]), cache

    def _assemble_placed(self, collected, cache_len: int) -> Cache:
        """The decode cache from the layers' prefill outputs as DTensors
        (K/V, cross K/V, recurrent states): each rank assembles its own
        rows, heads and channels (:func:`assemble_cache` on local tensors,
        quantizing an int8 cache), then the cache is placed by
        :func:`cache_axes` (under ``decode_kv_seq_shard`` each rank keeps
        its slice of the slots)."""
        quant = self.plan.kv_cache_quant
        axes = cache_axes(self.cfg, quant)
        kinds = [kind for _, kind in _layer_names(self.cfg)
                 if kind != "encoder"]
        flat, in_axes, layout = [], [], []
        for st, kind in zip(collected, kinds):
            names = sorted(st) if isinstance(st, dict) else None
            flat += [st[n] for n in names] if names else list(st)
            in_axes += ([STATE_AXES[kind][n] for n in names] if names
                        else [layers.KV_AXES] * 2)
            layout.append(names)

        def build(*ts):
            it = iter(ts)
            states = [{n: next(it) for n in names} if names
                      else (next(it), next(it)) for names in layout]
            return _leaves(assemble_cache(self.cfg, states, cache_len,
                                          quant=quant))

        # the slots are whole here: the ring is built on each rank's rows
        out_axes = [tuple(None if a == "kv_seq" else a for a in ax)
                    for ax in _leaves(axes)]
        got = self.rules.local(build, in_axes, out_axes)(*flat)
        return self.rules.distribute(_rebuild(axes, list(got)), axes)

    def init_context_cache(self, batch, batch_size: int,
                           cache_len: int) -> Cache:
        """A decode cache at position 0 whose cross K/V are already those
        of ``batch``'s context (``Model.init_context_cache``): decoding
        token by token from it equals a prefill.  Other families get
        :meth:`init_cache`."""
        cache = self.init_cache(batch_size, cache_len)
        ctx = self.context(batch, batch_size)
        if ctx is not None:
            kvs = [t for blk in self.layers if isinstance(blk, CrossBlock)
                   for t in blk.context_kv(ctx)]

            def stack(*kvs):
                return [torch.stack(kvs[0::2]), torch.stack(kvs[1::2])]

            out = ("layers",) + layers.KV_AXES
            k, v = self.rules.local(stack, [layers.KV_AXES] * len(kvs),
                                    [out, out])(*kvs)
            cache["cross"] = {"k": k, "v": v}
            if self.partitioned:
                cache["cross"] = self.rules.distribute(
                    cache["cross"], cache_axes(self.cfg)["cross"])
        return cache

    def decode_step(self, cache: Cache, tokens, pos, *,
                    route_per_row: bool = False
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. ``tokens`` [B, 1]; ``pos`` the absolute position,
        an int or an int tensor [B] (one per row).  Writes ``cache`` in
        place and returns it with the logits [B, V].  ``route_per_row``
        routes each row through the MoE as its own group (the continuous
        batcher's slots, as the JAX engine's ``vmap``); otherwise the rows
        are routed together, as ``generate`` does.  Cross layers attend
        over the whole context."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b = tokens.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long().reshape(-1)
        pos = pos.expand(b).contiguous()
        h = self._embed(tokens)
        per_layer = layer_caches(self.cfg, cache)
        # the self-attention buffers' length (a cross cache's is the
        # context's)
        rings = [c["k"].shape[1] for blk, c in zip(self.layers, per_layer)
                 if isinstance(blk, DenseBlock)]
        cross = [c for blk, c in zip(self.layers, per_layer)
                 if isinstance(blk, CrossBlock)]
        cache_len = rope = ctx_len = None
        if rings:
            cache_len = torch.clamp(pos + 1, max=rings[0]).to(torch.int32)
            rope = self._rope(pos[:, None])
            pos = self._place(pos, ("batch",))
            cache_len = self._place(cache_len, ("batch",))
        if cross:       # a device fill: a captured step copies no host data
            ctx_len = self._place(torch.full(
                (b,), cross[0]["k"].shape[1], dtype=torch.int32,
                device=self.device), ("batch",))
        for blk, c in zip(self.layers, per_layer):
            if isinstance(blk, CrossBlock):
                h = blk.decode(h, c, ctx_len)
            else:
                h = blk.decode(h, c, pos, cache_len, rope, route_per_row)
        h = layers.apply_norm(self.final_norm, h, self.cfg.norm)
        return whole(self.logits_for(h)[:, 0]), cache

    def _inputs(self, batch, tokens):
        """(embedded tokens, the RoPE table of positions 0..S-1 (None for
        the SSM), the modality context) of a prefill or training batch."""
        b, s = tokens.shape
        ctx = self.context(batch, b)
        rope = (self._rope(torch.arange(s, device=self.device))
                if self.cfg.family != "ssm" else None)
        return self._embed(tokens), rope, ctx

    def train_loss(self, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(total, {"loss", "aux_loss"}) of ``batch["tokens"]`` against
        ``batch["labels"]`` [B, S] (and the VLM's or audio family's
        context), as ``Model.train_loss``: the chunked cross-entropy
        ``loss`` plus 0.01 times the MoE layers' summed ``aux_loss``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        h, rope, ctx = self._inputs(batch, tokens)
        h, aux, _ = self.backbone(h, rope, ctx)
        h = layers.apply_norm(self.final_norm, h, self.cfg.norm)
        loss = whole(self.chunked_softmax_xent(h, labels))
        return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ===========================================================================
# decode caches
# ===========================================================================

def _kv_buf(shape, dt, dev, quant: bool) -> Dict[str, torch.Tensor]:
    if quant:
        scales = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(scales, dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(scales, dtype=torch.float32,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _stacked(n: int, state: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    return {k: v.new_zeros((n, *v.shape)) for k, v in state.items()}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None, quant: bool = False) -> Cache:
    """Zeroed decode caches in the JAX layout (module docstring): K/V
    buffers of ``W = min(seq_len, window)`` slots (``seq_len`` without a
    window) in ``cfg.dtype``, int8 with fp32 scales under ``quant``
    (dense, MoE and the VLM and audio self-attention, as in JAX; never the
    cross K/V, which hold the config's context length); recurrent and SSM
    state with their conv state in ``cfg.dtype`` and the rest in
    float32."""
    check_supported(cfg)
    dev = resolve(device)
    dt = torch_dtype(cfg.dtype)
    kv = (batch, _kv_cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.head_dim)
    if cfg.family == "ssm":
        return {"blocks": _stacked(cfg.n_layers,
                                   ssm.init_ssm_cache(cfg, batch, dt, dev))}
    if cfg.family in CONTEXT_KEYS:
        ctx = (batch, cfg.n_img_tokens if cfg.family == "vlm"
               else cfg.n_frames, cfg.n_kv_heads, cfg.head_dim)
        lead = vlm_groups(cfg) if cfg.family == "vlm" else (cfg.n_layers,)
        return {"attn": _kv_buf((*lead, *kv), dt, dev, quant),
                "cross": _kv_buf((lead[0], *ctx), dt, dev, False)}
    if cfg.family != "hybrid":
        return {"attn": _kv_buf((cfg.n_layers, *kv), dt, dev, quant)}

    def block(kind, *lead):
        if kind == "recurrent":
            st = rglru.init_rglru_cache(cfg, batch, dt, dev)
            return _stacked(lead[0], st) if lead else st
        return _kv_buf((*lead, *kv), dt, dev, False)

    pat = cfg.hybrid.pattern
    groups, tail = hybrid_groups(cfg)
    out: Cache = {"groups": {f"b{j}": block(kind, groups)
                             for j, kind in enumerate(pat)}}
    if tail:
        out["tail"] = [block(pat[i % len(pat)]) for i in range(tail)]
    return out


def layer_caches(cfg: ModelConfig, cache: Cache
                 ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's cache in execution order, as views into ``cache`` (a
    write into one is a write into the pool)."""
    if cfg.family == "ssm":
        return [{k: v[i] for k, v in cache["blocks"].items()}
                for i in range(cfg.n_layers)]
    if cfg.family == "vlm":
        groups, per = vlm_groups(cfg)
        return [c for g in range(groups) for c in
                [{k: v[g, j] for k, v in cache["attn"].items()}
                 for j in range(per)]
                + [{k: v[g] for k, v in cache["cross"].items()}]]
    if cfg.family == "audio":
        return [{k: v[i] for k, v in cache[part].items()}
                for i in range(cfg.n_layers) for part in ("attn", "cross")]
    if cfg.family != "hybrid":
        return [{k: v[i] for k, v in cache["attn"].items()}
                for i in range(cfg.n_layers)]
    pat = cfg.hybrid.pattern
    groups, _ = hybrid_groups(cfg)
    return ([{k: v[g] for k, v in cache["groups"][f"b{j}"].items()}
             for g in range(groups) for j in range(len(pat))]
            + list(cache.get("tail", [])))


def slot_leaves(cache: Cache) -> Iterator[Tuple[str, torch.Tensor, int]]:
    """Every tensor of a decode cache as (dotted name, tensor, batch (slot)
    axis): the K/V buffers of ``attn`` and ``cross`` end in [B, W, KV, Dh]
    (or ``[..., 1]`` scales) after the layers they stack (the VLM's
    ``attn``: groups and layers, axis 2); the SSM's and the hybrid's
    groups stack one axis (axis 1); the hybrid's tail (``tail.{i}.…``)
    none (axis 0)."""
    for top, sub in cache.items():
        if isinstance(sub, list):
            for i, part in enumerate(sub):
                for name, leaf in flatten(part, f"{top}.{i}.").items():
                    yield name, leaf, 0
        else:
            for name, leaf in flatten(sub, f"{top}.").items():
                yield name, leaf, (leaf.dim() - 4 if top in ("attn", "cross")
                                   else 1)


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


def _place_kv(kvs, kvl: int, dt, quant: bool) -> Dict[str, torch.Tensor]:
    """Stacked (k, v) [..., B, S, KV, Dh] into ring buffers of ``kvl``."""
    ks = torch.stack([k for k, _ in kvs])
    vs = torch.stack([v for _, v in kvs])
    if quant:
        (kq, k_s), (vq, v_s) = layers.quantize_kv(ks), layers.quantize_kv(vs)
        return {"k": _ring_place(kq, kvl, torch.int8),
                "v": _ring_place(vq, kvl, torch.int8),
                "k_scale": _ring_place(k_s, kvl, torch.float32),
                "v_scale": _ring_place(v_s, kvl, torch.float32)}
    return {"k": _ring_place(ks, kvl, dt), "v": _ring_place(vs, kvl, dt)}


def _stack_states(states) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def assemble_cache(cfg: ModelConfig, collected, cache_len: int,
                   quant: bool = False) -> Cache:
    """Turn the prefill's per-layer outputs, in execution order (an
    attention layer's post-RoPE (k, v) [B, S, KV, Dh], a cross layer's
    context (k, v) [B, S_ctx, KV, Dh], a recurrent or SSM layer's state),
    into a decode cache at position S for ``cache_len``
    positions (the window's ring under a window), K/V in ``cfg.dtype``;
    with ``quant`` the dense and MoE K/V are quantized first (int8 and
    fp32 scales), as the JAX cache is."""
    dt = torch_dtype(cfg.dtype)
    kvl = _kv_cache_len(cfg, cache_len)
    if cfg.family == "ssm":
        return {"blocks": _stack_states(collected)}
    if cfg.family in CONTEXT_KEYS:
        kinds = [kind for _, kind in _layer_names(cfg) if kind != "encoder"]
        attn = _place_kv([st for st, kind in zip(collected, kinds)
                          if kind == "dense"], kvl, dt, quant)
        if cfg.family == "vlm":
            attn = {k: v.unflatten(0, vlm_groups(cfg))
                    for k, v in attn.items()}
        cross = [st for st, kind in zip(collected, kinds) if kind == "cross"]
        return {"attn": attn,
                "cross": {"k": torch.stack([k for k, _ in cross]).to(dt),
                          "v": torch.stack([v for _, v in cross]).to(dt)}}
    if cfg.family != "hybrid":
        return {"attn": _place_kv(collected, kvl, dt, quant)}

    def place(kind, got):
        if kind == "recurrent":
            return _stack_states(got)
        return _place_kv(got, kvl, dt, False)

    pat = cfg.hybrid.pattern
    groups, tail = hybrid_groups(cfg)
    n = len(pat)
    if groups:
        out: Cache = {"groups": {f"b{j}": place(kind, collected[j::n][:groups])
                                 for j, kind in enumerate(pat)}}
    else:               # the JAX scan over no group: empty stacks
        first = collected[0]
        t = next(iter(first.values())) if isinstance(first, dict) \
            else first[0]
        out = {"groups": init_cache(cfg, t.shape[0], cache_len,
                                    t.device)["groups"]}
    if tail:
        out["tail"] = [dict(st) if pat[i % n] == "recurrent" else
                       {k: v[0] for k, v in place(pat[i % n], [st]).items()}
                       for i, st in enumerate(collected[groups * n:])]
    return out
