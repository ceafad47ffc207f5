"""Core layers of the dense LM family: norms, RoPE, projections, attention
(prefill and decode), FFNs — the port of ``repro.models.layers``.

Functions keep the JAX layouts: activations ``[B, S, D]``, query heads
``[B, S, H, Dh]``, KV heads ``[B, S, KV, Dh]``, weights ``wq [d, h, hd]``,
``wk``/``wv [d, kv, hd]``, ``wo [h, hd, d]``.  Grouped-query attention never
repeats the KV heads per query head: the attention kernels read KV head
``h // (H // KV)`` in place, as the JAX ``_group_q`` layout (``H -> (KV,
rep)``, KV-major) does.

Attention goes through :mod:`repro_torch.kernels.ops` — the hand-written
flash-attention kernel for prefill and the split-K decode kernel for decode
on the card, their plain versions on the CPU.  The projections and the FFN
are plain ``torch.matmul``: the JAX package leaves them to XLA, outside any
Pallas kernel.  So are the int8 KV cache's :func:`quantize_kv` and
:func:`decode_attention_quant`: the JAX package computes them in jnp, not in
a Pallas kernel.

The RoPE angles are built once per model call (:func:`rope_table`) and
handed to every layer's :func:`apply_rope`.

Under a mesh (``dist.sharding.Rules``) the activations and weights are
DTensors and the plain torch ops partition themselves; the kernels run
inside :meth:`Rules.local` on each rank's own heads (:func:`attention`,
:func:`decode_attention`, and the int8 cache's plain
:func:`decode_attention_quant`) or its slice of the cache's ``kv_seq``
axis, and :func:`write_kv` writes (and for the int8 cache quantizes) a
decode step's K/V into each rank's part of the cache.  Without a mesh (``NullRules``, plain tensors) they are the
calls they always were.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import NullRules
from repro_torch.kernels import ops

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free
LOG2E = 1.0 / math.log(2.0)

# logical axes of the attention operands (the reference's constraints)
Q_AXES = ("batch", None, "heads", None)          # q [B, S, H, Dh]
KV_AXES = ("batch", None, "kv_heads", None)      # k, v [B, S, KV, Dh]
CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)   # a layer's [B, W, KV, D]


def not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item "
        f"{item})")


# ---------------------------------------------------------------------------
# init helpers (the JAX distributions: N(0, 1/fan_in) and N(0, 0.02^2))
# ---------------------------------------------------------------------------

def dense_init(shape, in_axis_size, dtype, generator, device):
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def init_ffn(d: int, hidden: int, act: str, use_bias: bool, dtype,
             generator, device, n: int = 0) -> dict:
    """An FFN's weights (``repro.models.layers.init_ffn``), or ``n`` of them
    stacked on a leading axis (an MoE's experts), drawn one at a time so
    that a float32 draw never holds more than one (at once on the meta
    device, where a draw holds nothing: ``launch.specs``)."""
    def dense(shape, fan_in):
        if not n or torch.device(device).type == "meta":
            return dense_init(((n,) if n else ()) + shape, fan_in, dtype,
                              generator, device)
        out = torch.empty((n, *shape), dtype=dtype, device=device)
        for e in range(n):
            out[e] = dense_init(shape, fan_in, dtype, generator, device)
        return out

    p = {"w_in": dense((d, hidden), d), "w_out": dense((hidden, d), hidden)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = dense((d, hidden), d)
    if use_bias:
        p["b_in"] = torch.zeros(hidden, dtype=dtype, device=device)
        p["b_out"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def ffn_axes(act: str, use_bias: bool) -> dict:
    """An FFN's logical axes (``repro.models.layers.ffn_axes``)."""
    p = {"w_in": ("embed", "ff"), "w_out": ("ff", "embed")}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = ("embed", "ff")
    if use_bias:
        p["b_in"] = ("ff",)
        p["b_out"] = (None,)
    return p


def norm_axes(kind: str) -> dict:
    p = {"scale": (None,)}
    if kind == "layernorm":
        p["bias"] = (None,)
    return p


def attn_axes(cfg) -> dict:
    p = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.use_bias:
        p.update({"bq": ("heads", None), "bk": ("kv_heads", None),
                  "bv": ("kv_heads", None), "bo": (None,)})
    return p


def embed_init(shape, dtype, generator, device):
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(p, x, kind, eps=1e-6):
    """RMSNorm or LayerNorm (``p["bias"]``) over the last dim, in fp32."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_table(positions, head_dim: int, theta: float):
    """(cos, sin) of the RoPE angles, fp32 ``[B?, S, 1, head_dim // 2]``,
    for positions [S] or [B, S] (int): built once per model call and shared
    by every layer's queries and keys."""
    freqs = rope_freqs(head_dim, theta, positions.device)         # [half]
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., :, None] * freqs                            # [B?,S,half]
    return (torch.cos(angles)[..., :, None, :],               # [B?,S,1,half]
            torch.sin(angles)[..., :, None, :])


def apply_rope(x, rope):
    """x [B, S, H, Dh]; ``rope`` = :func:`rope_table` at x's positions."""
    half = x.shape[-1] // 2
    cos, sin = rope
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def _project(x, w, b):
    """x [B, S, d] @ w [d, n, k] (+ b [n, k]) -> [B, S, n, k]."""
    d, n, k = w.shape
    y = torch.matmul(x, w.reshape(d, n * k)).reshape(*x.shape[:-1], n, k)
    return y if b is None else y + b


def q_project(p, cfg, x):
    return _project(x, p["wq"], p.get("bq") if cfg.use_bias else None)


def kv_project(p, cfg, x):
    bias = cfg.use_bias
    return (_project(x, p["wk"], p.get("bk") if bias else None),
            _project(x, p["wv"], p.get("bv") if bias else None))


def out_project(p, cfg, attn_out):
    """attn_out [B, S, H, Dh] @ wo [H, Dh, d] -> [B, S, d]."""
    h, k, d = p["wo"].shape
    y = torch.matmul(attn_out.reshape(*attn_out.shape[:-2], h * k),
                     p["wo"].reshape(h * k, d))
    return y + p["bo"] if cfg.use_bias else y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def local_kv_heads(tensors: Sequence, h_local: int, h0: int, group: int,
                   dim: int = 2):
    """(tensors, kv_group) for ``h_local`` query heads from global head
    ``h0`` that read KV head ``h // group``; ``tensors`` share the KV-head
    axis ``dim`` (K and V, or an int8 cache's values and scales).  They
    are as they are when they hold exactly those heads' KV heads
    (``KV * group == h_local``), else, KV whole while the query heads are
    split (the divisibility fallback), only the KV heads these query heads
    read: a slice when each is read by the same number of them, one KV
    head a query head otherwise."""
    if tensors[0].shape[dim] * group == h_local:
        return list(tensors), group
    idx = [(h0 + i) // group for i in range(h_local)]
    n = idx[-1] - idx[0] + 1
    per = h_local // n
    if per * n == h_local and all(idx[i] == idx[0] + i // per
                                  for i in range(h_local)):
        return [t.narrow(dim, idx[0], n) for t in tensors], per
    sel = torch.tensor(idx, device=tensors[0].device)
    return [t.index_select(dim, sel) for t in tensors], 1


def attention(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
              softcap: float = 0.0, plan=None, rules=None):
    """q [B, Sq, H, Dh], k/v [B, Skv, KV, Dh] -> [B, Sq, H, Dh].

    ``Skv`` may differ from ``Sq`` under ``causal=False``: cross-attention
    from a prompt over a context of its own length (the VLM's image
    tokens, the audio encoder's frames); each of the B*H rows then walks
    all Skv keys.  The JAX layer picks dense or blockwise attention by
    ``plan.blockwise_attn_threshold``; both compute this one function, and
    the port computes it with the flash-attention kernel at every length
    (the kernel is the blockwise algorithm).  ``plan.gqa_grouped`` only
    changes the JAX layout, not the result.  ``window`` > 0 keeps keys with
    ``qpos - kpos < window`` (h2o-danube's sliding window); ``softcap`` > 0
    caps the scaled scores at ``c tanh(s / c)`` before the mask (Gemma 2's
    logit soft cap), and query row ``i`` sits at ``qpos = i + q_offset``:
    the JAX ``dense_attention``'s function, at every length (the JAX
    blockwise path, taken from ``plan.blockwise_attn_threshold`` on, drops
    the cap; the port does not).

    Under a mesh each rank runs the kernel on its own rows and heads
    (:meth:`Rules.local`), with the KV heads they read
    (:func:`local_kv_heads`); the kernel's gradient flows through.
    """
    rules = rules or NullRules()
    q = rules.constrain(q, Q_AXES)
    k, v = rules.constrain(k, KV_AXES), rules.constrain(v, KV_AXES)
    group = q.shape[2] // k.shape[2]
    h0 = rules.offset(q, 2)

    def local(q, k, v):
        b, sq, h, dh = q.shape
        (k, v), kv_group = local_kv_heads((k, v), h, h0, group)
        skv, kvh = k.shape[1], k.shape[2]
        # [B, S, H, Dh] -> [B*H, S, Dh] (each with its own S): a view when
        # B == 1 (the serving engine's prefill), a copy otherwise
        qh = q.transpose(1, 2).reshape(b * h, sq, dh)
        kh = k.transpose(1, 2).reshape(b * kvh, skv, dh)
        vh = v.transpose(1, 2).reshape(b * kvh, skv, dh)
        out = ops.flash_attention(qh, kh, vh, causal=causal,
                                  kv_group=kv_group, window=window,
                                  softcap=softcap, q_offset=q_offset)
        return out.reshape(b, h, sq, dh).transpose(1, 2)

    return rules.local(local, (Q_AXES, KV_AXES, KV_AXES), Q_AXES)(q, k, v)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0, rules=None):
    """q [B, 1, H, Dh]; caches [B, S, KV, Dh]; ``cache_len`` = valid entries,
    an int or an int tensor [B] (one per row: the batcher's slots sit at
    different positions; a cross layer's is S for every row, a device
    tensor so that a captured step copies nothing from the host) ->
    [B, 1, H, Dh].

    ``window`` is accepted and ignored, as in the JAX layer: a windowed
    cache is a ring of ``min(cache_len, window)`` slots that holds exactly
    the window, so validity stays ``kpos < cache_len``.  ``softcap`` > 0
    caps the scaled scores at ``c tanh(s / c)`` in the kernel.

    Under a mesh each rank decodes its own rows: over its own query heads
    and the KV heads they read, or, where the cache's ``kv_seq`` axis is
    sharded (``Plan.decode_kv_seq_shard``: the KV heads and so the query
    heads whole), over its slice ``[r W/n, (r+1) W/n)`` of the keys with
    ``cache_len`` clamped into it; the kernel's log-sum-exps ``lse_r``
    then merge the slices, ``out = sum_r 2^(lse_r - M) out_r / sum_r
    2^(lse_r - M)`` with ``M = max_r lse_r`` (two all-reduces and a max
    over the group; a capped slice's lse is its capped scores', so the
    merge is the same); ``cache_len`` is then a tensor."""
    del window

    # an uncapped call is the call it always was
    caps = {"softcap": softcap} if softcap > 0 else {}

    def kernel(q, k_cache, v_cache, lens, lse=None):
        return ops.decode_attention(q.contiguous(), k_cache.contiguous(),
                                    v_cache.contiguous(), lens, lse=lse,
                                    **caps)

    return _decode_on_mesh(kernel, q, (k_cache, v_cache), cache_len, rules)


def _decode_on_mesh(kernel, q, caches, cache_len, rules):
    """``kernel(q [B, H, Dh], *caches, lens, lse=None)`` on each rank's
    rows and heads, or on its ``kv_seq`` slice with the slices merged by
    their ``lse`` (:func:`decode_attention`); ``caches`` share the layout
    [B, S, KV, ·]; -> [B, 1, H, Dh]."""
    rules = rules or NullRules()
    q = q[:, 0]
    caches = [rules.constrain(c, CACHE_AXES) for c in caches]
    group = q.shape[1] // caches[0].shape[2]
    seq = rules.group(caches[0], 1)
    if seq is None:
        q_axes = ("batch", "heads", None)
        q = rules.constrain(q, q_axes)
        h0 = rules.offset(q, 1)

        def local(q, *args):
            bufs, _ = local_kv_heads(args[:-1], q.shape[1], h0, group)
            return kernel(q, *bufs, args[-1])
    else:
        q_axes = ("batch", None, None)
        start = rules.offset(caches[0], 1)

        def local(q, *args):
            bufs = args[:-1]
            w = bufs[0].shape[1]
            lens = torch.clamp(args[-1] - start, 0, w).to(torch.int32)
            lse = torch.empty(q.shape[:2], dtype=torch.float32,
                              device=q.device)
            out = kernel(q, *bufs, lens, lse=lse)
            top = col.max_replicated(lse, seq)
            wt = torch.exp2(lse - top)
            num = col.sum_replicated(out.float() * wt[..., None], seq)
            return (num / col.sum_replicated(wt, seq)[..., None]).to(q.dtype)

    out = rules.local(local, (q_axes, *[CACHE_AXES] * len(caches),
                              ("batch",)), q_axes)(q, *caches, cache_len)
    return out[:, None]


def write_kv(caches: Sequence, new: Sequence, slot, rules=None,
             quant: bool = False) -> None:
    """Write a decode step's entries into its ring buffers in place:
    ``caches`` [B, W, KV, ·] and ``new`` [B, 1, KV, ·] pairwise, row ``b``
    at slot ``slot[b]``; with ``quant`` ``caches`` are an int8 cache's
    ``(k, v, k_scale, v_scale)`` and ``new`` its ``(k, v)``, quantized
    here (:func:`quantize_kv`).  Under a mesh each rank writes its part of
    the cache: its rows and KV heads, and where the ``kv_seq`` axis is
    sharded only the rows whose slot lies in its slice."""
    rules = rules or NullRules()
    caches = [rules.constrain(c, CACHE_AXES) for c in caches]
    width = caches[0].shape[1]
    start = rules.offset(caches[0], 1)
    kv = "kv_heads" if rules.group(caches[0], 2) is not None else None
    new_axes = ("batch", None, kv, None)
    n = len(caches)

    def local(slot, *bufs):
        vals = bufs[n:]
        if quant:
            pairs = [quantize_kv(x) for x in vals]
            vals = [x for x, _ in pairs] + [sc for _, sc in pairs]
        rows = torch.arange(slot.shape[0], device=slot.device)
        at = slot
        keep = None
        if bufs[0].shape[1] != width:           # this rank's kv_seq slice
            # a row whose slot lies outside the slice writes back what its
            # clamped slot holds: no shape depends on the data (no host
            # sync, and a fake-tensor trace runs it)
            at = slot - start
            keep = ((at >= 0) & (at < bufs[0].shape[1]))[:, None, None]
            at = at.clamp(0, bufs[0].shape[1] - 1)
        for c, x in zip(bufs[:n], vals):
            x = x[:, 0].to(c.dtype)
            c[rows, at] = x if keep is None else torch.where(keep, x,
                                                             c[rows, at])

    rules.local(local, [("batch",)] + [CACHE_AXES] * n
                + [new_axes] * len(new), [])(slot, *caches, *new)


def write_state(cache, new, axes, rules=None) -> None:
    """Copy ``new`` into the decode state ``cache`` in place (a recurrent
    block's conv window or state); under a mesh each rank writes its own
    part of ``cache``, placed by ``axes``, taking that part of ``new``."""
    rules = rules or NullRules()

    def local(cache, new):
        cache.copy_(new)

    rules.local(local, [axes, axes], [])(cache, new)


# ---------------------------------------------------------------------------
# int8 KV cache (per-token, per-head scales): plain torch, as the JAX
# package computes them in jnp; no Pallas kernel, so no CUDA kernel either
# ---------------------------------------------------------------------------

def quantize_kv(x):
    """x [..., D] -> (int8 [..., D], fp32 scale [..., 1]): symmetric
    per-vector scales ``max|x| / 127 + 1e-8``, values rounded half to
    even."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decode_attention_quant(q, k_q, k_scale, v_q, v_scale, cache_len, *,
                           softcap: float = 0.0, rules=None):
    """Decode attention over an int8 cache: q [B, 1, H, Dh]; ``k_q``/``v_q``
    int8 [B, S, KV, Dh]; scales fp32 [B, S, KV, 1]; ``cache_len`` an int or
    an int tensor [B] -> [B, 1, H, Dh] (:func:`decode_quant`).  A windowed
    cache needs no mask here either (see :func:`decode_attention`), and
    under a mesh each rank decodes its own heads or ``kv_seq`` slice as
    :func:`decode_attention` does, the slices merged by their ``lse``.
    ``softcap`` > 0 caps the scaled scores (the K scales folded in) at
    ``c tanh(s / c)``, in the JAX layer's order."""
    def kernel(q, k_q, k_scale, v_q, v_scale, lens, lse=None):
        return decode_quant(q, k_q, k_scale, v_q, v_scale, lens, lse=lse,
                            softcap=softcap)

    return _decode_on_mesh(kernel, q, (k_q, k_scale, v_q, v_scale),
                           cache_len, rules)


def decode_quant(q, k_q, k_scale, v_q, v_scale, cache_len, lse=None,
                 softcap: float = 0.0):
    """The int8 cache's decode attention, plain torch: q [B, H, Dh] ->
    [B, H, Dh].  The K scales fold into the scores and the V scales into
    the probabilities, so the cache is never dequantized whole; a soft cap
    ``softcap`` > 0 then caps the scaled scores.  ``lse`` (fp32 [B, H],
    optional) receives each row's base-2 log-sum-exp of its (capped)
    scaled scores over its valid keys, ``NEG_INF`` for a row with none:
    the decode kernel's convention, so that ``kv_seq`` slices merge."""
    b, h, d = q.shape
    s_len, kvh = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bgrd,bkgd->bgrk", qg,
                          k_q.to(q.dtype)).to(torch.float32)
    scores = scores * k_scale[..., 0].transpose(1, 2)[:, :, None, :]
    scores = scores * (1.0 / math.sqrt(d))
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s_len, device=q.device)[None, :] < lens   # [B?, S]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_scale[..., 0].transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bgrk,bkgd->bgrd", probs.to(q.dtype),
                       v_q.to(q.dtype))
    if lse is not None:
        got = torch.where(valid.any(-1)[:, None, None],
                          torch.logsumexp(scores, dim=-1) * LOG2E, NEG_INF)
        lse.copy_(got.reshape(b, h))
    return out.reshape(b, h, d)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

_ACTS = {"swiglu": F.silu, "geglu": lambda g: F.gelu(g, approximate="tanh")}


def apply_ffn(p, x, act, use_bias=False):
    """x [..., d] through ``p``'s FFN.  Weights stacked on a leading axis
    (an MoE's experts, ``w_in [E, d, f]``) take x ``[E, C, d]`` or ``[G, E,
    C, d]``: ``torch.matmul`` batches over the expert axis, as the JAX
    ``moe._expert_ffn`` / ``_expert_ffn_grouped`` einsums do."""
    h = torch.matmul(x, p["w_in"])
    if use_bias:
        h = h + p["b_in"]
    if act in _ACTS:
        h = _ACTS[act](torch.matmul(x, p["w_gate"])) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown act {act}")
    y = torch.matmul(h, p["w_out"])
    if use_bias:
        y = y + p["b_out"]
    return y
