"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch;
the port of ``repro.models.moe``.

Tokens are split into ``groups`` routing groups with a capacity each; within
a group the (token, k) pairs are ordered by expert id (a stable sort), a
pair's slot is its rank in its expert's run, and pairs at or past the
capacity are dropped (GShard semantics).  The kept pairs run through their
expert's FFN, and each token sums its gate-weighted contributions.  Moonlight
adds always-on shared experts and Arctic a dense residual FFN.

Weights keep the JAX tree's layout: ``router [d, E]``, ``experts.{w_in,
w_gate} [E, d, f]`` and ``experts.w_out [E, f, d]`` stacked on the expert
axis, ``shared`` and ``dense`` plain FFNs.  :func:`apply_moe` takes them as
a nested mapping (a dict, or the LM's :class:`MoEWeights`).

Everything here is plain torch, as the JAX module is jnp outside any Pallas
kernel.  The JAX ``_expert_ffn`` / ``_expert_ffn_grouped`` einsums are
:func:`repro_torch.models.layers.apply_ffn` on the stacked weights
(``torch.matmul`` batches over the expert axis).  Differences from the JAX
module, none of which changes a result:

  * the dispatch buffer is expert-major, ``[E, G, C, D]`` (JAX's ``[G, E, C,
    D]`` transposed), so the expert products are batched matmuls over
    ``[E, G*C, D]`` with no copy;
  * kept pairs are written into it by a plain indexed copy (their slots are
    distinct) and dropped pairs into one spare row that is never read, where
    JAX adds zeros into slot 0;
  * a token's contributions are summed in ascending expert id, in the
    activation dtype, as XLA's sequential scatter-add sums them, with no
    float atomics, so repeated calls agree bit for bit;
  * no step reads a value on the host or makes a tensor from host data, so
    the serving engine can capture it in a CUDA graph;
  * ``drops`` (optional) counts routed and dropped pairs, and the experts
    routed to, in place.

Under a mesh (a partitioned LM's ``rules``) :func:`apply_moe` runs the
routing and the experts in :meth:`Rules.local`: each data rank routes its
own groups and each rank runs only its own experts (the reference's
constraints put the groups on the batch axes and the experts on
"model"); :func:`apply_moe_ep` is the explicit ``shard_map`` path.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.autograd.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import NullRules, whole
from repro_torch.models import layers

# ---------------------------------------------------------------------------
# init (the JAX distributions: repro.models.moe.init_moe)
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, generator: torch.Generator, device,
             dtype: torch.dtype) -> dict:
    """One layer's MoE weights as the JAX tree nests them: ``router``,
    ``experts`` and, where the config has them, ``shared`` (hidden
    ``d_expert * shared_experts``) and ``dense`` (hidden ``dense_d_ff or
    d_ff``); no biases."""
    m, d, act = cfg.moe, cfg.d_model, cfg.ffn_act
    p = {"router": layers.dense_init((d, m.n_experts), d, dtype, generator,
                                     device),
         "experts": layers.init_ffn(d, m.d_expert, act, False, dtype,
                                    generator, device, n=m.n_experts)}
    if m.shared_experts:
        p["shared"] = layers.init_ffn(d, m.d_expert * m.shared_experts, act,
                                      False, dtype, generator, device)
    if m.dense_residual:
        p["dense"] = layers.init_ffn(d, m.dense_d_ff or cfg.d_ff, act, False,
                                     dtype, generator, device)
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    """One layer's logical axes (``repro.models.moe.moe_axes``): the
    experts' leading axis is ``experts``."""
    m = cfg.moe
    experts = {"w_in": ("experts", "embed", "ff"),
               "w_out": ("experts", "ff", "embed")}
    if cfg.ffn_act in ("swiglu", "geglu"):
        experts["w_gate"] = ("experts", "embed", "ff")
    p = {"router": ("embed", None), "experts": experts}
    if m.shared_experts:
        p["shared"] = layers.ffn_axes(cfg.ffn_act, False)
    if m.dense_residual:
        p["dense"] = layers.ffn_axes(cfg.ffn_act, False)
    return p


class MoEWeights(nn.Module):
    """One layer's MoE weights held by the LM (state-dict names ``router``,
    ``experts.*``, ``shared.*``, ``dense.*`` under ``prefix``), indexable
    as the nested mapping :func:`apply_moe` takes."""

    def __init__(self, params: Mapping[str, torch.Tensor], prefix: str):
        super().__init__()
        self.router = nn.Parameter(params[f"{prefix}router"],
                                   requires_grad=False)
        for part in ("experts", "shared", "dense"):
            head = f"{prefix}{part}."
            group = {k[len(head):]: nn.Parameter(v, requires_grad=False)
                     for k, v in params.items() if k.startswith(head)}
            if group:
                setattr(self, part, nn.ParameterDict(group))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# routing, dispatch, combine
# ---------------------------------------------------------------------------

class Routing(NamedTuple):
    """Where each (token, k) pair of ``[G, Tg]`` tokens goes, in top-k
    order: ``expert`` ids, fp32 ``gate`` weights, ``slot`` (its rank in its
    expert's run) and ``keep`` (slot < ``capacity``), all ``[G, Tg, k]``;
    ``counts [G, E]`` pairs per expert, ``logits`` fp32 ``[G, Tg, E]``."""
    expert: torch.Tensor
    gate: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    counts: torch.Tensor
    logits: torch.Tensor


def top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, largest first,
    ties going to the lower index (a stable descending sort; ``torch.topk``
    promises no order among equals)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_of(cfg: ModelConfig, tokens_per_group: int,
                capacity_factor: Optional[float] = None) -> int:
    """Slots an expert has in one group: ``max(int(Tg * k * cf / E), k)``."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor
    return max(int(tokens_per_group * m.top_k * cf / m.n_experts), m.top_k)


def route(router: torch.Tensor, cfg: ModelConfig, tokens: torch.Tensor,
          capacity: int) -> Routing:
    """Top-k routing of ``tokens [G, Tg, D]`` and each pair's slot: the
    pairs of a group sorted stably by expert id (``jnp.argsort``), a pair's
    slot its position minus its expert's start."""
    m = cfg.moe
    g, tg, _ = tokens.shape
    k = m.top_k
    logits = torch.matmul(tokens, router).float()              # [G, Tg, E]
    gates, expert = top_k(logits, k)
    gates = torch.softmax(gates, dim=-1)
    fe = expert.reshape(g, tg * k)
    order = torch.argsort(fe, dim=1, stable=True)
    counts = torch.zeros((g, m.n_experts), dtype=torch.long,
                         device=tokens.device).scatter_add_(
        1, fe, torch.ones_like(fe))
    starts = counts.cumsum(dim=1) - counts
    se = fe.gather(1, order)
    ranks = torch.arange(tg * k, device=tokens.device)[None, :] \
        - starts.gather(1, se)
    slot = torch.empty_like(ranks).scatter_(1, order, ranks)   # token order
    slot = slot.reshape(g, tg, k)
    return Routing(expert, gates, slot, slot < capacity, counts, logits)


TOKENS = ("batch", None, None)          # x [B, S, D], routing [G, Tg, k]
WHOLE = (None, None, None)


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor,
              capacity_factor: Optional[float] = None, groups: int = 1, *,
              drops: Optional[torch.Tensor] = None, rules=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (y [B, S, D], aux).

    GShard-style grouped dispatch: the B*S tokens split into ``groups``
    groups (one group when they do not divide), each with its own capacity.
    ``aux`` is the Switch load-balance term ``E * sum(mean softmax * share
    of pairs)`` (serving discards it).  ``drops``, an int64 ``[3]`` tensor,
    gains the pairs routed, the pairs dropped and the experts routed to
    (those with a pair in any group: the experts whose weights the call
    needs), in place.  Profiler ranges name the pieces: ``moe.route``
    (routing and dispatch), ``moe.experts`` (the expert FFNs over all E),
    ``moe.combine``, ``moe.shared`` and ``moe.dense``.

    Under a mesh (``rules`` of a partitioned LM: ``x`` and the weights
    DTensors) the groups lie on the batch axes, as the reference
    constrains them: each data rank routes its own groups (every rank of
    the mesh, when the groups do not split as the rows do), the tokens
    whole across "model"; the counts behind ``aux`` and ``drops`` are
    summed over the batch axes, so both are the one-device run's.  Each
    rank then dispatches only to its own experts' slice of the buffer
    (the experts, or the expert FFN's hidden width, lie on "model") and
    its combine is a partial sum over "model", summed where the caller
    constrains ``y``."""
    rules = rules or NullRules()
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    g = max(int(groups), 1)
    if t % g != 0:
        g = 1
    tg = t // g
    k, n_exp = m.top_k, m.n_experts
    cap = capacity_of(cfg, tg, capacity_factor)
    # each rank's groups are its own rows when the groups split as they do
    split = rules.spec(("batch",), (g,)) == rules.spec(("batch",), (b,))
    tok = TOKENS if split else WHOLE
    batch = rules.group(rules.constrain(x, TOKENS), 0) if split else None

    def route_local(x, router):
        with record_function("moe.route"):
            r = route(router, cfg, x.reshape(-1, tg, d), cap)
            per_expert = col.sum_replicated(r.counts.sum(dim=0), batch)
            probs = torch.softmax(r.logits, dim=-1)
            me = (probs.mean(dim=(0, 1)) if batch is None else
                  col.sum_replicated(probs.sum(dim=(0, 1)), batch) / t)
            if drops is not None:
                drops[0].add_(t * k)
                drops[1].add_(col.sum_replicated((~r.keep).sum(), batch))
                # an expert with a pair has one in slot 0, always kept
                drops[2].add_((per_expert > 0).sum())
            aux = n_exp * torch.sum(me * per_expert.float() / (t * k))
        return r.expert, r.gate, r.slot, r.keep, aux

    expert, gate, slot, keep, aux = rules.local(
        route_local, (tok, (None, None)), [tok] * 4 + [()])(x, p["router"])

    names = list(p["experts"])
    w_axes = {"w_in": ("experts", None, "ff"), "w_gate": ("experts", None,
                                                          "ff"),
              "w_out": ("experts", "ff", None)}
    weights = [rules.constrain(p["experts"][n], w_axes[n]) for n in names]
    e0 = rules.offset(weights[0], 0)

    def experts_local(x, expert, gate, slot, keep, *weights):
        tokens = x.reshape(-1, tg, d)
        g_loc = tokens.shape[0]
        e_loc = weights[0].shape[0]
        with record_function("moe.route"):
            # dispatch into [E_loc, G_loc, C] rows (+ one spare row for the
            # dropped pairs and the other ranks' experts)
            local = expert - e0
            mine = keep & (local >= 0) & (local < e_loc)
            group = torch.arange(g_loc, device=x.device)[:, None, None]
            rows = (local * g_loc + group) * cap + slot          # [G, Tg, k]
            spare = e_loc * g_loc * cap
            buf = x.new_zeros((spare + 1, d))
            buf.index_copy_(0, torch.where(mine, rows, spare).reshape(-1),
                            tokens[:, :, None, :].expand(g_loc, tg, k, d)
                            .reshape(-1, d))
        with record_function("moe.experts"):
            out = layers.apply_ffn(dict(zip(names, weights)),
                                   buf[:spare].view(e_loc, g_loc * cap, d),
                                   cfg.ffn_act).reshape(spare, d)
        # combine: each token's kept contributions, (out * gate) in fp32
        # cast to the activation dtype, summed in ascending expert id from
        # zero
        with record_function("moe.combine"):
            by_id = torch.argsort(expert, dim=-1)
            kept = mine.gather(-1, by_id)
            rows = torch.where(kept, rows.gather(-1, by_id), 0)
            wt = gate.gather(-1, by_id)
            got = torch.where(kept[..., None], out[rows.reshape(-1)].reshape(
                g_loc, tg, k, d), 0)
            contrib = (got.float() * wt[..., None]).to(x.dtype)
            y = torch.zeros((g_loc, tg, d), dtype=x.dtype, device=x.device)
            for j in range(k):
                y = y + contrib[:, :, j]
        return y.reshape(x.shape)

    y = rules.local(experts_local,
                    (tok, tok, tok, tok, tok, *[w_axes[n] for n in names]),
                    tok, partial=("experts", "ff"))(
        x, expert, gate, slot, keep, *weights)

    if m.shared_experts:
        with record_function("moe.shared"):
            y = y + layers.apply_ffn(p["shared"], x, cfg.ffn_act)
    if m.dense_residual:
        with record_function("moe.dense"):
            y = y + layers.apply_ffn(p["dense"], x, cfg.ffn_act)
    return y, whole(aux)


def apply_moe_ep(p, cfg: ModelConfig, x: torch.Tensor,
                 capacity_factor: Optional[float] = None, rules=None, **kw):
    """Expert-parallel MoE over the ``model`` axis of ``rules.mesh``: the
    JAX ``shard_map`` body (``repro.models.moe.apply_moe_ep``) as SPMD
    code, every rank of the mesh calling it with the whole ``x`` and
    weights.

    Each rank takes its data slice of the tokens (its coordinate on the
    batch axes, pod-major) and its ``E / ep`` experts, routes its tokens
    over all E experts with the per-(data shard, expert) capacity, and
    runs only its own experts.  The partial outputs and the load-balance
    ``aux`` are summed over ``model``, ``aux`` is averaged over the batch
    axes, and the outputs are gathered so that every rank holds the whole
    ``y``.  The collectives treat the result as one replicated value
    (:mod:`repro_torch.dist.collectives`): the gradient each rank gets
    for ``x`` and every weight is the whole one.

    A batch axis in ``rules.exclude_axes`` is one the caller has already
    split (the pod-parallel step's, whose ranks each hold their own rows):
    ``x`` is this rank's part along it, so the tokens are not cut again
    and nothing is summed or averaged over it.

    Without a mesh, with a ``model`` axis of 1, or when the experts or the
    batch do not divide, it runs :func:`apply_moe` over one group, as the
    reference falls back.  ``drops`` (``**kw``) is counted on that path
    only."""
    from repro_torch.dist.sharding import batch_axes, mesh_axes

    m = cfg.moe
    mesh = getattr(rules, "mesh", None)
    shape = mesh_axes(mesh) if mesh is not None else {}
    ep = shape.get("model", 1)
    excluded = getattr(rules, "exclude_axes", ())
    dp = tuple(a for a in batch_axes(mesh) if a not in excluded
               ) if mesh is not None else ()
    dp_size = math.prod(shape[a] for a in dp)
    b, s, d = x.shape
    if mesh is None or ep == 1 or m.n_experts % ep or b % dp_size:
        return apply_moe(p, cfg, x, capacity_factor, groups=1, **kw)
    if kw.get("drops") is not None:
        raise ValueError("apply_moe_ep counts drops only without a mesh")
    coord = dict(zip(shape, mesh.get_coordinate()))
    e_loc = m.n_experts // ep
    off = coord["model"] * e_loc
    shard = 0
    for a in dp:                                   # pod-major
        shard = shard * shape[a] + coord[a]
    b_loc = b // dp_size
    t_loc = b_loc * s
    k = m.top_k
    cap = capacity_of(cfg, t_loc, capacity_factor)

    groups = [mesh.get_group(a) for a in (*dp, "model") if shape[a] > 1]
    xr = col.replicated(x, groups)
    router = col.replicated(p["router"], groups)
    experts = {n: col.replicated(w, groups)[off:off + e_loc]
               for n, w in p["experts"].items()}
    tokens = xr[shard * b_loc:(shard + 1) * b_loc].reshape(1, t_loc, d)
    with record_function("moe.route"):
        r = route(router, cfg, tokens, cap)
        local = r.expert - off
        keep = r.keep & (local >= 0) & (local < e_loc)
        rows = local * cap + r.slot                             # [1, t, k]
        spare = e_loc * cap
        buf = x.new_zeros((spare + 1, d))
        buf.index_copy_(0, torch.where(keep, rows, spare).reshape(-1),
                        tokens[:, :, None, :].expand(1, t_loc, k, d)
                        .reshape(-1, d))
    with record_function("moe.experts"):
        out = layers.apply_ffn(experts, buf[:spare].view(e_loc, cap, d),
                               cfg.ffn_act).reshape(spare, d)
    with record_function("moe.combine"):
        got = torch.where(keep[..., None], out[torch.where(
            keep, rows, 0).reshape(-1)].reshape(1, t_loc, k, d), 0)
        partial = (got.float() * r.gate[..., None]).sum(dim=2)   # [1, t, d]
        y = col.sum_replicated(partial, mesh.get_group("model"))
        y = y.to(x.dtype).reshape(b_loc, s, d)
        for a in reversed(dp):                 # minor axis first
            y = col.gather_replicated(y, mesh.get_group(a))

    me = torch.softmax(r.logits[0], dim=-1).mean(dim=0)          # [E]
    ce_loc = r.counts[0, off:off + e_loc].float() / (t_loc * k)
    aux = m.n_experts * torch.sum(me[off:off + e_loc] * ce_loc)
    aux = col.sum_replicated(aux, mesh.get_group("model"))
    for a in dp:
        aux = col.sum_replicated(aux, mesh.get_group(a)) / shape[a]

    if m.shared_experts:
        with record_function("moe.shared"):
            y = y + layers.apply_ffn(p["shared"], x, cfg.ffn_act)
    if m.dense_residual:
        with record_function("moe.dense"):
            y = y + layers.apply_ffn(p["dense"], x, cfg.ffn_act)
    return y, aux
