"""AdamW with warmup and cosine decay: the port of
``repro.train.optimizer``.

The state is a dict of tensors keyed by the LM's parameter names: ``m`` and
``v`` in ``tcfg.master_dtype``, an int32 ``count`` and, under
``tcfg.use_master_copy``, an fp32 ``master`` copy of the parameters.
Where the reference returns new parameters and a new state, :func:`update`
writes both in place under ``torch.no_grad()`` (one leaf at a time, a
large leaf in runs of rows, so the fp32 temporaries stay near 256 MB
each), with the reference's arithmetic:
gradients clipped by their global norm, moments and bias corrections in
fp32, decoupled weight decay, the fp32 result cast to each parameter's
dtype.  :func:`opt_state_axes` gives the state's logical axes (the
moments mirror the parameters).

Parameters that are DTensors (a partitioned LM) get moments placed as
they are; their gradients, which come back partial where a rank summed
only its own rows, are first redistributed to the parameters' placements,
the clip reads the whole model's norm on every rank, and each rank then
updates its own shards.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from repro_torch.configs.base import TrainConfig
from repro_torch.models.lm import torch_dtype

State = Dict[str, object]


def lr_schedule(tcfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup to ``tcfg.lr``, then cosine decay to a tenth of it at
    ``total_steps``; ``step`` an int or a tensor (fp32 result on its
    device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - tcfg.warmup_steps)
                    / max(tcfg.total_steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return tcfg.lr * warm * (0.1 + 0.9 * cos)


def init(params: Mapping[str, torch.Tensor], tcfg: TrainConfig) -> State:
    """Zero moments beside each parameter (on its device, a DTensor's
    with its placements), a zero count, and the fp32 master copy under
    ``tcfg.use_master_copy``."""
    mdt = torch_dtype(tcfg.master_dtype)
    first = next(iter(params.values()))
    state: State = {
        "m": {n: torch.zeros_like(p, dtype=mdt, requires_grad=False)
              for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=mdt, requires_grad=False)
              for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if tcfg.use_master_copy:
        state["master"] = {n: p.detach().float().clone()
                           for n, p in params.items()}
    return state


def opt_state_axes(par_axes: Mapping[str, tuple], tcfg: TrainConfig
                   ) -> State:
    """Logical axes of :func:`init`'s state from the parameters' axes
    (``models.lm.param_axes``): the moments (and the master copy) mirror
    them, ``count`` is a scalar."""
    state: State = {"m": par_axes, "v": par_axes, "count": ()}
    if tcfg.use_master_copy:
        state["master"] = par_axes
    return state


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32; a DTensor leaf's
    over its whole value, the same on every rank."""
    def norm(x):
        n = torch.linalg.vector_norm(x, dtype=torch.float32)
        return n.full_tensor() if isinstance(n, DTensor) else n
    return torch.linalg.vector_norm(torch.stack([norm(x)
                                                 for x in tree.values()]))


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when fp32 (updated in place), else an fp32 copy."""
    return t if t.dtype == torch.float32 else t.float()


def _local(t):
    """This rank's shard of a DTensor (its storage: written in place);
    anything else itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _like_param(g, p):
    """A DTensor gradient redistributed to its parameter's placements
    (partial sums reduced)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: State,
           params: Mapping[str, torch.Tensor], tcfg: TrainConfig
           ) -> Tuple[Mapping[str, torch.Tensor], State,
                      Dict[str, torch.Tensor]]:
    """One AdamW step: writes ``params`` and ``state`` in place and returns
    them with ``{"lr", "grad_norm"}`` (fp32 tensors; nothing here waits for
    the device).  A profiler range, ``train.optimizer``, names its work."""
    with record_function("train.optimizer"):
        return _update(grads, state, params, tcfg)


def _update(grads, state, params, tcfg):
    count = state["count"]
    count.add_(1)
    lr = lr_schedule(tcfg, count)
    grads = {n: _like_param(g, params[n]) for n, g in grads.items()}
    gnorm = global_norm(grads)
    clip = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2, eps = tcfg.beta1, tcfg.beta2, tcfg.eps
    c = count.float()
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    master = state.get("master")
    for name, p in params.items():
        p = _local(p)
        g_all = _local(grads[name])
        m_all, v_all = _local(state["m"][name]), _local(state["v"][name])
        base_all = _local(master[name]) if master is not None else p
        for rows in _row_chunks(p):
            g = g_all[rows].float() * clip
            m, v = m_all[rows], v_all[rows]
            m32, v32 = _fp32(m), _fp32(v)
            m32.mul_(b1).add_(g, alpha=1 - b1)
            v32.mul_(b2).add_(g.square_(), alpha=1 - b2)
            step = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(eps))
            base = base_all[rows]
            base32 = _fp32(base)
            step.add_(base32, alpha=tcfg.weight_decay)
            base32.sub_(step.mul_(lr))
            for t, t32 in ((m, m32), (v, v32), (base, base32)):
                if t is not t32:
                    t.copy_(t32)
            if master is not None:
                p[rows].copy_(base32)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# elements of a leaf updated at once: the fp32 temporaries of an update stay
# near 256 MB each, whatever the leaf (a vocabulary's embedding is GBs)
_CHUNK = 1 << 26


def _row_chunks(t: torch.Tensor) -> list:
    """Index of ``t`` (the whole of a small leaf, else runs of rows of at
    most ``_CHUNK`` elements), over which the update's elementwise
    arithmetic runs in turn."""
    if t.dim() == 0 or t.numel() <= _CHUNK:
        return [Ellipsis]
    rows = max(1, _CHUNK // (t.numel() // t.shape[0]))
    return [slice(r, r + rows) for r in range(0, t.shape[0], rows)]
