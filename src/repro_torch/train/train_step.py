"""Train and serve step factories: the port of ``repro.train.train_step``.

``make_train_step(model, tcfg)`` returns
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
as the reference does, with microbatch gradient accumulation and the
plan's remat (``LM.train_loss``).  The port's LM holds its parameters:
``params`` is ``model.params()`` (a dict of another set of tensors, a
restored checkpoint, is first copied into them), and the step updates them
and ``opt_state`` in place and returns them.  The gradients come from
``torch.autograd.grad`` through the backward kernels (flash attention's
on the card).  The multi-pod and pipelined steps need a mesh and wait for
ROADMAP queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.layers import not_ported
from repro_torch.models.lm import LM
from repro_torch.train import optimizer


def _split_microbatches(batch: Mapping[str, Any], n: int):
    """The batch cut along its leading axis into ``n`` microbatches."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} % microbatches {n} != 0")
        parts = (np.split(x, n) if isinstance(x, np.ndarray)
                 else torch.chunk(torch.as_tensor(x), n))
        for mb, part in zip(out, parts):
            mb[k] = part
    return out


def make_loss_fn(model: LM) -> Callable:
    def loss_fn(batch):
        return model.train_loss(batch)
    return loss_fn


def _grads(total: torch.Tensor, params: Dict[str, torch.Tensor]):
    got = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def make_train_step(model: LM, tcfg: TrainConfig) -> Callable:
    """The LM's parameters take gradients from here on
    (``requires_grad_(True)``).  Over ``plan.microbatches`` > 1 the
    gradients are summed in fp32 and averaged, and ``aux_loss`` is
    reported as 0.0, as in the reference."""
    n_micro = max(model.plan.microbatches, 1)
    loss_fn = make_loss_fn(model)
    model.requires_grad_(True)

    def train_step(params, opt_state, batch, step):
        params = model.load_params(params)
        if n_micro == 1:
            total, metrics = loss_fn(batch)
            grads = _grads(total, params)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_microbatches(batch, n_micro):
                total, _ = loss_fn(mb)
                for n, g in _grads(total, params).items():
                    grads[n].add_(g)
                loss = loss + total.detach()
            grads = {n: g / n_micro for n, g in grads.items()}
            metrics = {"loss": loss / n_micro,
                       "aux_loss": torch.zeros((), device=model.device)}
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, tcfg)
        return params, opt_state, dict(metrics, **opt_metrics, step=step)

    return train_step


def make_pod_parallel_train_step(model: LM, tcfg: TrainConfig, mesh):
    raise not_ported("the pod-parallel train step (a mesh, compressed "
                     "cross-pod gradients)", 11)


def make_pipeline_train_step(stage_fn, tcfg: TrainConfig, mesh, plan, *,
                             axis: str = "pod", loss_fn=None):
    raise not_ported("the pipelined train step (a mesh of stages)", 11)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_prefill_step(model: LM, cache_len: int) -> Callable:
    def prefill_step(batch):
        return model.prefill(batch, cache_len)
    return prefill_step


def make_serve_step(model: LM) -> Callable:
    """(cache, tokens [B, 1], pos) -> (logits [B, V], cache written in
    place)."""
    def serve_step(cache, tokens, pos):
        return model.decode_step(cache, tokens, pos)
    return serve_step
