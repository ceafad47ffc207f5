"""Train and serve step factories: the port of ``repro.train.train_step``.

``make_train_step(model, tcfg)`` returns
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
as the reference does, with microbatch gradient accumulation and the
plan's remat (``LM.train_loss``).  The port's LM holds its parameters:
``params`` is ``model.params()`` (a dict of another set of tensors, a
restored checkpoint, is first copied into them), and the step updates them
and ``opt_state`` in place and returns them.  The gradients come from
``torch.autograd.grad`` through the backward kernels (flash attention's
on the card).

Over an LM partitioned by ``Rules`` on a sharded mesh (every family,
``models.lm``) the same :func:`make_train_step` and :func:`make_serve_step`
run as SPMD code on every rank: each rank passes the whole batch, the LM
places it by its batch axes, the gradients come back as DTensors that the
optimizer reduces to their parameters' placements, and the loss, metrics
and logits come back whole on every rank.  That path is eager.

``make_pod_parallel_train_step(model, tcfg, mesh)`` is the explicit
multi-pod step, and ``make_pipeline_train_step`` the pipelined one.  Both
are SPMD code every rank of the mesh runs with the whole batch.  In the
pod step each rank runs the LM on its pod's rows, partitioned on the pod's
("data", "model") sub-mesh when it was built with ``Rules``, and sums its
own shard of the gradients across pods, so each rank holds its share of
the parameters, gradients, moments and error feedback.  The pipelined
step holds its stage parameters whole on every rank, and every rank takes
the same optimizer step.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import Rules, mesh_axes
from repro_torch.models.lm import LM
from repro_torch.train import grad_compression, optimizer


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
            grads = {n: torch.zeros_like(p, dtype=torch.float32,
                                         requires_grad=False)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_microbatches(batch, n_micro):
                total, _ = loss_fn(mb)
                for n, g in _grads(total, params).items():
                    grads[n].add_(optimizer._like_param(g, params[n]))
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


def _pod_rows(batch: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """This rank's pod's rows of ``batch``: its leading dimension cut into
    as many parts as the mesh has pods, as the reference's ``P("pod")``
    in-spec cuts it."""
    b = next(iter(batch.values())).shape[0]
    shape = mesh_axes(mesh)
    n = shape["pod"]
    if b % n:
        raise ValueError(f"batch {b} % pod {n} != 0")
    pod = dict(zip(shape, mesh.get_coordinate()))["pod"]
    rows = slice(pod * (b // n), (pod + 1) * (b // n))
    return {k: x[rows] for k, x in batch.items()}


def make_pod_gradients(model: LM, mesh) -> Callable:
    """The body of the pod-parallel step (the reference's ``pod_body``):
    ``(params, ef, batch) -> (grads, new_ef, loss, metrics)``.

    Each rank takes its pod's rows and runs the LM on them, as the
    reference runs its inner model under GSPMD inside the ``shard_map``
    over "pod".  An LM built with ``Rules`` on the mesh is partitioned on
    its pod's ("data", "model") sub-mesh (``models.lm``): it places the
    rows over "data" and its parameters over both axes, and its gradients
    come back as DTensors there, each reduced to its parameter's
    placements.  The expert-parallel MoE keeps whole parameters and runs
    under rules that exclude "pod" (``moe.apply_moe_ep`` splits the pod's
    rows over "data" and the experts over "model"); an LM without rules
    runs its pod's rows whole.  The gradients are then summed over the
    mesh's "pod" group, each rank its own shard, with ``compressed_psum``
    under ``plan.grad_compression`` (``ef`` the error feedback, fp32 per
    leaf; ``new_ef`` is ``ef`` without compression), else ``plain_psum``,
    and divided by the pod count.  The loss and metrics, whole on every
    rank, are averaged over "pod"."""
    shape = mesh_axes(mesh)
    if "pod" not in shape:
        raise ValueError(f"the pod-parallel step needs a 'pod' axis, the "
                         f"mesh has {tuple(shape)}")
    loss_fn = make_loss_fn(model)
    compress = model.plan.grad_compression
    # an LM on the mesh with whole parameters (the expert-parallel MoE)
    # runs under the reference's inner rules: "pod" is already cut
    inner = (None if model.partitioned or model.rules.mesh is None
             else Rules(mesh, model.plan, exclude_axes=("pod",)))
    pod = mesh.get_group("pod")
    n_pods = shape["pod"]
    model.requires_grad_(True)

    def pod_gradients(params, ef, batch):
        params = model.load_params(params)
        rows = _pod_rows(batch, mesh)
        with (model.rules_as(inner) if inner is not None
              else contextlib.nullcontext()):
            total, metrics = loss_fn(rows)
            grads = _grads(total, params)
        grads = {n: optimizer._like_param(g, params[n])
                 for n, g in grads.items()}
        if compress:
            grads, new_ef = grad_compression.compressed_psum(grads, ef, pod)
        else:
            grads, new_ef = grad_compression.plain_psum(grads, pod), ef
        for g in grads.values():
            g.div_(n_pods)
        metrics = {k: col.all_reduce(torch.as_tensor(
            v, device=model.device).detach().float(), group=pod).div_(n_pods)
            for k, v in metrics.items()}
        return grads, new_ef, metrics["loss"], metrics

    return pod_gradients


def make_pod_parallel_train_step(model: LM, tcfg: TrainConfig,
                                 mesh) -> Callable:
    """The explicit multi-pod step with the (optionally int8-compressed)
    cross-pod gradient sum, as SPMD code every rank of ``mesh`` runs:
    :func:`make_pod_gradients`, then AdamW on each rank's shards.
    ``opt_state["ef"]`` holds the error-feedback buffers: when absent, an
    fp32 zero a leaf, as the reference makes them (``compressed_psum``
    broadcasts it, and returns buffers in the gradients' placements); the
    optimizer update leaves it out and it is put back after."""
    pod_gradients = make_pod_gradients(model, mesh)

    def train_step(params, opt_state, batch, step):
        params = model.load_params(params)
        ef = opt_state.get("ef")
        if ef is None:
            ef = {k: torch.zeros((), dtype=torch.float32, device=p.device)
                  for k, p in params.items()}
        grads, new_ef, loss, metrics = pod_gradients(params, ef, batch)
        opt_wo_ef = {k: v for k, v in opt_state.items() if k != "ef"}
        params, new_opt, opt_metrics = optimizer.update(
            grads, opt_wo_ef, params, tcfg)
        new_opt["ef"] = new_ef
        return params, new_opt, dict(metrics, **opt_metrics, loss=loss,
                                     step=step)

    return train_step


def make_pipeline_train_step(stage_fn, tcfg: TrainConfig, mesh, plan, *,
                             axis: str = "pod",
                             loss_fn: Callable = None) -> Callable:
    """Train step for a stage-stacked model pipelined over ``axis``, as
    SPMD code every rank of ``mesh`` runs: the forward pass under the
    plan's pipeline genes (``pipeline_schedule`` / ``virtual_stages`` /
    ``microbatches``, :func:`repro_torch.dist.pipeline.pipeline_apply`),
    the backward through its ring shifts.  ``stage_params`` is one tensor
    whose leading dim is the stage (whole on every rank, as are the
    gradients it gets back, so every rank takes the same AdamW step, in
    place); ``batch`` is ``(x, y)``; ``loss_fn(pred, y)`` defaults to the
    mean squared error.  The optimizer state is :func:`optimizer.init` of
    ``{"stages": stage_params}``."""
    from repro_torch.dist.pipeline import pipeline_apply

    n_micro = max(getattr(plan, "microbatches", 1), 1)
    schedule = getattr(plan, "pipeline_schedule", "gpipe")
    virtual = getattr(plan, "virtual_stages", 1)
    loss_of = loss_fn or (lambda pred, y: torch.mean((pred - y) ** 2))

    def train_step(stage_params, opt_state, batch, step):
        x, y = batch
        ws = stage_params.detach().requires_grad_(True)
        out = pipeline_apply(stage_fn, ws, x, mesh, microbatches=n_micro,
                             axis=axis, schedule=schedule,
                             virtual_stages=virtual)
        lval = loss_of(out, y)
        grad, = torch.autograd.grad(lval, ws)
        params = {"stages": stage_params}
        _, new_opt, opt_metrics = optimizer.update(
            {"stages": grad}, opt_state, params, tcfg)
        return stage_params, new_opt, dict(opt_metrics, loss=lval.detach(),
                                           step=step)

    return train_step


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
