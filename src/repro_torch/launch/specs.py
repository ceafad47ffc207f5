"""TensorSpec stand-ins for every input of a model step (no allocation): the
port of ``repro.launch.specs``.

A :class:`~repro_torch.core.trace_analysis.TensorSpec` is the port's
``jax.ShapeDtypeStruct``: shape, dtype and device.  ``batch_specs(cfg,
shape)`` gives the step's batch by the shape's kind:

  * train:   {tokens, labels} (+ img_embed / frames)
  * prefill: {tokens} (+ extras)
  * decode:  {tokens [B, 1]}

:func:`param_specs` and :func:`cache_specs` are the port's
``jax.eval_shape`` over ``Model.init`` and ``init_cache``: they run
:func:`repro_torch.models.lm.init_params` and ``init_cache`` on the meta
device (shapes and dtypes only) and keep each leaf's shape and dtype.  The parameters come as the LM's state dict (one entry a layer, the
reference's stacked leaves unstacked, ``models.convert``); the cache is the
reference's tree.  ``device`` is the device each spec names (None: the
card); the shapes are the same on any device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._pytree import tree_map

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.trace_analysis import TensorSpec
from repro_torch.device import DeviceLike, resolve
from repro_torch.models import lm


def _extras(cfg: ModelConfig, batch: int, dtype, dev) -> Dict[str, Any]:
    out = {}
    if cfg.family == "vlm":
        out["img_embed"] = TensorSpec((batch, cfg.n_img_tokens, cfg.d_model),
                                      dtype, dev)
    if cfg.family == "audio":
        out["frames"] = TensorSpec((batch, cfg.n_frames, cfg.d_model), dtype,
                                   dev)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                device: DeviceLike = None) -> Dict[str, TensorSpec]:
    dev = resolve(device)
    dtype = lm.torch_dtype(cfg.dtype)
    b = shape.global_batch
    if shape.kind == "train":
        out = {"tokens": TensorSpec((b, shape.seq_len), torch.int32, dev),
               "labels": TensorSpec((b, shape.seq_len), torch.int32, dev)}
        out.update(_extras(cfg, b, dtype, dev))
        return out
    if shape.kind == "prefill":
        out = {"tokens": TensorSpec((b, shape.seq_len), torch.int32, dev)}
        out.update(_extras(cfg, b, dtype, dev))
        return out
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), torch.int32, dev)}
    raise ValueError(shape.kind)


def _specs(tree, dev: torch.device):
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype, dev), tree)


def param_specs(cfg: ModelConfig, device: DeviceLike = None
                ) -> Dict[str, TensorSpec]:
    """The LM's state dict as specs (the reference's ``jax.eval_shape``
    over ``Model.init``)."""
    dev = resolve(device)
    return _specs(lm.init_params(cfg, torch.Generator(), device="meta"), dev)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, plan=None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """The decode cache's tree as specs (``eval_shape`` over
    ``init_cache``), int8 under ``plan.kv_cache_quant``."""
    dev = resolve(device)
    quant = bool(plan and getattr(plan, "kv_cache_quant", False))
    return _specs(lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                device="meta", quant=quant), dev)


def opt_specs(params: Dict[str, TensorSpec], tcfg: TrainConfig
              ) -> Dict[str, Any]:
    """``train.optimizer.init``'s state as specs: the moments (and the
    master copy) beside each parameter, a scalar int32 count."""
    mdt = lm.torch_dtype(tcfg.master_dtype)
    dev = next(iter(params.values())).device
    state: Dict[str, Any] = {
        "m": {n: TensorSpec(p.shape, mdt, p.device)
              for n, p in params.items()},
        "v": {n: TensorSpec(p.shape, mdt, p.device)
              for n, p in params.items()},
        "count": TensorSpec((), torch.int32, dev),
    }
    if tcfg.use_master_copy:
        state["master"] = {n: TensorSpec(p.shape, torch.float32, p.device)
                           for n, p in params.items()}
    return state


def logical_batch_axes(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, tuple]:
    """Logical sharding axes of each batch input."""
    if shape.kind == "train":
        out = {"tokens": ("batch", None), "labels": ("batch", None)}
    else:
        out = {"tokens": ("batch", None)}
    if cfg.family == "vlm" and shape.kind != "decode":
        out["img_embed"] = ("batch", None, None)
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = ("batch", None, None)
    return out


def step_spec(device: DeviceLike = None) -> TensorSpec:
    """The train step's scalar int32 step counter."""
    return TensorSpec((), torch.int32, resolve(device))


__all__ = ["batch_specs", "cache_specs", "logical_batch_axes", "opt_specs",
           "param_specs", "step_spec"]
