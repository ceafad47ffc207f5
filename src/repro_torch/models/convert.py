"""Carry LM weights between the JAX package's parameter tree and the port.

The JAX ``Model.init`` tree (as numpy: ``jax.tree.map(np.asarray, params)``)
nests dicts and stacks the layers on a leading axis (``blocks`` leaves are
``[L, ...]``).  The port's :class:`~repro_torch.models.lm.LM` takes a flat
state dict with one entry per layer (``blocks.{i}.attn.wq``).  Layouts are
the same on both sides, so the conversion only renames, unstacks and casts.
The hybrid's groups (``blocks`` leaves ``[groups, ...]``) unstack to
``blocks.{g}.b{j}.…`` and its ``tail`` list to ``tail.{i}.…``.
numpy has no bfloat16: a bfloat16 leaf goes through float32, which is exact
both ways.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.lm import (Params, check_supported, flatten,
                                   hybrid_groups, torch_dtype)
from repro_torch.models.rglru import FP32_LEAVES as _LRU_FP32
from repro_torch.models.ssm import FP32_LEAVES as _SSM_FP32

FP32_LEAVES = _SSM_FP32 + _LRU_FP32


def _nest(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _layers(tree: Dict[str, Any], cfg: ModelConfig):
    """(port name, numpy leaf) of every layer's parameters: the ``blocks``
    leaves ``[L, ...]`` unstacked (the hybrid's ``[groups, ...]``, whose
    rows become ``blocks.{g}``), and the hybrid's ``tail`` list."""
    n = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    for name, leaf in flatten(tree["blocks"]).items():
        if leaf.shape[0] != n:
            raise ValueError(f"blocks.{name} stacks {leaf.shape[0]} layers, "
                             f"{cfg.name} has {n}")
        for i in range(n):
            yield f"blocks.{i}.{name}", leaf[i]
    for i, block in enumerate(tree.get("tail", [])):
        yield from flatten(block, f"tail.{i}.").items()


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Params:
    """The JAX parameter tree (numpy leaves) -> the port's state dict on
    ``device`` (default ``cuda``), in ``cfg.param_dtype`` but for the
    leaves the JAX init keeps in float32 (the SSD's ``A_log``, ``D``,
    ``dt_bias`` and the RG-LRU's ``lam``)."""
    check_supported(cfg)
    dev = resolve(device)
    dt = torch_dtype(cfg.param_dtype)

    def tensor(name, a):
        keep = name.rsplit(".", 1)[-1] in FP32_LEAVES
        return torch.from_numpy(np.array(a, np.float32)).to(
            dev, torch.float32 if keep else dt)

    out: Params = {}
    for name, leaf in flatten({k: v for k, v in tree.items()
                               if k not in ("blocks", "tail")}).items():
        out[name] = tensor(name, leaf)
    for name, leaf in _layers(tree, cfg):
        out[name] = tensor(name, leaf)
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state dict -> the JAX tree's nesting and stacking, as
    float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    tail: Dict[int, Dict[str, Any]] = {}
    n = hybrid_groups(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    for name, t in params.items():
        a = t.detach().float().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, [None] * n)[int(i)] = a
        elif name.startswith("tail."):
            _, i, rest = name.split(".", 2)
            _nest(tail.setdefault(int(i), {}), rest, a)
        else:
            _nest(tree, name, a)
    blocks: Dict[str, Any] = {}
    for rest, leaves in per_layer.items():
        _nest(blocks, rest, np.stack(leaves))
    tree["blocks"] = blocks
    if tail:
        tree["tail"] = [tail[i] for i in sorted(tail)]
    return tree
