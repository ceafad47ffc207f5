"""Carry LM weights between the JAX package's parameter tree and the port.

The JAX ``Model.init`` tree (as numpy: ``jax.tree.map(np.asarray, params)``)
nests dicts and stacks the layers on a leading axis (``blocks`` leaves are
``[L, ...]``).  The port's :class:`~repro_torch.models.lm.LM` takes a flat
state dict with one entry per layer (``blocks.{i}.attn.wq``).  Layouts are
the same on both sides, so the conversion only renames, unstacks and casts.
numpy has no bfloat16: a bfloat16 leaf goes through float32, which is exact
both ways.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.lm import Params, check_supported, torch_dtype


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _nest(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Params:
    """The JAX parameter tree (numpy leaves) -> the port's state dict on
    ``device`` (default ``cuda``), in ``cfg.param_dtype``."""
    check_supported(cfg)
    dev = resolve(device)
    dt = torch_dtype(cfg.param_dtype)

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    out: Params = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "blocks"}):
        out[name] = tensor(leaf)
    for name, leaf in _flatten(tree["blocks"]):
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"blocks.{name} stacks {leaf.shape[0]} layers, "
                             f"{cfg.name} has {cfg.n_layers}")
        for i in range(cfg.n_layers):
            out[f"blocks.{i}.{name}"] = tensor(leaf[i])
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state dict -> the JAX tree's nesting and stacking, as
    float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    per_layer: Dict[str, list] = {}
    for name, t in params.items():
        a = t.detach().float().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(rest, [None] * cfg.n_layers)[int(i)] = a
        else:
            _nest(tree, name, a)
    blocks: Dict[str, Any] = {}
    for rest, leaves in per_layer.items():
        _nest(blocks, rest, np.stack(leaves))
    tree["blocks"] = blocks
    return tree
