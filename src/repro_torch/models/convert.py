"""Carry LM weights between the JAX package's parameter tree and the port.

The JAX ``Model.init`` tree (as numpy: ``jax.tree.map(np.asarray, params)``)
nests dicts and stacks the layers on leading axes (``blocks`` leaves are
``[L, ...]``).  The port's :class:`~repro_torch.models.lm.LM` takes a flat
state dict with one entry per layer (``blocks.{i}.attn.wq``).  Layouts are
the same on both sides, so the conversion only renames, unstacks and casts.
The stacks (:func:`stacks`): ``blocks`` ``[L, ...]`` (the hybrid's
``[groups, ...]``, whose rows become ``blocks.{g}.b{j}.…``), the VLM's
``self_blocks`` ``[groups, per, ...]`` (``self_blocks.{g}.{j}.…``) and
``cross_blocks`` ``[groups, ...]``, the audio family's ``enc_blocks``
``[encoder_layers, ...]`` and ``dec_blocks`` ``[L, ...]``
(``dec_blocks.{i}.self.…``, ``dec_blocks.{i}.cross.…``); the hybrid's
``tail`` list unstacks to ``tail.{i}.…``.
numpy has no bfloat16: a bfloat16 leaf goes through float32, which is exact
both ways.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.lm import (Params, check_supported, flatten,
                                   hybrid_groups, torch_dtype, vlm_groups)
from repro_torch.models.rglru import FP32_LEAVES as _LRU_FP32
from repro_torch.models.ssm import FP32_LEAVES as _SSM_FP32

FP32_LEAVES = _SSM_FP32 + _LRU_FP32


def _nest(tree: Dict[str, Any], dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


def stacks(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The JAX tree's stacked subtrees of ``cfg`` and their leading
    (stacking) axes."""
    if cfg.family == "vlm":
        groups, per = vlm_groups(cfg)
        return {"self_blocks": (groups, per), "cross_blocks": (groups,)}
    if cfg.family == "audio":
        return {"enc_blocks": (cfg.encoder_layers,),
                "dec_blocks": (cfg.n_layers,)}
    if cfg.family == "hybrid":
        return {"blocks": (hybrid_groups(cfg)[0],)}
    return {"blocks": (cfg.n_layers,)}


def _layers(tree: Dict[str, Any], cfg: ModelConfig):
    """(port name, numpy leaf) of every layer's parameters: each stack's
    leaves unstacked, one name part per stacking axis, and the hybrid's
    ``tail`` list."""
    for key, lead in stacks(cfg).items():
        for name, leaf in flatten(tree[key]).items():
            if tuple(leaf.shape[:len(lead)]) != lead:
                raise ValueError(f"{key}.{name} stacks "
                                 f"{tuple(leaf.shape[:len(lead)])} layers, "
                                 f"{cfg.name} has {lead}")
            for idx in np.ndindex(*lead):
                yield (".".join([key, *map(str, idx), name]), leaf[idx])
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

    layered = set(stacks(cfg)) | {"tail"}
    out: Params = {}
    for name, leaf in flatten({k: v for k, v in tree.items()
                               if k not in layered}).items():
        out[name] = tensor(name, leaf)
    for name, leaf in _layers(tree, cfg):
        out[name] = tensor(name, leaf)
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state dict -> the JAX tree's nesting and stacking, as
    float32 numpy arrays."""
    tree: Dict[str, Any] = {}
    lead_of = stacks(cfg)
    per_layer: Dict[str, Dict[str, dict]] = {k: {} for k in lead_of}
    tail: Dict[int, Dict[str, Any]] = {}
    for name, t in params.items():
        a = t.detach().float().cpu().numpy()
        key = name.split(".", 1)[0]
        if key in lead_of:
            parts = name.split(".", len(lead_of[key]) + 1)
            idx = tuple(int(i) for i in parts[1:-1])
            per_layer[key].setdefault(parts[-1], {})[idx] = a
        elif key == "tail":
            _, i, rest = name.split(".", 2)
            _nest(tail.setdefault(int(i), {}), rest, a)
        else:
            _nest(tree, name, a)
    for key, lead in lead_of.items():
        tree[key] = {}
        for rest, leaves in per_layer[key].items():
            first = next(iter(leaves.values()))
            _nest(tree[key], rest, np.stack(
                [leaves[idx] for idx in np.ndindex(*lead)]).reshape(
                    *lead, *first.shape))
    if tail:
        tree["tail"] = [tail[i] for i in sorted(tail)]
    return tree
