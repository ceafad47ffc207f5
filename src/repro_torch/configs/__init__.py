"""Config registry: one module per assigned architecture.

``get_config("granite-3-2b")`` returns the full published config;
``get_config(name).reduced()`` the CPU smoke-test version.
"""
from __future__ import annotations

from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                HybridConfig, ShapeConfig, TrainConfig,
                                SHAPES)

from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _danube
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _llama_vision
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        _granite, _danube, _command_r, _nemotron, _moonshot,
        _arctic, _rgemma, _mamba2, _llama_vision, _seamless,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES)}")
    return SHAPES[name]


def cells():
    """All 40 (arch, shape) cells; runnable() marks long_500k skips."""
    for a in ARCHS.values():
        for s in SHAPES.values():
            yield a, s


def cell_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.is_sub_quadratic
    return True


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "HybridConfig",
           "ShapeConfig", "TrainConfig", "SHAPES", "ARCHS", "get_config",
           "get_shape", "cells", "cell_runnable"]
