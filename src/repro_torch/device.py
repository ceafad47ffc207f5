"""Device resolution for the port's entry points.

Entry points run on the card unless the caller names another device: with
``device=None`` they take ``cuda`` and raise when there is none, never
carrying on on the CPU.  They also turn TF32 off, so fp32 matrix products
and convolutions (the tdFIR ``dp`` conv goes through cuDNN) keep full fp32
precision and the planner's correctness checks compare real fp32 results.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (default ``cuda``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller asks for another device (device='cpu')")
    return dev


def state_device(state) -> Optional[torch.device]:
    """The device of the first tensor in a state dict (None if it has
    none)."""
    for v in state.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return None
