"""The paper's three evaluated applications as offloadable PyTorch apps.

The apps have no weights; what carries across from the JAX package is the
state dict.  :func:`state_from_numpy` / :func:`state_to_numpy` turn a state
of numpy arrays into the port's tensors and back, so both packages can
compute on the same numbers.
"""
from typing import Dict

import numpy as np
import torch

from repro_torch.apps.mm3 import build_app as build_mm3
from repro_torch.apps.nasbt import build_app as build_nasbt
from repro_torch.apps.tdfir_app import build_app as build_tdfir
from repro_torch.apps import registry  # populates the FB registry on import

APPS = {"3mm": build_mm3, "NAS.BT": build_nasbt, "tdFIR": build_tdfir}


def state_from_numpy(state: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in state.items()}


def state_to_numpy(state: Dict) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


__all__ = ["build_mm3", "build_nasbt", "build_tdfir", "APPS", "registry",
           "state_from_numpy", "state_to_numpy"]
