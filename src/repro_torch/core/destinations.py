"""Compatibility names over :mod:`repro_torch.backends`, the port of
``repro.core.destinations``.

The destination layer is the pluggable backend API: identity, search
strategy and mesh hook live on :class:`repro_torch.backends.Backend`, and the
paper's §II.C verification order is derived by
``BackendRegistry.verification_order()`` from each backend's declared
``verify_time`` and ``methods``.  The older names keep working:

  * ``Destination``        — alias of :class:`repro_torch.backends.Backend`;
  * ``MANY_CORE / GPU / FPGA`` — the built-in backend instances;
  * ``ALL / BY_NAME / BY_ANALOGUE`` — snapshots of the default registry,
    taken at import time;
  * ``VERIFICATION_ORDER`` — the default registry's derived order at import
    time (the paper's six verifications).

Backends registered on ``DEFAULT_REGISTRY`` after this module is imported
appear in the planner's live ``verification_order()`` but not in these
snapshots; new code reads :mod:`repro_torch.backends` directly.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.backends.base import Backend as Destination
from repro_torch.backends.builtin import DEFAULT_REGISTRY, FPGA, GPU, MANY_CORE

ALL: List[Destination] = list(DEFAULT_REGISTRY)
BY_NAME: Dict[str, Destination] = DEFAULT_REGISTRY.by_name
BY_ANALOGUE: Dict[str, Destination] = DEFAULT_REGISTRY.by_analogue

# Paper §II.C verification order, derived: function blocks first, FPGA last
# (slowest to verify); within each method many-core CPU, GPU, FPGA.
VERIFICATION_ORDER = DEFAULT_REGISTRY.verification_order()

__all__ = ["Destination", "MANY_CORE", "GPU", "FPGA",
           "ALL", "BY_NAME", "BY_ANALOGUE", "VERIFICATION_ORDER"]
