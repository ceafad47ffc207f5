"""repro_torch.runtime — keep the selected destination honest while it runs;
the port of ``repro.runtime``.

  * :mod:`repro_torch.runtime.fault_tolerance` — :class:`StragglerWatchdog`
    and :func:`run_resilient`, the checkpointed, self-restarting training
    loop.
  * :mod:`repro_torch.runtime.elastic` — reshard-on-restore across mesh
    sizes (``reshard_restore``, ``available_mesh``); :class:`ResizeEvent`
    / :func:`detect_resize` signal capacity changes.
  * :mod:`repro_torch.runtime.control` — the online fleet control loop
    (:class:`FleetController`, :class:`FaultInjector`,
    :class:`ControlLoop`) closing plan -> serve -> observe -> replan.

Exports resolve lazily (PEP 562): importing :mod:`repro_torch.runtime` does
not eagerly import submodules, so the pure-arithmetic pieces (health,
control) stay importable in trace-poisoned tests and lightweight tools.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "Fault": "repro_torch.runtime.control",
    "FaultInjector": "repro_torch.runtime.control",
    "FleetController": "repro_torch.runtime.control",
    "ControlLoop": "repro_torch.runtime.control",
    "StragglerWatchdog": "repro_torch.runtime.fault_tolerance",
    "ResilientLoopResult": "repro_torch.runtime.fault_tolerance",
    "run_resilient": "repro_torch.runtime.fault_tolerance",
    "ResizeEvent": "repro_torch.runtime.elastic",
    "detect_resize": "repro_torch.runtime.elastic",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:                               # pragma: no cover
    from repro_torch.runtime.control import (  # noqa: F401
        ControlLoop, Fault, FaultInjector, FleetController)
    from repro_torch.runtime.elastic import (  # noqa: F401
        ResizeEvent, detect_resize)
    from repro_torch.runtime.fault_tolerance import (  # noqa: F401
        ResilientLoopResult, StragglerWatchdog, run_resilient)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
