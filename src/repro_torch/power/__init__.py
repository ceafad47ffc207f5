"""repro_torch.power — the energy model the planner charges every correct
verification against, the port of ``repro.power``.

  * :class:`PowerEnvelope` — idle/peak watts + memory-power fraction of one
    destination; built-ins :data:`MANY_CORE_XEON`, :data:`GPU_T4`,
    :data:`FPGA_A10`, :data:`H100_SXM` (modeled mesh cells),
    :data:`GENERIC`; ``envelope_for(backend)``; ``PowerEnvelope.__add__``
    composes co-located device envelopes.
  * :class:`EnergyModel` / :class:`EnergyReport` — roofline utilization (or
    host time) x envelope -> joules, watts, EDP; ``tick_joules`` charges
    one serving tick.
  * :func:`energy_for_record` — the planner's per-record charge rule;
    :func:`cell_energy` — the charge of a modeled mesh cell.
  * :func:`fleet_draw_w` — the one definition of summed fleet draw
    (Router admission headroom and the fleet planner's power cap).
"""
from repro_torch.power.envelope import (BY_ANALOGUE, FPGA_A10, GENERIC,
                                        GPU_T4, H100_SXM, MANY_CORE_XEON,
                                        PowerEnvelope, envelope_for,
                                        fleet_draw_w)
from repro_torch.power.model import (EnergyModel, EnergyReport, cell_energy,
                                     energy_for_record)

__all__ = [
    "PowerEnvelope", "EnergyModel", "EnergyReport",
    "MANY_CORE_XEON", "GPU_T4", "FPGA_A10", "H100_SXM", "GENERIC",
    "BY_ANALOGUE", "envelope_for", "energy_for_record", "cell_energy",
    "fleet_draw_w",
]
