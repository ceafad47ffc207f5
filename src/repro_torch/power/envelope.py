"""Per-destination power envelopes (arXiv 2110.11520's measured machines),
the port of ``repro.power.envelope``.

A :class:`PowerEnvelope` is the static electrical identity of one offload
destination: what it draws doing nothing (``idle_w``), what it draws flat
out (``peak_w``), and how much of the active draw belongs to the memory
system rather than the compute units (``memory_w_fraction``).  The energy
model (:mod:`repro_torch.power.model`) interpolates between idle and peak
with utilization.

Calibration contract (see ROADMAP "repro.power"): the built-in numbers are
vendor TDP / idle figures for the evaluation hardware of Yamato's power
follow-up (Xeon E5-2660 v4 many-core, Tesla T4 GPU, Intel PAC Arria 10
FPGA).  Only their *relative* shape matters for selection; override per
backend through its ``power`` field or per call by passing an envelope to
:class:`~repro_torch.power.model.EnergyModel`.  Modeled mesh cells
(:func:`repro_torch.power.model.cell_energy`) are charged on
:data:`H100_SXM`, the card the port runs on, beside that calibration.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class PowerEnvelope:
    """Idle/peak draw (+ memory share of the active draw) of one device."""
    name: str
    idle_w: float
    peak_w: float
    # fraction of the active (peak - idle) draw attributable to the memory
    # system; the rest follows compute utilization
    memory_w_fraction: float = 0.3

    def __post_init__(self):
        if self.idle_w < 0 or self.peak_w <= 0:
            raise ValueError(f"non-physical envelope {self.name!r}: "
                             f"idle={self.idle_w}, peak={self.peak_w}")
        if self.peak_w < self.idle_w:
            raise ValueError(f"envelope {self.name!r}: peak_w {self.peak_w} "
                             f"< idle_w {self.idle_w}")
        if not 0.0 <= self.memory_w_fraction <= 1.0:
            raise ValueError(f"envelope {self.name!r}: memory_w_fraction "
                             f"must be in [0, 1]")

    @property
    def active_w(self) -> float:
        return self.peak_w - self.idle_w

    def scaled(self, n: float, name: Optional[str] = None) -> "PowerEnvelope":
        """The envelope of ``n`` such devices (a mesh slice draws n cards)."""
        if n <= 0:
            raise ValueError(f"cannot scale envelope by n={n}")
        return replace(self, name=name or f"{self.name}x{n:g}",
                       idle_w=self.idle_w * n, peak_w=self.peak_w * n)

    def __add__(self, other) -> "PowerEnvelope":
        """The combined envelope of two co-located devices: draws sum, the
        memory share of the combined active draw is the active-weighted mix
        of each device's share.  This is the one definition of "summed
        fleet draw" shared by Router admission headroom and the fleet
        placement planner's power-cap check."""
        if not isinstance(other, PowerEnvelope):
            return NotImplemented
        active = self.active_w + other.active_w
        mem = ((self.active_w * self.memory_w_fraction
                + other.active_w * other.memory_w_fraction) / active
               if active > 0 else self.memory_w_fraction)
        return PowerEnvelope(name=f"{self.name}+{other.name}",
                             idle_w=self.idle_w + other.idle_w,
                             peak_w=self.peak_w + other.peak_w,
                             memory_w_fraction=mem)

    def __radd__(self, other) -> "PowerEnvelope":
        # lets sum(envelopes) work: 0 + envelope == envelope
        if other == 0:
            return self
        return NotImplemented


# Built-in calibration (vendor TDP/idle for the power follow-up's machines).
MANY_CORE_XEON = PowerEnvelope("xeon-e5-2660v4", idle_w=55.0, peak_w=105.0,
                               memory_w_fraction=0.35)
GPU_T4 = PowerEnvelope("tesla-t4", idle_w=10.0, peak_w=70.0,
                       memory_w_fraction=0.25)
FPGA_A10 = PowerEnvelope("intel-pac-arria10", idle_w=25.0, peak_w=66.0,
                         memory_w_fraction=0.20)
# per-card envelope of modeled mesh cells (cell_energy), scaled by the
# cell's card count.  peak_w: the power limit nvidia-smi reports for an
# NVIDIA H100 80GB HBM3 (power.limit 700.00 W); idle_w: nvidia-smi
# power.draw of that card idle, before any process opened it (71.32 W
# in P0, printed by chip_smoke.py's phase 1 as the first program run on
# a freshly started machine).  The memory fraction is the
# reference's 0.30 for its chip envelope, a model parameter carried over,
# not a measurement.
H100_SXM = PowerEnvelope("nvidia-h100-80gb-hbm3", idle_w=71.32, peak_w=700.0,
                         memory_w_fraction=0.30)
# last-resort envelope for destinations that declare nothing
GENERIC = PowerEnvelope("generic-accelerator", idle_w=50.0, peak_w=150.0,
                        memory_w_fraction=0.30)

# paper_analogue -> envelope for the built-in destinations (kept here so
# repro_torch.backends can stay import-light; Backend.power overrides this)
BY_ANALOGUE = {
    "many-core CPU": MANY_CORE_XEON,
    "GPU": GPU_T4,
    "GPU library": GPU_T4,
    "FPGA": FPGA_A10,
}


def envelope_for(backend) -> PowerEnvelope:
    """The envelope the planner charges a backend's records against:
    the backend's declared ``power``, else the built-in calibration for its
    paper analogue, else :data:`GENERIC`."""
    declared = getattr(backend, "power", None)
    if declared is not None:
        return declared
    return BY_ANALOGUE.get(getattr(backend, "paper_analogue", ""), GENERIC)


def fleet_draw_w(draws) -> float:
    """Aggregate modeled draw (watts) of a fleet — the one summation the
    Router's admission headroom and the fleet planner's power-cap check
    share.  ``draws`` is an iterable of per-endpoint/per-app watts; a None
    entry (an app whose draw could not be modeled) is charged as if it
    were not there — callers that must be conservative should have dropped
    unmodeled candidates at ranking time (``rank(power_budget_w=...)``
    already does)."""
    return float(sum(d for d in draws if d is not None))
