"""Energy model: power envelope x utilization -> joules per step; the port
of ``repro.power.model``.

The model the ``power`` / ``edp`` selection policies rank with
(arXiv 2110.11520 changes the paper's objective from "fastest correct
destination" to performance per watt without changing the pipeline):

    avg_watts = idle_w + active_w * mix
    mix       = (1 - mem_frac) * compute_util + mem_frac * memory_util
    energy_j  = avg_watts * step_time_s

The planner's records carry host times only (a mesh roofline comes with the
modeled-cost slice), so a record is charged envelope x host time at full
utilization — peak watts for the measured seconds, the most conservative
charge.  The continuous batcher charges each tick with
:meth:`EnergyModel.tick_joules`.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.power.envelope import PowerEnvelope


@dataclass(frozen=True)
class EnergyReport:
    """Modeled energy of one destination's step (lower is better)."""
    energy_j: float          # joules per step
    avg_watts: float         # average draw across the step
    edp: float               # energy-delay product, J*s
    perf_per_watt: float     # steps per joule (throughput / watts)
    step_time_s: float
    source: str              # "host-time"
    envelope: str            # name of the envelope charged

    def to_dict(self) -> dict:
        return asdict(self)


class EnergyModel:
    """Turns host times into :class:`EnergyReport`s under one
    :class:`PowerEnvelope`."""

    def __init__(self, envelope: PowerEnvelope):
        self.envelope = envelope

    def watts(self, compute_util: float, memory_util: float) -> float:
        env = self.envelope
        mix = ((1.0 - env.memory_w_fraction) * compute_util
               + env.memory_w_fraction * memory_util)
        return env.idle_w + env.active_w * min(max(mix, 0.0), 1.0)

    def from_time(self, time_s: float,
                  utilization: float = 1.0) -> Optional[EnergyReport]:
        """Envelope x host-time: the destination is assumed busy at
        ``utilization`` (default 1.0 => peak watts) for the measured
        seconds."""
        if not (time_s > 0.0) or time_s == float("inf"):
            return None
        # compute AND memory busy at the same level: utilization=1.0 is
        # peak_w exactly, whatever the envelope's memory fraction
        watts = self.watts(utilization, utilization)
        energy = watts * time_s
        return EnergyReport(
            energy_j=energy, avg_watts=watts, edp=energy * time_s,
            perf_per_watt=(1.0 / energy) if energy > 0 else 0.0,
            step_time_s=time_s, source="host-time",
            envelope=self.envelope.name)

    def tick_joules(self, tick_s: float,
                    active_fraction: float = 1.0) -> float:
        """Joules one serving tick burns (repro_torch.serve.metrics).

        A continuous-batching slot pool runs the same decode step however
        many slots are live, so draw scales with occupancy, not work: idle
        watts are burned for the whole tick unconditionally, active watts
        for the ``active_fraction`` of slots doing useful decode — the
        idle-power term is exactly why batching together is cheaper per
        token than decoding alone.
        """
        if not (tick_s > 0.0):
            return 0.0
        af = min(max(active_fraction, 0.0), 1.0)
        return (self.envelope.idle_w
                + self.envelope.active_w * af) * tick_s


def energy_for_record(record, envelope: PowerEnvelope
                      ) -> Optional[EnergyReport]:
    """Energy of one planner :class:`VerificationRecord`: envelope x host
    time; None when the record has nothing usable (inf / incorrect records
    are never charged)."""
    if not getattr(record, "correct", True):
        return None
    return EnergyModel(envelope).from_time(
        getattr(record, "best_time_s", float("inf")))
