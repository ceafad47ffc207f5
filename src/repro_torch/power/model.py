"""Energy model: power envelope x utilization -> joules per step; the port
of ``repro.power.model``.

The model the ``power`` / ``edp`` selection policies rank with
(arXiv 2110.11520 changes the paper's objective from "fastest correct
destination" to performance per watt without changing the pipeline):

    avg_watts = idle_w + active_w * mix
    mix       = (1 - mem_frac) * compute_util
                + mem_frac * (memory_util + collective_util)
    energy_j  = avg_watts * step_time_s

``compute_util`` / ``memory_util`` / ``collective_util`` are the roofline
terms divided by the (bubble-stretched) step time
(:func:`repro_torch.core.cost_model.roofline_terms`), so a pipeline bubble
or a dominant collective lowers the draw but lengthens the step — and the
idle power burned across the stretch makes energy strictly *increase* with
the bubble fraction.  Communication is charged at the memory fraction of
the active draw: moving bytes exercises the memory/IO system, not the ALUs.

When no roofline was recorded (a host-only verification), the fallback is
envelope x host time at full utilization — peak watts for the measured
seconds, the most conservative charge.  The continuous batcher charges each
tick with :meth:`EnergyModel.tick_joules`.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Mapping, Optional

from repro_torch.power.envelope import PowerEnvelope


@dataclass(frozen=True)
class EnergyReport:
    """Modeled energy of one destination's step (lower is better)."""
    energy_j: float          # joules per step
    avg_watts: float         # average draw across the step
    edp: float               # energy-delay product, J*s
    perf_per_watt: float     # steps per joule (throughput / watts)
    step_time_s: float
    source: str              # "roofline" | "host-time"
    envelope: str            # name of the envelope charged

    def to_dict(self) -> dict:
        return asdict(self)


def _term(rl, name: str, default: float = 0.0) -> float:
    if isinstance(rl, Mapping):
        v = rl.get(name, default)
    else:
        v = getattr(rl, name, default)
    return float(v) if v is not None else default


class EnergyModel:
    """Turns rooflines (or bare host times) into :class:`EnergyReport`s
    under one :class:`PowerEnvelope`."""

    def __init__(self, envelope: PowerEnvelope):
        self.envelope = envelope

    def watts(self, compute_util: float, memory_util: float,
              collective_util: float = 0.0) -> float:
        env = self.envelope
        mix = ((1.0 - env.memory_w_fraction) * compute_util
               + env.memory_w_fraction * (memory_util + collective_util))
        return env.idle_w + env.active_w * min(max(mix, 0.0), 1.0)

    def _report(self, watts: float, step_s: float, source: str
                ) -> EnergyReport:
        energy = watts * step_s
        return EnergyReport(
            energy_j=energy, avg_watts=watts, edp=energy * step_s,
            perf_per_watt=(1.0 / energy) if energy > 0 else 0.0,
            step_time_s=step_s, source=source, envelope=self.envelope.name)

    def from_roofline(self, rl) -> Optional[EnergyReport]:
        """Energy of a modeled step.  ``rl`` is a
        :class:`~repro_torch.core.cost_model.Roofline` or its ``to_dict()``
        form (``VerificationRecord.mesh_info["roofline"]``); dicts without
        the utilization terms fall back to term_s / step_time_s."""
        step = _term(rl, "step_time_s")
        if step <= 0.0:
            return None
        cu = _term(rl, "compute_util", _term(rl, "compute_s") / step)
        mu = _term(rl, "memory_util", _term(rl, "memory_s") / step)
        xu = _term(rl, "collective_util", _term(rl, "collective_s") / step)
        return self._report(self.watts(cu, mu, xu), step, "roofline")

    def from_time(self, time_s: float,
                  utilization: float = 1.0) -> Optional[EnergyReport]:
        """Envelope x host-time fallback: the destination is assumed busy at
        ``utilization`` (default 1.0 => peak watts) for the measured
        seconds."""
        if not (time_s > 0.0) or time_s == float("inf"):
            return None
        # compute AND memory busy at the same level: utilization=1.0 is
        # peak_w exactly, whatever the envelope's memory fraction
        return self._report(self.watts(utilization, utilization), time_s,
                            "host-time")

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


def cell_energy(rl, n_chips: float) -> Optional[EnergyReport]:
    """Energy of one modeled mesh cell: the H100 card envelope scaled to
    the cell's cards, at the cell roofline's utilization — the one charge
    rule of modeled cells (``Candidate.from_roofline``)."""
    from repro_torch.power.envelope import H100_SXM
    return EnergyModel(H100_SXM.scaled(n_chips)).from_roofline(rl)


def energy_for_record(record, envelope: PowerEnvelope
                      ) -> Optional[EnergyReport]:
    """Energy of one planner :class:`VerificationRecord`: modeled from the
    mesh-verified roofline when a ``cost_runner`` recorded one, envelope x
    host-time otherwise; None when the record has nothing usable (inf /
    incorrect records are never charged)."""
    if not getattr(record, "correct", True):
        return None
    rl = (record.mesh_info or {}).get("roofline") \
        if getattr(record, "mesh_info", None) else None
    model = EnergyModel(envelope)
    if rl:
        rep = model.from_roofline(rl)
        if rep is not None:
            return rep
    return model.from_time(getattr(record, "best_time_s", float("inf")))
