"""One candidate datatype for destination selection, the port of
``repro.core.candidates``.

:class:`Candidate` carries everything a policy may rank on plus ``ref``,
the underlying object the caller gets back after ranking.  The
constructors encode the four source shapes exactly once: ``from_record``
(planner verification records), ``from_analysis`` (warm
:class:`~repro_torch.core.plan_lookup.PlanLookup` payloads, the zero-trace
path), ``from_cell`` (modeled mesh cells) and ``from_roofline``
(roofline-scored search candidates).  Everything here is pure arithmetic
over dicts and dataclasses: building a Candidate from a warm analysis
never traces.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Candidate:
    """One rankable (destination, plan) option.

    The scoring fields mirror the planner's ``VerificationRecord`` duck
    type; unknown attribute reads fall through to ``ref``.
    """
    backend: str = ""                       # destination / backend name
    arch: str = ""                          # app or model architecture
    plan_key: Optional[tuple] = None        # plan structural key
    best_time_s: float = math.inf           # measured-or-modeled seconds
    price: float = 1.0                      # paper's relative price
    correct: bool = True                    # correctness verdict
    mesh_time_s: Optional[float] = None     # modeled (roofline) seconds
    energy_j: Optional[float] = None        # modeled joules
    avg_watts: Optional[float] = None       # modeled draw
    source: str = ""                        # record|analysis|cell|roofline
    info: Dict = field(default_factory=dict)
    ref: object = None                      # the wrapped original object

    def __getattr__(self, name):
        # only reached when normal attribute lookup fails: delegate to the
        # wrapped object so policies can read its extra fields
        ref = self.__dict__.get("ref")
        if ref is not None and not name.startswith("_"):
            return getattr(ref, name)
        raise AttributeError(name)

    @classmethod
    def from_record(cls, record, arch: str = "") -> "Candidate":
        """Lift a planner ``VerificationRecord``."""
        return cls(
            backend=getattr(record, "destination", ""),
            arch=arch,
            best_time_s=getattr(record, "best_time_s", math.inf),
            price=getattr(record, "price", 1.0),
            correct=getattr(record, "correct", True),
            mesh_time_s=getattr(record, "mesh_time_s", None),
            energy_j=getattr(record, "energy_j", None),
            avg_watts=getattr(record, "avg_watts", None),
            source="record", ref=record)

    @classmethod
    def from_analysis(cls, analysis: Dict[str, float], *, backend,
                      arch: str = "", n_chips: int = 1,
                      price: Optional[float] = None,
                      envelope=None, scale: float = 1.0,
                      bubble_fraction: float = 0.0,
                      plan_key: Optional[tuple] = None,
                      ref: object = None) -> Optional["Candidate"]:
        """Score one warm analysis payload — the zero-trace path.

        ``analysis`` is the dict a :class:`~repro_torch.core.plan_lookup.
        PlanLookup` publishes (flops / bytes / collective_bytes per device,
        FLOPs by dtype); ``scale`` multiplies the modeled step time into a
        service time.  ``backend`` may be a
        :class:`~repro_torch.backends.Backend` or a name; the energy charge
        uses ``envelope`` (default ``envelope_for(backend)``).  Returns None
        when the analysis cannot be scored — pure arithmetic either way.
        """
        from repro_torch.core.measure import CompiledCostRunner
        runner = CompiledCostRunner(n_chips=n_chips)
        ev = runner.score_analysis(dict(analysis),
                                   bubble_fraction=bubble_fraction,
                                   cache_hit=True)
        if not ev.correct or ev.time_s == math.inf:
            return None
        service_s = ev.time_s * scale
        rl = ev.info.get("roofline", {})
        name = getattr(backend, "name", None) or str(backend)
        if price is None:
            price = getattr(backend, "price", 1.0)
        cand = cls(backend=name, arch=arch, plan_key=plan_key,
                   best_time_s=service_s,
                   price=float(price),
                   mesh_time_s=service_s, source="analysis",
                   info={"roofline": rl, "step_time_s": ev.time_s},
                   ref=ref)
        from repro_torch.power import EnergyModel, envelope_for
        env = envelope if envelope is not None else envelope_for(backend)
        rep = EnergyModel(env).from_roofline(rl) if rl else None
        if rep is not None:
            cand.avg_watts = rep.avg_watts
            cand.energy_j = rep.avg_watts * service_s
        return cand

    @classmethod
    def from_cell(cls, step_time_s: float, *, n_chips: float = 1.0,
                  energy: Optional[Dict] = None, backend: str = "cell",
                  arch: str = "", ref: object = None) -> "Candidate":
        """Lift one modeled mesh cell: modeled step time, card count as the
        relative price, and — when the cell was charged — its
        ``EnergyReport.to_dict()`` block."""
        cand = cls(backend=backend, arch=arch,
                   best_time_s=step_time_s, mesh_time_s=step_time_s,
                   price=float(n_chips), source="cell", ref=ref)
        if energy:
            cand.energy_j = energy.get("energy_j")
            cand.avg_watts = energy.get("avg_watts")
            cand.info = {"energy": dict(energy)}
        return cand

    @classmethod
    def from_roofline(cls, rl, *, n_chips: float, price: float = 1.0,
                      time_s: Optional[float] = None, backend: str = "mesh",
                      arch: str = "", ref: object = None) -> "Candidate":
        """Lift one roofline-scored search candidate, charged through the
        modeled-cell rule (``repro_torch.power.cell_energy``, the H100
        envelope) so the energy policies rank it as they rank cells."""
        from repro_torch.power import cell_energy
        rep = cell_energy(rl, n_chips)
        step = time_s
        if step is None:
            step = rl.get("step_time_s") if isinstance(rl, dict) \
                else getattr(rl, "step_time_s", math.inf)
        cand = cls(backend=backend, arch=arch, best_time_s=float(step),
                   mesh_time_s=float(step), price=float(price),
                   source="roofline",
                   info={"roofline": rl if isinstance(rl, dict)
                         else rl.to_dict()},
                   ref=ref)
        if rep is not None:
            cand.energy_j = rep.energy_j
            cand.avg_watts = rep.avg_watts
            cand.info["energy"] = rep.to_dict()
        return cand


def candidates_from_records(records: List, arch: str = "") -> List[Candidate]:
    """Wrap a planner report's records for ``SelectionPolicy.rank``."""
    return [Candidate.from_record(r, arch=arch) for r in records]


def unwrap(selected):
    """The underlying object behind a ranked winner (``Candidate.ref``),
    passing non-Candidates through."""
    if selected is None:
        return None
    if isinstance(selected, Candidate) and selected.ref is not None:
        return selected.ref
    return selected
