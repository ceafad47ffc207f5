"""One candidate datatype for destination selection, the port of the
``from_record`` / ``candidates_from_records`` / ``unwrap`` path of
``repro.core.candidates``.

:class:`Candidate` carries everything a policy may rank on plus ``ref``,
the underlying object the caller gets back after ranking (here a planner
``VerificationRecord``).  The other constructors of the JAX package
(``from_analysis``, ``from_cell``, ``from_roofline``) serve the modeled-cost,
serving and fleet layers and come with those slices.
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
    source: str = ""                        # record
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
