"""Shared finding record for the static-analysis passes (repro_torch.analysis).

Every pass — plan lint, gene-contract audit, kernel lint — reports
:class:`Finding` records instead of raising: static analysis *narrows* the
search (paper §II.A: Clang structure analysis runs before any measurement);
it must never crash it.  Severity semantics:

  * ``error``   — the artifact provably cannot be built / verified (a trace
    or trace would fail, or a cache contract is violated): consumers prune
    the candidate with the paper's penalty, no trace spent.
  * ``warning`` — the plan lowers but a requested behavior silently does not
    happen (an inert gene, a schedule that falls back to sequential, a
    sharding request that replicates instead).
  * ``info``    — an observation worth surfacing (an arch property, an
    explicit-padding note), never a gate.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"

# ordering for sorting / max_severity (most severe first)
SEVERITIES = (ERROR, WARNING, INFO)
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    ``rule_id`` is stable and grep-able (``P...`` plan lint, ``G...`` gene
    audit, ``K...`` kernel lint); ``plan_field`` names the Plan dataclass
    field (or kernel parameter) the finding anchors to, when one exists;
    ``subject`` tags what was linted (plan name, kernel name, gene field)
    so the CLI can group findings across a configs × plans sweep.
    """
    rule_id: str
    severity: str
    message: str
    plan_field: Optional[str] = None
    subject: str = ""
    context: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        out = {"rule_id": self.rule_id, "severity": self.severity,
               "message": self.message}
        if self.plan_field:
            out["plan_field"] = self.plan_field
        if self.subject:
            out["subject"] = self.subject
        if self.context:
            out["context"] = dict(self.context)
        return out


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Most severe first; stable within a severity."""
    return sorted(findings, key=lambda f: _RANK.get(f.severity, len(_RANK)))


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == ERROR for f in findings)


def max_severity(findings: Iterable[Finding]) -> Optional[str]:
    worst = None
    for f in findings:
        if worst is None or _RANK.get(f.severity, 99) < _RANK.get(worst, 99):
            worst = f.severity
    return worst


def findings_to_json(findings: Iterable[Finding]) -> List[dict]:
    return [f.to_dict() for f in sort_findings(findings)]
