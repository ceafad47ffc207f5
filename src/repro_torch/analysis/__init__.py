"""repro_torch.analysis — static analysis that prunes a plan before any
trace, the port of ``repro.analysis`` (paper §II.A: structure analysis
precedes every measurement).

  * :func:`lint_plan` — pure-arithmetic feasibility of a Plan × mesh ×
    arch spec (``plan_lint``), at the H100's memory by default; the router
    lints every endpoint with it before scoring.
  * :mod:`~repro_torch.analysis.findings` — the :class:`Finding` record and
    its helpers.

The reference's ``gene_audit`` and ``kernel_lint`` passes join the port
with the static-analysis slice.
"""
from repro_torch.analysis.findings import (ERROR, INFO, WARNING, Finding,
                                           findings_to_json, has_errors,
                                           max_severity, sort_findings)
from repro_torch.analysis.plan_lint import DEVICE_MEMORY_BYTES, lint_plan

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "findings_to_json",
    "has_errors", "max_severity", "sort_findings",
    "DEVICE_MEMORY_BYTES", "lint_plan",
]
