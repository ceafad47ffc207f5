"""repro_torch.analysis — static analysis that prunes the search before any
trace, the port of ``repro.analysis`` (paper §II.A: structure analysis
precedes every measurement).

Three passes, one CLI:

  * :func:`lint_plan` — pure-arithmetic feasibility of a Plan × mesh ×
    arch spec (``plan_lint``), at the H100's memory by default; wired into
    the batch evaluator, the loop searches (``lint_choice``) and the dry
    run, so an error-severity candidate takes the penalty untraced; the
    router lints every endpoint with it before scoring.
  * :func:`audit_gene_space` — proves the ``structural=False`` gene flags
    against the traced artifact (``gene_audit``): the ``SearchCache``
    identity contract, enforced instead of commented.
  * :func:`lint_kernels` — grid, bounds, launch-limit and aliasing checks
    over the CUDA kernels' launch plans (``kernel_lint``).

:mod:`~repro_torch.analysis.findings` holds the :class:`Finding` record and
its helpers.  CLI: ``python -m repro_torch.analysis.lint [--arch ...
--plan ... --strict]``.
"""
from repro_torch.analysis.findings import (ERROR, INFO, WARNING, Finding,
                                           findings_to_json, has_errors,
                                           max_severity, sort_findings)
from repro_torch.analysis.gene_audit import (GeneAudit, audit_findings,
                                             audit_gene_space)
from repro_torch.analysis.kernel_lint import (KernelModel, OperandSpec,
                                              check_model, lint_kernels)
from repro_torch.analysis.plan_lint import DEVICE_MEMORY_BYTES, lint_plan

__all__ = [
    "ERROR", "WARNING", "INFO", "Finding", "findings_to_json",
    "has_errors", "max_severity", "sort_findings",
    "GeneAudit", "audit_findings", "audit_gene_space",
    "KernelModel", "OperandSpec", "check_model", "lint_kernels",
    "DEVICE_MEMORY_BYTES", "lint_plan",
]
