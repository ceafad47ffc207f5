"""CLI front-end for the static-analysis passes; the port of
``repro.analysis.lint``.

Usage:
  python -m repro_torch.analysis.lint                   # full sweep
  python -m repro_torch.analysis.lint --arch granite-3-2b --plan serve-low-mem
  python -m repro_torch.analysis.lint --strict --json findings.json

Runs the plan feasibility lint over configs x named plans (each named plan
against its documented context from ``repro_torch.dist.plan.PLAN_CONTEXTS``
unless ``--shape`` / ``--mesh`` override it) at the card's memory
(``DEVICE_MEMORY_BYTES``, the H100's 80 GiB), the CUDA kernel lint, and —
unless ``--no-gene-audit`` — the gene-contract audit (the only pass that
traces: a tiny train step on the CPU's fake tensors; everything else is
pure arithmetic).

Exit status: 1 when any error-severity finding exists; with ``--strict``,
warnings fail too.  ``--json`` writes the full findings report.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.analysis.findings import (Finding, findings_to_json,
                                           sort_findings)
from repro_torch.analysis.plan_lint import DEVICE_MEMORY_BYTES, lint_plan

# axis layout of repro_torch.launch.mesh.make_production_mesh, as plain
# dicts: linting a 512-rank mesh starts no process group
PRODUCTION_MESHES: Dict[str, Dict[str, int]] = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}


def lint_cells(archs: Optional[Sequence[str]] = None,
               plans: Optional[Sequence[str]] = None,
               shapes: Optional[Sequence[str]] = None,
               mesh: Optional[str] = None,
               pipelined: bool = False,
               device_memory_bytes: int = DEVICE_MEMORY_BYTES) -> List[dict]:
    """Plan-lint a sweep of cells; one record per (arch, plan, shape, mesh).

    Each named plan defaults to its documented context; ``shapes`` / ``mesh``
    override it for ad-hoc what-if runs (``--mesh both`` fans out).
    ``device_memory_bytes`` is the card's memory the footprint checks take.
    """
    from repro_torch.configs import (ARCHS, cell_runnable, get_config,
                                     get_shape)
    from repro_torch.dist.plan import NAMED_PLANS, PLAN_CONTEXTS, Plan

    arch_names = list(archs) if archs else sorted(ARCHS)
    plan_names = list(plans) if plans else sorted(NAMED_PLANS)
    records: List[dict] = []
    for plan_name in plan_names:
        if plan_name in NAMED_PLANS:
            plan = NAMED_PLANS[plan_name]
            ctx = PLAN_CONTEXTS.get(plan_name, {})
        elif plan_name == "default":
            plan, ctx = Plan(), {}
        else:
            raise SystemExit(f"unknown plan {plan_name!r}; have "
                             f"{sorted(NAMED_PLANS) + ['default']}")
        cell_shapes = list(shapes) if shapes \
            else list(ctx.get("shapes", ("train_4k",)))
        mesh_kind = mesh or ctx.get("mesh", "single")
        mesh_kinds = list(PRODUCTION_MESHES) if mesh_kind == "both" \
            else [mesh_kind]
        for arch in arch_names:
            cfg = get_config(arch)
            for shape_name in cell_shapes:
                shape = get_shape(shape_name)
                if not cell_runnable(cfg, shape):
                    continue
                for mk in mesh_kinds:
                    mesh_sizes = None if mk == "none" \
                        else PRODUCTION_MESHES[mk]
                    findings = lint_plan(
                        plan, mesh=mesh_sizes, cfg=cfg, shape=shape,
                        pipelined=pipelined,
                        device_memory_bytes=device_memory_bytes)
                    records.append({
                        "arch": arch, "plan": plan_name,
                        "shape": shape_name, "mesh": mk,
                        "findings": findings_to_json(findings)})
    return records


def _severity_counts(records: List[dict],
                     extra: Sequence[Finding]) -> Dict[str, int]:
    counts = {"error": 0, "warning": 0, "info": 0}
    for rec in records:
        for f in rec["findings"]:
            counts[f["severity"]] = counts.get(f["severity"], 0) + 1
    for f in extra:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return counts


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="static plan / CUDA kernel lint + gene-contract audit")
    ap.add_argument("--arch", action="append",
                    help="arch(s) to lint (default: all)")
    ap.add_argument("--plan", action="append",
                    help="named plan(s) or 'default' (default: all named)")
    ap.add_argument("--shape", action="append",
                    help="shape cell(s); default: the plan's documented "
                         "shapes")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "multi", "both", "none"],
                    help="mesh kind; default: the plan's documented mesh")
    ap.add_argument("--pipelined", action="store_true",
                    help="treat the pipeline-schedule genes as explicitly "
                         "requested (hostability failures become errors)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the run")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the findings report as JSON")
    ap.add_argument("--no-gene-audit", action="store_true",
                    help="skip the gene-contract audit (the only pass that "
                         "traces)")
    ap.add_argument("--no-kernel-lint", action="store_true")
    args = ap.parse_args(argv)

    records = lint_cells(args.arch, args.plan, args.shape, args.mesh,
                         pipelined=args.pipelined)
    extra: List[Finding] = []

    if not args.no_kernel_lint:
        from repro_torch.analysis.kernel_lint import lint_kernels
        extra.extend(lint_kernels())

    audit_rows: List[dict] = []
    if not args.no_gene_audit:
        from repro_torch.analysis.gene_audit import (audit_findings,
                                                     audit_gene_space)
        audits = audit_gene_space()
        extra.extend(audit_findings(audits))
        audit_rows = [{"field": a.field,
                       "declared_model_only": a.declared_model_only,
                       "artifact_invariant": a.artifact_invariant,
                       "violation": a.violation}
                      for a in audits]

    counts = _severity_counts(records, extra)
    report = {
        "cells": len(records),
        "severity_counts": counts,
        "plan_lint": [r for r in records if r["findings"]],
        "kernel_and_gene_findings": findings_to_json(extra),
        "gene_audit": audit_rows,
        "strict": bool(args.strict),
    }
    if args.json:
        from pathlib import Path
        Path(args.json).write_text(json.dumps(report, indent=1))

    # every non-info finding, then the tallies
    for rec in records:
        for f in rec["findings"]:
            if f["severity"] == "info":
                continue
            print(f"[{f['severity']}] {rec['arch']} x {rec['plan']} x "
                  f"{rec['shape']} x {rec['mesh']}: {f['rule_id']} "
                  f"{f['message']}")
    for f in sort_findings(extra):
        if f.severity == "info":
            continue
        print(f"[{f.severity}] {f.subject}: {f.rule_id} {f.message}")
    print(f"[lint] {len(records)} plan cells, "
          f"{len(extra)} kernel/gene findings: "
          f"{counts['error']} error, {counts['warning']} warning, "
          f"{counts['info']} info"
          + (f" -> {args.json}" if args.json else ""))

    if counts["error"]:
        return 1
    if args.strict and counts["warning"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
