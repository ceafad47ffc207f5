"""Gene-contract audit: prove the ``structural=False`` flags in
``Plan.GENE_SPACE`` against the traced artifact; the port of
``repro.analysis.gene_audit``.

``repro_torch.core.search_cache`` dedupes the GA's traces by
``Plan.structural_key()``, which *excludes* every gene flagged
``structural=False`` (model-only): the contract is that flipping such a
gene never changes the traced step, only the analytic cost model on top of
it.  A wrong model-only flag poisons the cache (two different artifacts
would share one entry, and a search would score one with the other's
roofline); this pass proves the flags instead of trusting them.

Method: trace a base plan and, for each audited gene, every flipped value;
compare the artifact texts (``TracedArtifact.as_text()``: every op with
its operand and result shapes, so a gene that only moves a dimension
shows).  A nonzero diff on a model-only gene is a ``G001`` error.  The
default trace is a tiny dense train step on the CPU's fake tensors (no
mesh), the port's ``LM`` and ``make_train_step`` under
``trace_analysis.trace``, sensitive to the structural genes that reach a
train step (remat, microbatches, vocab_chunk).

Some genes are structural for the reference because they set its Pallas
blocking (``attn_block_q``, ``attn_block_kv``,
``blockwise_attn_threshold``) or its attention layout (``gqa_grouped``);
the port's hand-written CUDA kernels take their own tiles and layout, so
such a gene may leave the port's artifact unchanged.  That is no
violation: the flag errs on the safe side, and its ``G004`` finding says
why.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import ERROR, INFO, Finding

# genes that reach only the reference's Pallas blocking or JAX layout: the
# port's CUDA kernels ignore them (models.layers.attention)
KERNEL_TILE_GENES = frozenset({"attn_block_q", "attn_block_kv",
                               "blockwise_attn_threshold", "gqa_grouped"})


@dataclass(frozen=True)
class GeneAudit:
    """Verdict for one audited gene."""
    field: str
    declared_model_only: bool
    artifact_invariant: bool
    base_value: object
    checked_values: Tuple
    detail: str = ""            # first divergence, "" when invariant

    @property
    def violation(self) -> bool:
        """True when the cache identity is unsound for this gene."""
        return self.declared_model_only and not self.artifact_invariant


def default_trace_fn() -> Callable[[object], str]:
    """(plan) -> artifact text of a tiny dense train step on the CPU's fake
    tensors, no mesh: the reference's ``audit-tiny`` config through the
    port's ``LM`` and ``make_train_step``, so every gene that reaches a
    train step (remat, microbatches, vocab_chunk, opt_state_dtype, ...)
    shows in the text exactly when it shows in a real step."""
    from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
    from repro_torch.core.trace_analysis import trace
    from repro_torch.launch import specs
    from repro_torch.models.lm import LM
    from repro_torch.train import train_step as ts

    cfg = ModelConfig(name="audit-tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=256, d_head=16, vocab_pad_multiple=16,
                      dtype="float32", param_dtype="float32")
    shape = ShapeConfig("audit-train", seq_len=32, global_batch=8,
                        kind="train")

    def trace_text(plan) -> str:
        tcfg = TrainConfig(microbatches=plan.microbatches,
                           master_dtype=plan.opt_state_dtype)
        params = specs.param_specs(cfg, "cpu")
        inputs = (params, specs.opt_specs(params, tcfg),
                  specs.batch_specs(cfg, shape, "cpu"),
                  specs.step_spec("cpu"))

        def step(inputs):
            params, opt_state, batch, n = inputs
            model = LM(cfg, params, plan)
            return ts.make_train_step(model, tcfg)(model.params(), opt_state,
                                                   batch, n)

        return trace(step, inputs).as_text()

    return trace_text


def _diff_summary(base: str, flipped: str) -> str:
    """First differing line of two artifact texts (compact evidence)."""
    for i, (a, b) in enumerate(zip(base.splitlines(),
                                   flipped.splitlines())):
        if a != b:
            return (f"first diff at artifact line {i}: "
                    f"{a.strip()[:80]!r} != {b.strip()[:80]!r}")
    return (f"artifact length differs: {len(base.splitlines())} vs "
            f"{len(flipped.splitlines())} lines")


def audit_gene_space(trace_fn: Optional[Callable[[object], str]] = None,
                     gene_space: Optional[Sequence] = None,
                     base_plan=None,
                     fields: Optional[Sequence[str]] = None
                     ) -> List[GeneAudit]:
    """Audit genes against the traced artifact.

    By default only the ``structural=False`` (model-only) genes are audited:
    those are the ones whose flag, if wrong, silently poisons
    ``Plan.structural_key()``.  Pass ``fields`` to audit specific genes, or
    a modified ``gene_space`` to audit a hypothetical contract before
    adopting it.
    """
    from repro_torch.dist.plan import Plan

    if gene_space is None:
        gene_space = Plan.GENE_SPACE
    if trace_fn is None:
        trace_fn = default_trace_fn()
    if base_plan is None:
        base_plan = Plan(name="gene-audit-base")

    todo = [g for g in gene_space
            if (g.field in fields if fields is not None else not g.structural)]
    base_text = trace_fn(base_plan) if todo else ""

    audits: List[GeneAudit] = []
    for gene in todo:
        base_value = getattr(base_plan, gene.field)
        flips = tuple(c for c in gene.choices if c != base_value)
        detail = ""
        invariant = True
        for choice in flips:
            flipped = dataclasses.replace(base_plan, **{gene.field: choice})
            text = trace_fn(flipped)
            if text != base_text:
                invariant = False
                detail = (f"{gene.field}={choice!r} changes the artifact "
                          f"vs {base_value!r}: "
                          + _diff_summary(base_text, text))
                break
        audits.append(GeneAudit(
            field=gene.field, declared_model_only=not gene.structural,
            artifact_invariant=invariant, base_value=base_value,
            checked_values=flips, detail=detail))
    return audits


def audit_findings(audits: Sequence[GeneAudit]) -> List[Finding]:
    """Finding records for an audit run (G001 = contract violation)."""
    out: List[Finding] = []
    for a in audits:
        if a.violation:
            out.append(Finding(
                "G001", ERROR,
                f"gene {a.field!r} is flagged structural=False but flipping "
                f"it changes the traced artifact — Plan.structural_key() "
                f"would alias distinct traces ({a.detail})",
                plan_field=a.field, subject="gene-audit"))
        elif a.declared_model_only:
            out.append(Finding(
                "G002", INFO,
                f"gene {a.field!r}: artifact-invariant over "
                f"{list(a.checked_values)!r} — model-only flag verified",
                plan_field=a.field, subject="gene-audit"))
        elif not a.artifact_invariant:
            out.append(Finding(
                "G003", INFO,
                f"gene {a.field!r} is structural and indeed changes the "
                f"artifact ({a.detail})",
                plan_field=a.field, subject="gene-audit"))
        elif a.field in KERNEL_TILE_GENES:
            out.append(Finding(
                "G004", INFO,
                f"gene {a.field!r} is flagged structural and the port's "
                "artifact is invariant under it: it sets the reference's "
                "Pallas blocking or JAX layout, which the port's CUDA "
                "kernels do not take — a safe flag here, not a violation",
                plan_field=a.field, subject="gene-audit"))
        else:
            out.append(Finding(
                "G004", INFO,
                f"gene {a.field!r} is flagged structural but produced no "
                "artifact diff under this trace — either inert on the audit "
                "model or a candidate for structural=False",
                plan_field=a.field, subject="gene-audit"))
    return out
