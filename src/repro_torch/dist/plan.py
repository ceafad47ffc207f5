"""Execution plans: the framework-side offload pattern the GA searches.

A :class:`Plan` bundles every knob that changes how one step function is
*executed* without changing what it computes — remat policy, microbatching,
gradient compression, attention blocking, MoE dispatch flavor, decode-cache
layout.  It is the framework analogue of the paper's per-loop gene string:
``GENE_SPACE`` lists the categorical genes, and ``from_genes`` /
``to_genes`` convert between a plan and the GA's integer encoding (see
``repro.core.ga`` and ``examples/autoplan_model.py``).

A copy of the JAX package's ``repro.dist.plan`` (pure dataclasses).  The
port's LM reads ``kv_cache_quant`` from it; the search, cache, lint and
dryrun modules named below are the JAX package's until their slices are
ported.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple


class Gene(NamedTuple):
    """One ``GENE_SPACE`` entry.

    ``structural=False`` marks a *model-only* gene: flipping it never changes
    the lowered/compiled artifact, only the analytic cost model on top of it
    (the pipeline-schedule genes are scored via ``bubble_fraction``
    arithmetic — the verification machine never executes the pod pipeline).
    Everything structural participates in :meth:`Plan.structural_key`, the
    cache key ``repro.core.search_cache`` dedupes compiles by.
    """
    field: str
    choices: tuple
    structural: bool = True


@dataclass
class Plan:
    name: str = "default"
    # --- training-step execution -----------------------------------------
    remat: str = "block"                 # none | block | full
    microbatches: int = 1
    grad_compression: bool = False       # int8 + error feedback on "pod" psum
    vocab_chunk: int = 0                 # 0 = full-vocab xent
    opt_state_dtype: str = "float32"
    # --- pipeline (repro.dist.schedules over the "pod" axis) --------------
    pipeline_schedule: str = "gpipe"     # gpipe | one_f_one_b | interleaved
    virtual_stages: int = 1              # chunks per rank (interleaved only)
    # --- attention --------------------------------------------------------
    gqa_grouped: bool = True
    blockwise_attn_threshold: int = 1024  # seq >= threshold -> blockwise
    attn_block_q: int = 512
    attn_block_kv: int = 512
    # --- MoE --------------------------------------------------------------
    moe_impl: str = "gspmd"              # gspmd | shardmap_ep
    moe_capacity_factor: Optional[float] = None
    moe_groups: int = 1
    # --- SSM --------------------------------------------------------------
    ssd_chunk: int = 0
    ssd_bf16: bool = False
    # --- serving ----------------------------------------------------------
    kv_cache_quant: bool = False
    decode_kv_seq_shard: bool = False    # shard kv_seq (not kv_heads) on model

    # ------------------------------------------------------------- genes
    @classmethod
    def gene_cardinalities(cls) -> List[int]:
        return [len(g.choices) for g in _GENE_SPACE]

    @classmethod
    def from_genes(cls, genes: Sequence[int], name: str = "ga-candidate"
                   ) -> "Plan":
        kw = {}
        for gene, g in zip(_GENE_SPACE, genes):
            kw[gene.field] = gene.choices[int(g) % len(gene.choices)]
        return cls(name=name, **kw)

    def to_genes(self) -> List[int]:
        genes = []
        for gene in _GENE_SPACE:
            v = getattr(self, gene.field)
            genes.append(gene.choices.index(v) if v in gene.choices else 0)
        return genes

    def structural_key(self) -> Tuple[Tuple[str, Any], ...]:
        """Hashable identity of the *compiled artifact* this plan lowers to.

        Two plans with equal structural keys trace/lower/compile to the
        same executable: every dataclass field participates except ``name``
        (a label) and the model-only genes (``MODEL_ONLY_FIELDS`` — the
        pipeline-schedule genes, which only move the modeled bubble term).
        ``repro.core.search_cache`` keys its compile/analysis layers on this.
        """
        return tuple((f.name, getattr(self, f.name))
                     for f in dataclasses.fields(self)
                     if f.name != "name" and f.name not in MODEL_ONLY_FIELDS)


# Categorical gene space for the framework-side GA: Gene(field, choices,
# structural) triples.  Order is part of the public API: gene i of an
# individual indexes _GENE_SPACE[i].choices.  Exposed as the plain class
# attribute Plan.GENE_SPACE (not a dataclass field, so dataclasses.asdict
# stays JSON-clean).
#
# Structural/model-only contract: a gene is structural when flipping it
# changes the traced/lowered/compiled step; the pipeline-schedule genes are
# model-only — the compiled artifact stays the dp/tp step and the schedule
# is charged as a bubble_fraction on top (repro.core.cost_model), so the
# 3x2 schedule combinations per structural plan share one compile.
_GENE_SPACE: Tuple[Gene, ...] = (
    Gene("remat", ("none", "block", "full")),
    Gene("microbatches", (1, 2, 4, 8)),
    Gene("grad_compression", (False, True)),
    Gene("vocab_chunk", (0, 512, 2048)),
    Gene("gqa_grouped", (True, False)),
    Gene("blockwise_attn_threshold", (512, 1024, 1 << 30)),
    Gene("attn_block_q", (256, 512)),
    Gene("attn_block_kv", (256, 512)),
    Gene("moe_impl", ("gspmd", "shardmap_ep")),
    Gene("decode_kv_seq_shard", (False, True)),
    Gene("pipeline_schedule", ("gpipe", "one_f_one_b", "interleaved"),
         structural=False),
    Gene("virtual_stages", (1, 2), structural=False),
)

# plan fields that never reach the compiled artifact (scored analytically)
MODEL_ONLY_FIELDS = frozenset(g.field for g in _GENE_SPACE
                              if not g.structural)

# make the class attribute readable without an instance too
Plan.GENE_SPACE = _GENE_SPACE


# --------------------------------------------------------------------------
# Named plans (referenced by --plan <name> in repro.launch.dryrun).
# --------------------------------------------------------------------------

TRAIN_TIGHT_MEM = Plan(name="train-tight-mem", remat="full", microbatches=4,
                       vocab_chunk=512)
CROSS_POD_COMPRESSED = Plan(name="cross-pod-compressed",
                            grad_compression=True)
SERVE_LOW_MEM = Plan(name="serve-low-mem", remat="none", kv_cache_quant=True,
                     decode_kv_seq_shard=True)

NAMED_PLANS = {p.name: p for p in (TRAIN_TIGHT_MEM, CROSS_POD_COMPRESSED,
                                   SERVE_LOW_MEM)}

# Documented deployment context per named plan: the mesh kind and shape
# cells the plan is designed for.  ``repro.analysis.lint`` audits each named
# plan against exactly this context (a plan the linter proves infeasible on
# its documented mesh is a bug in the plan, not a waivable finding):
#   * train-tight-mem     — a training plan; grad accumulation + full remat
#     target the multi-pod training footprint.
#   * cross-pod-compressed — compresses the cross-pod grad psum, so it only
#     means anything on the multi-pod mesh.
#   * serve-low-mem       — a decode plan for the single-pod serving mesh
#     (long_500k applies only to sub-quadratic archs, see cell_runnable).
PLAN_CONTEXTS = {
    "train-tight-mem": {"mesh": "multi", "shapes": ("train_4k",)},
    "cross-pod-compressed": {"mesh": "multi", "shapes": ("train_4k",)},
    "serve-low-mem": {"mesh": "single",
                      "shapes": ("decode_32k", "long_500k")},
}
