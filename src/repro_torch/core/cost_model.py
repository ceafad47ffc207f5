"""Three-term roofline model of a traced candidate on one NVIDIA H100, the
port of ``repro.core.cost_model``.

The analysis of a traced artifact (:mod:`repro_torch.core.trace_analysis`)
gives per-device FLOPs (split by the dtype they run in), HBM bytes and
collective bytes; the terms divide them by the card's peak rates.  Each
dtype is priced at its own peak: the compute term is
``sum_d flops_d / peak_d``.  fp32 stays off TF32 in the port
(``repro_torch.device``), so an fp32 product runs on the CUDA cores at the
fp32 peak; pricing it at the bf16 tensor-core peak would understate it 15x.
An analysis without the per-dtype split is priced at the fp32 peak.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Mapping, Optional

# NVIDIA H100 SXM5 datasheet peaks (one card; published numbers, not
# measurements): fp32 on the CUDA cores, dense bf16/fp16 on the tensor
# cores, fp64 on the CUDA cores, HBM3, and NVLink per direction.
PEAK_FLOPS_BY_DTYPE: Dict[str, float] = {
    "fp32": 67e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "fp64": 34e12,
}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["fp32"]     # the price of unsplit FLOPs
HBM_BW = 3.35e12                             # bytes/s
LINK_BW = 450e9                              # NVLink, bytes/s a direction

# analysis keys of the per-dtype split: "flops_fp32", "flops_bf16", ...
FLOPS_KEY_PREFIX = "flops_"


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0          # 6*N*D (active params for MoE)
    useful_flops_ratio: float = 0.0   # model_flops / (traced FLOPs * chips)
    step_time_s: float = 0.0          # max of the three terms / (1 - bubble)
    roofline_fraction: float = 0.0    # useful compute time / step time
    bubble_fraction: float = 0.0      # pipeline-schedule idle fraction
    pipeline_s: float = 0.0           # extra step time the bubble costs
    # utilization terms (each roofline term / step time, so bubbles shrink
    # them) — the inputs repro_torch.power.EnergyModel turns into watts
    compute_util: float = 0.0
    memory_util: float = 0.0
    collective_util: float = 0.0
    # the FLOPs priced at each dtype's peak ({} when there was no split), so
    # an analysis recovered from the roofline prices the same
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)

    def to_dict(self):
        return asdict(self)


def compute_seconds(flops: float,
                    flops_by_dtype: Optional[Mapping[str, float]] = None
                    ) -> float:
    """sum_d flops_d / peak_d; FLOPs outside the split (all of them when
    there is none) at the fp32 peak."""
    split = dict(flops_by_dtype or {})
    unknown = sorted(set(split) - set(PEAK_FLOPS_BY_DTYPE))
    if unknown:
        raise ValueError(f"no H100 peak for dtype(s) {unknown}")
    rest = max(flops - sum(split.values()), 0.0)
    return rest / PEAK_FLOPS + sum(f / PEAK_FLOPS_BY_DTYPE[d]
                                   for d, f in split.items())


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, *, n_chips: int,
                   model_flops: float = 0.0,
                   bubble_fraction: float = 0.0,
                   flops_by_dtype: Optional[Mapping[str, float]] = None
                   ) -> Roofline:
    compute_s = compute_seconds(flops, flops_by_dtype)
    memory_s = bytes_accessed / HBM_BW
    collective_s = collective_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    busy = max(compute_s, memory_s, collective_s)
    # a pipeline schedule idles each rank for bubble_fraction of the step:
    # the busy roofline time is only (1 - bubble) of the wall clock
    bubble = min(max(bubble_fraction, 0.0), 0.999)
    step = busy / (1.0 - bubble)
    useful = model_flops / (flops * n_chips) if flops else 0.0
    # the useful share of the compute term, so model FLOPs are priced at
    # the same dtype mix as the traced ones
    useful_time = (useful * compute_s if flops
                   else (model_flops / n_chips) / PEAK_FLOPS)
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        collective_bytes_per_device=collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_flops_ratio=useful,
        step_time_s=step,
        roofline_fraction=(useful_time / step) if step else 0.0,
        bubble_fraction=bubble,
        pipeline_s=step - busy,
        compute_util=(compute_s / step) if step else 0.0,
        memory_util=(memory_s / step) if step else 0.0,
        collective_util=(collective_s / step) if step else 0.0,
        flops_by_dtype=dict(flops_by_dtype or {}),
    )


def flops_by_dtype(analyzed: Mapping[str, float]) -> Dict[str, float]:
    """The per-dtype FLOP split of an analysis dict ({} when it has none)."""
    return {k[len(FLOPS_KEY_PREFIX):]: float(v) for k, v in analyzed.items()
            if k.startswith(FLOPS_KEY_PREFIX)}


def roofline_from_analysis(analyzed: Mapping[str, float], *, n_chips: int,
                           model_flops: float = 0.0,
                           bubble_fraction: float = 0.0) -> Roofline:
    """Roofline from an analysis dict
    (:func:`repro_torch.core.trace_analysis.analyze_ops`).

    The analysis dict is the cacheable face of a traced artifact
    (repro_torch.core.search_cache stores exactly this), so re-scoring under
    a different bubble fraction / policy is pure arithmetic — no retrace.
    """
    return roofline_terms(analyzed["flops"], analyzed["bytes"],
                          analyzed["collective_bytes"], n_chips=n_chips,
                          model_flops=model_flops,
                          bubble_fraction=bubble_fraction,
                          flops_by_dtype=flops_by_dtype(analyzed))


# --------------------------------------------------------------------------
# Pipeline-schedule terms (closed forms, as the reference's; its schedule
# registry comes with the distribution slice, so a name outside the closed
# forms models as bubble 0 — the sequential fallback).
# --------------------------------------------------------------------------

KNOWN_SCHEDULES = ("gpipe", "one_f_one_b", "interleaved")


def _schedule_virtual(schedule: str, virtual_stages: int) -> int:
    """gpipe / one_f_one_b run one chunk per rank whatever the plan says."""
    return virtual_stages if schedule == "interleaved" else 1


def pipeline_bubble_fraction(schedule: str, n_ranks: int, microbatches: int,
                             virtual_stages: int = 1) -> float:
    """Idle-tick fraction of the schedule's static plan.

    With stride = max(m, R) and V recirculation passes the plan runs
    (V-1)*stride + m + R - 1 ticks of which V*m do work per rank —
    gpipe/1F1B (V=1): bubble (R-1)/(m+R-1); interleaved with m >= R:
    (R-1)/(V*m + R - 1).  A name nothing knows models as bubble 0 (the
    sequential fallback), never as gpipe.
    """
    if n_ranks <= 1:
        return 0.0
    m = max(microbatches, 1)
    if schedule not in KNOWN_SCHEDULES:
        return 0.0
    v = max(_schedule_virtual(schedule, virtual_stages), 1)
    total = (v - 1) * max(m, n_ranks) + m + n_ranks - 1
    return (total - v * m) / total


def pipeline_in_flight(schedule: str, n_ranks: int, microbatches: int,
                       virtual_stages: int = 1) -> int:
    """Per-rank live microbatch activations the schedule's backward keeps.

    gpipe holds all m; 1F1B caps at min(R, m); interleaved adds V-1 chunk
    activations awaiting recirculation on top of the 1F1B cap.
    """
    m = max(microbatches, 1)
    if n_ranks <= 1:
        return m
    if schedule == "one_f_one_b":
        return min(n_ranks, m)
    if schedule == "interleaved":
        v = max(virtual_stages, 1)
        return min(m * v, min(n_ranks, m) + v - 1)
    return m


def plan_bubble_fraction(plan, n_ranks: int) -> float:
    """Bubble fraction a Plan's pipeline genes imply on an n_ranks pipeline
    axis (0.0 when there is no such axis)."""
    return pipeline_bubble_fraction(
        getattr(plan, "pipeline_schedule", "gpipe"), n_ranks,
        max(getattr(plan, "microbatches", 1), 1),
        getattr(plan, "virtual_stages", 1))


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.

    decode shapes process global_batch tokens per step; train/prefill process
    global_batch*seq_len.  Training includes the backward pass (the 6 factor
    already assumes fwd+bwd: 2 fwd + 4 bwd per param per token); for pure
    inference (prefill/decode) the right factor is 2.
    """
    n = cfg.active_params() if cfg.moe is not None else cfg.n_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch
    return 2.0 * n * tokens
