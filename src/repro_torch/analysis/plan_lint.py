"""Static plan feasibility lint: pure arithmetic over Plan × mesh × arch;
the port of ``repro.analysis.plan_lint``, at the H100's memory.

The paper's pipeline opens with *static* structure analysis (Clang loop /
function-block parsing) before any measurement is spent; this is the
framework-side analogue: every check here replicates, in closed form, a
decision the runtime stack makes while tracing / lowering / modeling a
:class:`repro_torch.dist.plan.Plan` — so an infeasible or self-contradictory
candidate is rejected for the GA's penalty without paying for a trace
(``make_cached_batch_evaluator(lint=...)``; the router also lints every
endpoint with it before scoring).

What "error" means here is narrow: the artifact provably cannot be built
(the ``batch % microbatches`` assert in the reference's ``train_step``, an
unknown pipeline schedule on an explicitly pipelined cell, parameters that
overflow the mesh's aggregate HBM even perfectly sharded).  Everything the
runtime *survives by silently degrading* — ``Rules`` prefix-sharding
falling back to replication, ``chunked_softmax_xent`` disabling itself on a
non-dividing sequence, ``pipeline_apply``'s sequential fallback — is a
warning: the plan lowers, but not to what its genes claim.

Nothing here imports torch: ``mesh`` may be any object with a
``shape`` mapping (the reference's jax ``Mesh``, the port's
``dist.bridge.LocalMesh``) or a plain ``{axis: size}`` dict.

The one constant that differs from the reference is
:data:`DEVICE_MEMORY_BYTES`, the card's memory (the reference's is a TPU
chip's 16 GiB); ``lint_plan(device_memory_bytes=)`` overrides it per call.
The memory estimate (``serve_kv_bytes`` + parameters) is the reference's
formula unchanged.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.findings import ERROR, INFO, WARNING, Finding

GiB = 1024 ** 3
# per-card memory of the NVIDIA H100 80GB HBM3 (SXM5): its nominal 80 GB
# of HBM3 is five 16 GiB stacks, 80 GiB = 85,899,345,920 bytes.  The CUDA
# runtime reserves part of it: torch reports a smaller ``total_memory``
# (chip_smoke.py's fleet phase prints both beside what each engine held).
DEVICE_MEMORY_BYTES = 80 * GiB

_DTYPE_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1}

# mirror of the reference's dist.sharding.BASE_RULES for the dims the lint
# reasons about (kv_seq joins under Plan.decode_kv_seq_shard, as in
# Rules.__init__)
_BATCH_AXES = ("pod", "data")
_MODEL_DIMS = ("heads", "kv_heads", "ff", "vocab")


def _axis_sizes(mesh) -> Dict[str, int]:
    """Axis-name -> size for a mesh with a ``shape`` mapping, a
    {axis: size} dict, or None."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return {str(a): int(s) for a, s in mesh.items()}
    shape = getattr(mesh, "shape", None)
    if shape is not None and hasattr(shape, "items"):
        return {str(a): int(s) for a, s in shape.items()}
    raise TypeError(f"mesh must be a Mesh, dict or None: {type(mesh)!r}")


def _prefix_take(dim: int, axes, sizes: Dict[str, int]) -> int:
    """How many leading axes Rules._assign would shard ``dim`` over."""
    size, take = 1, 0
    for a in axes:
        if a not in sizes or dim % (size * sizes[a]) != 0:
            break
        size *= sizes[a]
        take += 1
    return take


def _dtype_bytes(name: str) -> int:
    return _DTYPE_BYTES.get(str(name), 4)


def _serve_attr(serve, name, default=None):
    """Serve-context field: ``serve`` may be a dict or any object carrying
    n_slots / cache_len / prompt_len / max_gen (e.g. an Endpoint)."""
    if isinstance(serve, dict):
        v = serve.get(name, default)
    else:
        v = getattr(serve, name, default)
    return default if v is None else int(v)


def serve_kv_bytes(cfg, cache_len: int, *, quant: bool = False) -> int:
    """Closed-form per-slot decode-cache footprint estimate.

    Mirrors ``models.lm.init_cache`` shapes: attention layers hold K+V of
    ``[cache_len, n_kv_heads, head_dim]`` each (window rings cap the length
    at ``cfg.window``); recurrent families hold O(1) state per layer.
    ``quant`` is the ``Plan.kv_cache_quant`` gene (int8 + fp32 scale).
    """
    hd = cfg.head_dim
    per_tok = 2 * cfg.n_kv_heads * hd          # K + V elements per token
    el = 1 if quant else _dtype_bytes(getattr(cfg, "dtype", "bfloat16"))
    if cfg.family == "ssm":
        s = cfg.ssm
        return cfg.n_layers * s.d_inner(cfg.d_model) * s.d_state * 4
    eff = min(cache_len, cfg.window) if getattr(cfg, "window", 0) \
        else cache_len
    if cfg.family == "hybrid":
        h = cfg.hybrid
        n_att = cfg.n_attention_layers
        w = h.lru_width or cfg.d_model
        rec_state = (cfg.n_layers - n_att) * w * 4
        return n_att * eff * per_tok * el + rec_state
    n_att = cfg.n_layers
    if getattr(cfg, "cross_attn_every", 0):
        # cross-attn caches are context-length-sized, counted separately by
        # the caller if it matters; the self-attn share dominates
        n_att = cfg.n_layers - cfg.n_layers // (cfg.cross_attn_every + 1)
    return n_att * eff * per_tok * el


def lint_plan(plan, *, mesh=None, cfg=None, shape=None,
              pipelined: bool = False,
              device_memory_bytes: int = DEVICE_MEMORY_BYTES,
              serve=None
              ) -> List[Finding]:
    """Pure-arithmetic feasibility findings for one plan.

    ``mesh`` / ``cfg`` / ``shape`` are each optional — a check that needs a
    missing ingredient is skipped, so the linter is usable from the gene-level
    GA (mesh only) up to the full dry-run cell (all three).  ``pipelined``
    mirrors the reference's dry-run: the pipeline-schedule genes are
    *requested* (not merely carried as model-only genes), so hostability
    failures become errors instead of modeling notes.

    ``serve`` enables the serving context (decode shapes): a dict or object
    with ``n_slots`` / ``cache_len`` / ``prompt_len`` / ``max_gen``.  The
    router (repro_torch.serve.router) lints every candidate endpoint with it
    before scoring, so a destination whose slot pool provably cannot host
    the request is pruned statically — the same prune-before-trace
    contract the GA's batch evaluator applies (P018/P019 errors, P104
    would-fit-with-quant hint).
    """
    out: List[Finding] = []
    subject = getattr(plan, "name", "") or ""

    def add(rule_id, severity, message, plan_field=None, **context):
        out.append(Finding(rule_id, severity, message, plan_field=plan_field,
                           subject=subject, context=context))

    sizes = _axis_sizes(mesh)
    n_devices = 1
    for s in sizes.values():
        n_devices *= max(s, 1)
    kind = getattr(shape, "kind", None)
    seq = getattr(shape, "seq_len", None)
    batch = getattr(shape, "global_batch", None)

    # --- P001: nonpositive gene values (nothing downstream tolerates them)
    for f, lo in (("microbatches", 1), ("virtual_stages", 1),
                  ("attn_block_q", 1), ("attn_block_kv", 1),
                  ("blockwise_attn_threshold", 1), ("moe_groups", 1),
                  ("vocab_chunk", 0), ("ssd_chunk", 0)):
        v = getattr(plan, f, lo)
        if not isinstance(v, (int, float)) or v < lo:
            add("P001", ERROR, f"{f}={v!r} must be >= {lo}", plan_field=f)
    cap = getattr(plan, "moe_capacity_factor", None)
    if cap is not None and (not isinstance(cap, (int, float)) or cap <= 0):
        add("P001", ERROR, f"moe_capacity_factor={cap!r} must be > 0",
            plan_field="moe_capacity_factor")
    if out:                      # nonsense values poison every later check
        return out

    micro = getattr(plan, "microbatches", 1)
    schedule = getattr(plan, "pipeline_schedule", "gpipe")
    virtual = getattr(plan, "virtual_stages", 1)
    pod = sizes.get("pod", 1)

    # --- P002: microbatch split divisibility — the one hard trace-time
    # assert in plan space (_split_microbatches: batch % microbatches)
    if batch is not None and micro > 1:
        if kind == "train" and batch % micro != 0:
            add("P002", ERROR,
                f"global_batch {batch} % microbatches {micro} != 0: "
                "gradient-accumulation split asserts at trace time",
                plan_field="microbatches", batch=batch, microbatches=micro)
        elif kind not in (None, "train"):
            add("P103", INFO,
                f"microbatches={micro} is inert on a {kind} shape "
                "(no gradient accumulation)", plan_field="microbatches")

    # --- P003/P004/P005: pipeline-schedule hostability ------------------
    from repro_torch.dist.schedules import get_schedule
    sched = get_schedule(schedule)
    if sched is None:
        add("P003", ERROR if pipelined else WARNING,
            f"unknown pipeline schedule {schedule!r}: "
            + ("the requested pipeline cannot be built" if pipelined else
               "the cost model charges bubble 0 (sequential fallback)"),
            plan_field="pipeline_schedule")
    if pipelined and pod <= 1:
        add("P005", WARNING,
            "pipeline requested but the mesh has no pod axis (>1): "
            "pipeline_apply falls back to the sequential reference",
            plan_field="pipeline_schedule", pod=pod)
    if sched is not None and pod > 1:
        v = max(virtual, 1) if schedule == "interleaved" else 1
        built = sched.build(n_stages=pod * v, n_ranks=pod,
                            microbatches=micro, virtual_stages=v)
        if built is None and pipelined:
            add("P004", ERROR,
                f"schedule {schedule!r} cannot host stages={pod * v} "
                f"ranks={pod} microbatches={micro} virtual={v} "
                "(Schedule.build returned None)",
                plan_field="pipeline_schedule")
        elif built is not None and pipelined and micro < pod:
            add("P007", INFO,
                f"microbatches {micro} < pipeline ranks {pod}: bubble "
                f"fraction {built.bubble_fraction:.2f} of every step",
                plan_field="microbatches",
                bubble_fraction=round(built.bubble_fraction, 4))
    if virtual > 1 and schedule != "interleaved":
        add("P006", WARNING,
            f"virtual_stages={virtual} is ignored by schedule "
            f"{schedule!r} (an interleaved-only gene)",
            plan_field="virtual_stages")

    # --- P008: parameter memory vs aggregate device capacity ------------
    if cfg is not None:
        n_params = cfg.n_params()
        p_bytes = n_params * _dtype_bytes(getattr(cfg, "param_dtype",
                                                  "bfloat16"))
        total = p_bytes
        if kind == "train":
            # fp32 grad accumulators + two Adam moments in the plan's
            # opt-state dtype: the floor any training step must hold
            total += n_params * 4
            total += 2 * n_params * _dtype_bytes(
                getattr(plan, "opt_state_dtype", "float32"))
        capacity = n_devices * device_memory_bytes
        if total > capacity:
            add("P008", ERROR,
                f"state floor {total / GiB:.1f} GiB (params"
                + (" + grads + opt moments" if kind == "train" else "")
                + f") exceeds the mesh's aggregate {capacity / GiB:.0f} GiB"
                f" ({n_devices} x {device_memory_bytes / GiB:.0f} GiB): "
                "cannot fit even fully sharded",
                plan_field="opt_state_dtype" if kind == "train" else None,
                state_bytes=total, capacity_bytes=capacity)

    # --- P009: chunked-xent silent disable ------------------------------
    chunk = getattr(plan, "vocab_chunk", 0)
    if chunk and kind == "train" and seq is not None:
        eff = min(chunk, seq)
        if seq % eff != 0:
            add("P009", WARNING,
                f"vocab_chunk={chunk}: seq_len {seq} % {eff} != 0, "
                "chunked_softmax_xent silently falls back to the full "
                "(unchunked) loss", plan_field="vocab_chunk")
    elif chunk and kind in ("prefill", "decode"):
        add("P103", INFO, f"vocab_chunk={chunk} is inert on a {kind} shape "
            "(no training loss)", plan_field="vocab_chunk")

    # --- P010: batch prefix-sharding degradation ------------------------
    if batch is not None and batch > 1 and sizes:
        # batch == 1 carries no signal: a singleton batch cannot shard and
        # that is the shape cell's property, not a plan defect
        avail = tuple(a for a in _BATCH_AXES if sizes.get(a, 1) > 1)
        if avail:
            take = _prefix_take(batch, avail, sizes)
            if take == 0:
                add("P010", WARNING,
                    f"global_batch {batch} is divisible by no prefix of "
                    f"the batch axes {avail}: the batch replicates "
                    "(data parallelism is lost)", batch=batch)
            elif take < len(avail):
                add("P010", INFO,
                    f"global_batch {batch} shards over {avail[:take]} "
                    f"only; {avail[take:]} replicate", batch=batch)

    # --- P011: model-dim replication (an arch property, not plan-fixable)
    model_size = sizes.get("model", 1)
    if cfg is not None and model_size > 1:
        dims = {"heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                "ff": cfg.d_ff, "vocab": cfg.padded_vocab}
        for logical in _MODEL_DIMS:
            dim = dims[logical]
            if dim % model_size != 0:
                add("P011", INFO,
                    f"{logical}={dim} % model axis {model_size} != 0: "
                    "Rules replicates this dimension (tensor parallelism "
                    "degrades for the arch, independent of the plan)",
                    logical=logical, dim=dim)

    # --- P012/P013: serving genes ---------------------------------------
    if getattr(plan, "decode_kv_seq_shard", False):
        if kind == "decode" and seq is not None and model_size > 1 \
                and seq % model_size != 0:
            add("P012", WARNING,
                f"decode_kv_seq_shard: kv_seq {seq} % model axis "
                f"{model_size} != 0, the requested cache sharding "
                "silently replicates", plan_field="decode_kv_seq_shard")
        elif kind in ("train", "prefill"):
            add("P013", INFO,
                f"decode_kv_seq_shard is inert on a {kind} shape",
                plan_field="decode_kv_seq_shard")
    if getattr(plan, "kv_cache_quant", False) and kind == "train":
        add("P013", INFO, "kv_cache_quant is inert on a train shape "
            "(no decode cache)", plan_field="kv_cache_quant")

    # --- P014/P015/P016: genes contradicting the cell -------------------
    if kind in ("prefill", "decode") and getattr(plan, "remat",
                                                 "none") != "none":
        add("P014", INFO,
            f"remat={plan.remat!r} is inert on a {kind} shape "
            "(no backward pass to rematerialize for)", plan_field="remat")
    if cfg is not None and getattr(cfg, "moe", None) is None \
            and getattr(plan, "moe_impl", "gspmd") != "gspmd":
        add("P015", INFO,
            f"moe_impl={plan.moe_impl!r} is inert: {cfg.name} has no MoE "
            "layers", plan_field="moe_impl")
    if getattr(plan, "grad_compression", False):
        if kind in ("prefill", "decode"):
            add("P013", INFO,
                f"grad_compression is inert on a {kind} shape",
                plan_field="grad_compression")
        elif sizes and pod <= 1:
            add("P016", WARNING,
                "grad_compression compresses the cross-pod grad psum, but "
                "the mesh has no pod axis (>1): nothing is compressed",
                plan_field="grad_compression")

    # --- P018/P019/P104: serving context (decode slot pool) -------------
    if serve is not None:
        cache_len = _serve_attr(serve, "cache_len", 0)
        n_slots = _serve_attr(serve, "n_slots", 1)
        prompt_len = _serve_attr(serve, "prompt_len", 0)
        max_gen = _serve_attr(serve, "max_gen", 0)
        need = prompt_len + max_gen
        if cache_len and need > cache_len:
            if cfg is not None and cfg.is_sub_quadratic:
                add("P104", INFO,
                    f"request needs {need} positions > cache_len "
                    f"{cache_len}, but {cfg.name} decodes with "
                    "window/recurrent state (the ring wraps by design)",
                    need=need, cache_len=cache_len)
            else:
                add("P018", ERROR,
                    f"request needs prompt {prompt_len} + gen {max_gen} = "
                    f"{need} positions but the endpoint's cache_len is "
                    f"{cache_len}: the full-attention KV cache cannot host "
                    "it (tokens past cache_len overwrite live entries)",
                    need=need, cache_len=cache_len)
        if cfg is not None and cache_len and n_slots:
            quant = bool(getattr(plan, "kv_cache_quant", False))
            pool = n_slots * serve_kv_bytes(cfg, cache_len, quant=quant)
            params = cfg.n_params() * _dtype_bytes(
                getattr(cfg, "param_dtype", "bfloat16"))
            capacity = n_devices * device_memory_bytes
            if params + pool > capacity:
                add("P019", ERROR,
                    f"slot pool {pool / GiB:.1f} GiB ({n_slots} slots x "
                    f"cache_len {cache_len}) + params {params / GiB:.1f} "
                    f"GiB exceeds the endpoint's {capacity / GiB:.0f} GiB "
                    f"({n_devices} x {device_memory_bytes / GiB:.0f} GiB)",
                    plan_field="kv_cache_quant" if not quant else None,
                    pool_bytes=pool, param_bytes=params,
                    capacity_bytes=capacity)
                if not quant:
                    pool_q = n_slots * serve_kv_bytes(cfg, cache_len,
                                                      quant=True)
                    if params + pool_q <= capacity:
                        add("P104", INFO,
                            "the slot pool would fit with kv_cache_quant "
                            f"(int8 cache: {pool_q / GiB:.1f} GiB)",
                            plan_field="kv_cache_quant",
                            pool_bytes=pool_q)

    # --- P017: implicit attention-block padding -------------------------
    thresh = getattr(plan, "blockwise_attn_threshold", 1 << 30)
    if seq is not None and kind in ("train", "prefill") and seq >= thresh:
        for f in ("attn_block_q", "attn_block_kv"):
            blk = min(getattr(plan, f, seq), seq)
            if blk and seq % blk != 0:
                add("P017", INFO,
                    f"{f}={getattr(plan, f)}: seq {seq} % {blk} != 0, "
                    "blockwise attention pads the sequence (wasted tiles)",
                    plan_field=f)

    return out
