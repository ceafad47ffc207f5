"""Multi-pod dry run: trace every (arch x shape x mesh) cell's full-width
step on one device of the production mesh; the port of
``repro.launch.dryrun``.

The reference lowers and compiles each cell's step for 512 fake XLA
devices and reads XLA's memory and cost analyses.  Here the production
mesh (:func:`repro_torch.launch.mesh.make_production_mesh`) lies over a
``"fake"`` process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``: no peers, no
communication), the step's inputs are :mod:`~repro_torch.launch.specs`
placed by ``tree_shardings``, and
:func:`repro_torch.core.trace_analysis.trace` runs the step once on this
rank's fake shards: nothing is allocated or launched on any device.  The
trace's memory account gives the per-device footprint (``memory``, the
reference's five keys), its op walk the FLOPs, bytes and collectives that
feed the roofline (priced at the H100's peaks), and the roofline the
modeled energy (``power.cell_energy``, the H100 envelope) and the policy
score.  The kernels are reached inside ``Rules.local`` as serving and
training reach them, as fake calls reporting their ``work``.

The steps are the port's own: ``make_train_step`` on the ("data",
"model") mesh; on the multi-pod mesh the pod-parallel step
(``make_pod_parallel_train_step``: each pod its rows, partitioned on its
pod's sub-mesh, the gradients summed over "pod"); prefill and the eager
``make_serve_step`` (the continuous batcher's decode step on a
partitioned LM, no graph capture), on the multi-pod mesh each pod serving
its share of the batch on its sub-mesh.  Results are cached as JSON under
``experiments/dryrun_torch/``; the cell keeps the reference's keys, with
``trace_s`` for ``lower_s`` and ``compile_s`` and ``fits_80GiB`` (against
``analysis.DEVICE_MEMORY_BYTES``) for ``fits_16GiB``.

The traced tensors are fake tensors of ``--device`` (default: the card
when there is one, else the CPU; nothing runs on either).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all           # a subprocess a cell
  python -m repro_torch.launch.dryrun --all --mesh both --policy power
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
WORLD = 512            # the fake process group: the multi-pod mesh's ranks


def default_device() -> str:
    """The device type the cells' fake tensors take: the card's when
    there is one, else the CPU's (the trace runs on neither)."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_group(world: int = WORLD):
    """A ``"fake"`` process group of ``world`` ranks (the dry run's
    ``WORLD`` by default), this process rank 0, for the block (an
    existing group of that size is used as it is)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is running; this needs {world}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def default_plan(cfg, shape, plan_name: str = "auto",
                 overrides: Optional[dict] = None):
    """The cell's plan: a named plan (patched by ``overrides``), or the
    auto baseline of the reference (no remat outside training, the
    decode cache's slots over "model", a chunked vocabulary from 100k),
    patched by ``overrides`` (``--plan-json``)."""
    from repro_torch.dist import plan as plan_mod
    from repro_torch.dist.plan import Plan
    if plan_name not in ("auto", "baseline"):
        named = {p.name: p for p in vars(plan_mod).values()
                 if isinstance(p, Plan)}
        if plan_name in named:
            base = named[plan_name]
            return dataclasses.replace(base, **overrides) if overrides \
                else base
    kw: Dict[str, Any] = {}
    if shape.kind != "train":
        kw["remat"] = "none"
    if shape.kind == "decode":
        kw["decode_kv_seq_shard"] = True
    if cfg.padded_vocab >= 100_000:
        kw["vocab_chunk"] = 512
    name = "auto-baseline"
    if overrides:
        kw.update(overrides)
        name = plan_name if plan_name not in ("auto", "baseline") \
            else "override"
    return Plan(name=name, **kw)


def _pod_share(shape, mesh):
    """The shape one pod serves on a multi-pod mesh (its rows of the
    batch), the shape itself elsewhere."""
    from repro_torch.dist.sharding import mesh_axes
    pods = mesh_axes(mesh).get("pod", 1)
    if pods == 1:
        return shape
    if shape.global_batch % pods:
        raise ValueError(f"{shape.name}: batch {shape.global_batch} does not "
                         f"split over {pods} pods")
    return dataclasses.replace(shape, global_batch=shape.global_batch // pods)


def build_step(cfg, shape, mesh, plan, device=None):
    """``(fn, inputs, shardings)`` of the cell's step: ``fn(inputs)`` builds
    the LM on its placed parameters and runs one step; ``inputs`` is a
    tree of TensorSpecs and ``shardings`` its NamedShardings (None where
    a rank holds a leaf whole).  On a mesh with a "pod" axis the LM, its
    parameters and optimizer state lie on each pod's ("data", "model")
    sub-mesh (``LM`` partitions there).  ``mesh`` None is one device:
    every leaf whole, ``shardings`` None."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.sharding import (NullRules, Rules, mesh_axes,
                                           tree_shardings)
    from repro_torch.launch import specs
    from repro_torch.models.lm import LM, cache_axes, param_axes
    from repro_torch.train import optimizer, train_step as ts

    rules = Rules(mesh, plan) if mesh is not None else NullRules()
    pods = mesh is not None and "pod" in mesh_axes(mesh)
    inner = rules.without("pod") if pods else rules

    def placed(axes, tree):
        return None if mesh is None else tree_shardings(inner, axes, tree)

    p_specs = specs.param_specs(cfg, device)
    p_axes = param_axes(cfg)
    p_sh = placed(p_axes, p_specs)

    if shape.kind == "train":
        tcfg = TrainConfig(microbatches=plan.microbatches,
                           master_dtype=plan.opt_state_dtype)
        o_specs = specs.opt_specs(p_specs, tcfg)
        o_sh = placed(optimizer.opt_state_axes(p_axes, tcfg), o_specs)
        if o_sh is not None:
            o_sh["count"] = None        # a plain scalar on every rank
        batch = specs.batch_specs(cfg, shape, device)
        if pods or mesh is None:   # every rank takes the whole batch
            b_sh = None
        else:
            b_axes = specs.logical_batch_axes(cfg, shape)
            b_sh = {k: rules.sharding(b_axes[k], batch[k].shape)
                    for k in batch}

        def train(inputs):
            params, opt_state, batch, step = inputs
            model = LM(cfg, params, plan, rules)
            fn = (ts.make_pod_parallel_train_step(model, tcfg, mesh) if pods
                  else ts.make_train_step(model, tcfg))
            return fn(model.params(), opt_state, batch, step)

        inputs = (p_specs, o_specs, batch, specs.step_spec(device))
        return train, inputs, (None if mesh is None
                               else (p_sh, o_sh, b_sh, None))

    served = _pod_share(shape, mesh) if mesh is not None else shape
    batch = specs.batch_specs(cfg, served, device)
    b_axes = specs.logical_batch_axes(cfg, served)
    b_sh = {k: inner.sharding(b_axes[k], batch[k].shape) for k in batch}
    if shape.kind == "prefill":
        def prefill(inputs):
            params, batch = inputs
            model = LM(cfg, params, plan, rules)
            return ts.make_prefill_step(model, cache_len=shape.seq_len)(batch)

        return prefill, (p_specs, batch), (None if mesh is None
                                           else (p_sh, b_sh))
    cache = specs.cache_specs(cfg, served, plan, device)
    c_sh = placed(cache_axes(cfg, quant=plan.kv_cache_quant), cache)

    def decode(inputs):
        params, cache, tokens, pos = inputs
        model = LM(cfg, params, plan, rules)
        return ts.make_serve_step(model)(cache, tokens, pos)

    inputs = (p_specs, cache, batch["tokens"], specs.step_spec(device))
    return decode, inputs, (None if mesh is None
                            else (p_sh, c_sh, b_sh["tokens"], None))


def trace_cell(cfg, shape, mesh, plan, device=None):
    """The cell's step traced on one device of ``mesh`` (None: one device,
    no mesh): (artifact, seconds)."""
    from repro_torch.core.trace_analysis import trace
    fn, inputs, shardings = build_step(cfg, shape, mesh, plan, device)
    t0 = time.perf_counter()
    artifact = trace(fn, inputs, shardings)
    return artifact, time.perf_counter() - t0


def kernel_calls(artifact) -> Dict[str, dict]:
    """The fake kernel calls a trace recorded: per kernel its calls, FLOPs
    and bytes (their ``work``), and the peak its FLOPs are priced at."""
    out: Dict[str, dict] = {}
    for op in artifact.ops:
        if op.name.startswith("kernel."):
            row = out.setdefault(op.name[len("kernel."):], {
                "calls": 0, "flops": 0.0, "bytes": 0.0, "dtype": op.dtype})
            row["calls"] += 1
            row["flops"] += op.flops
            row["bytes"] += op.bytes
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             plan_name: str = "auto", out_dir: Path = OUT_DIR,
             overrides: Optional[dict] = None, policy: str = "host-time",
             use_cache: bool = True, device=None) -> dict:
    """One dry-run cell, wrapped in a ``dryrun/cell`` span
    (repro_torch.obs), inside a fake process group of 512 ranks unless one
    of that size runs."""
    from repro_torch.obs import get_tracer
    with get_tracer().span("cell", cat="dryrun", track="dryrun",
                           arch=arch, shape=shape_name, mesh=mesh_kind,
                           plan=plan_name) as span, fake_group():
        result = _run_cell(arch, shape_name, mesh_kind, plan_name, out_dir,
                           overrides, policy, use_cache, device)
        span.set(skipped="skip" in result, pruned="lint" in result
                 and "error" in result, cache_hit=result.get("cache_hit"),
                 trace_s=result.get("trace_s"),
                 verify_s=result.get("verify_s"))
    return result


def _run_cell(arch: str, shape_name: str, mesh_kind: str,
              plan_name: str = "auto", out_dir: Path = OUT_DIR,
              overrides: Optional[dict] = None, policy: str = "host-time",
              use_cache: bool = True, device=None) -> dict:
    from repro_torch.analysis import (DEVICE_MEMORY_BYTES, findings_to_json,
                                      has_errors, lint_plan)
    from repro_torch.backends import get_policy
    from repro_torch.configs import cell_runnable, get_config, get_shape
    from repro_torch.core import cost_model
    from repro_torch.core import search_cache as sc
    from repro_torch.core.candidates import Candidate
    from repro_torch.dist.sharding import mesh_axes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.power import cell_energy

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    result: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "plan": plan_name, "policy": policy}
    if not cell_runnable(cfg, shape):
        result["skip"] = ("long_500k needs sub-quadratic attention; "
                          f"{arch} is pure full-attention")
        return result

    device = device or default_device()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=device)
    axes = mesh_axes(mesh)
    n_chips = mesh.size()
    plan = default_plan(cfg, shape, plan_name, overrides)
    result["plan_detail"] = dataclasses.asdict(plan)

    # the static plan lint: its findings ride the cell JSON, and an
    # error-severity finding prunes the cell before any trace
    pipelined = bool(overrides and "pipeline_schedule" in overrides)
    lint = lint_plan(plan, mesh=axes, cfg=cfg, shape=shape,
                     pipelined=pipelined)
    result["lint"] = findings_to_json(lint)
    if has_errors(lint):
        result["error"] = "statically pruned: " + "; ".join(
            f"{f.rule_id}: {f.message}" for f in lint
            if f.severity == "error")
        return result

    # structure-keyed cache: cells whose plans differ only in model-only
    # genes (the --schedule variants of one baseline) share one trace,
    # and a repeated invocation traces nothing
    cache = sc.SearchCache((out_dir / "search_cache.json") if use_cache
                           else None)
    cache_key = ("dryrun", arch, shape_name, mesh_kind, device,
                 tuple(axes.items()), plan.structural_key())
    cache.stats.candidates += 1
    t0 = time.perf_counter()
    payload = cache.lookup(cache_key)
    cache_hit = (payload is not None and "error" not in payload
                 and isinstance(payload.get("extra"), dict)
                 and "memory" in payload["extra"])
    if cache_hit:
        analyzed = payload["analysis"]
        trace_s = payload.get("compile_s", 0.0)
        totals = payload["extra"].get("xla_cost_analysis", {})
        memory = payload["extra"]["memory"]
        kernels = payload["extra"].get("kernel_calls", {})
        verify_s = time.perf_counter() - t0     # this run's cost: a lookup
    else:
        artifact, trace_s = trace_cell(cfg, shape, mesh, plan, device)
        verify_s = trace_s
        analyzed = sc.analyze_artifact(artifact)
        memory = artifact.memory
        totals = {"flops": analyzed["flops"],
                  "bytes accessed": analyzed["bytes"]}
        kernels = kernel_calls(artifact)
        cache.put(cache_key, analyzed, trace_s,
                  extra={"memory": memory, "xla_cost_analysis": totals,
                         "kernel_calls": kernels})
    mf = cost_model.model_flops_for(cfg, shape)
    # the schedule's bubble stretches the step only for a cell that asks
    # for a pipeline (--schedule / --plan-json)
    bubble = (cost_model.plan_bubble_fraction(plan, axes.get("pod", 1))
              if pipelined else 0.0)
    rl = cost_model.roofline_from_analysis(analyzed, n_chips=n_chips,
                                           model_flops=mf,
                                           bubble_fraction=bubble)
    result.update({
        "n_chips": n_chips,
        "trace_s": round(trace_s, 2),
        "verify_s": round(verify_s, 3),
        "cache_hit": cache_hit,
        "xla_cost_analysis": totals,
        "hlo_analysis": {k: float(v) for k, v in analyzed.items()},
        "memory": memory,
        "kernel_calls": kernels,
        "collectives": {k.replace("coll_", ""): v
                        for k, v in analyzed.items()
                        if k.startswith("coll_")},
        "collective_counts": {k.replace("count_", ""): v
                              for k, v in analyzed.items()
                              if k.startswith("count_")},
        "roofline": rl.to_dict(),
        "fits_80GiB": memory["peak_estimate_bytes"] < DEVICE_MEMORY_BYTES,
    })
    e_rep = cell_energy(rl, n_chips)
    result["energy"] = e_rep.to_dict() if e_rep is not None else None
    result["policy_score"] = get_policy(policy).score_candidate(
        Candidate.from_cell(rl.step_time_s, n_chips=float(n_chips),
                            backend=mesh_kind, arch=str(arch),
                            energy=result["energy"]))
    return result


def cell_path(out_dir: Path, arch, shape, mesh_kind, plan_name) -> Path:
    tag = f"{arch}__{shape}__{mesh_kind}"
    if plan_name not in ("auto", "baseline"):
        tag += f"__{plan_name}"
    return out_dir / f"{tag}.json"


def _rank_by_policy(policy: str, todo, out_dir: Path, plan_tag: str) -> None:
    """For each (arch, shape) with more than one traced mesh cell, print the
    one the policy picks (rescored from each cell's stored roofline)."""
    from repro_torch.backends import get_policy
    from repro_torch.core.candidates import Candidate
    from repro_torch.power import cell_energy
    pol = get_policy(policy)
    by_cell: dict = {}
    for arch, shape, mesh_kind in todo:
        path = cell_path(out_dir, arch, shape, mesh_kind, plan_tag)
        if not path.exists():
            continue
        r = json.loads(path.read_text())
        if "error" in r or "skip" in r or "roofline" not in r:
            continue
        energy = r.get("energy")
        if energy is None:
            e_rep = cell_energy(r["roofline"], r["n_chips"])
            energy = r["energy"] = (e_rep.to_dict() if e_rep is not None
                                    else None)
        score = pol.score_candidate(Candidate.from_cell(
            r["roofline"]["step_time_s"], n_chips=float(r["n_chips"]),
            backend=mesh_kind, arch=str(arch), energy=energy, ref=r))
        by_cell.setdefault((arch, shape), []).append((score, mesh_kind, r))
    for (arch, shape), cells in sorted(by_cell.items()):
        if len(cells) < 2:
            continue
        score, mesh_kind, r = min(cells, key=lambda c: c[0])
        e = r.get("energy") or {}
        e_tag = (f", {e['energy_j']:.1f} J/step @ {e['avg_watts']:.0f} W"
                 if e else "")
        print(f"[policy={pol.name}] {arch} x {shape}: {mesh_kind} "
              f"({r['n_chips']} cards, "
              f"step={r['roofline']['step_time_s']:.4f}s{e_tag}, "
              f"score={score:.4f})")


def _run_all(args, out_dir: Path, plan_tag: str) -> int:
    from repro_torch.configs import ARCHS, SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes]
    ok = fail = skip = 0
    for arch, shape, mesh_kind in todo:
        path = cell_path(out_dir, arch, shape, mesh_kind, plan_tag)
        if path.exists() and not args.force:
            prev = json.loads(path.read_text())
            ok += ("error" not in prev and "skip" not in prev)
            skip += "skip" in prev
            fail += "error" in prev
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
               "--plan", args.plan, "--policy", args.policy,
               "--device", args.device, "--out", str(out_dir)]
        if args.schedule:
            cmd += ["--schedule", args.schedule]
        if args.virtual_stages:
            cmd += ["--virtual-stages", str(args.virtual_stages)]
        if args.plan_json:
            cmd += ["--plan-json", args.plan_json]
        if args.no_search_cache:
            cmd += ["--no-search-cache"]
        print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...", flush=True)
        try:
            r = subprocess.run(cmd, timeout=args.timeout,
                               capture_output=True, text=True)
            if r.returncode != 0:
                if not path.exists():
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mesh_kind,
                         "error": (r.stderr or r.stdout)[-4000:]},
                        indent=1))
                fail += 1
                print(f"  FAIL (rc={r.returncode})", flush=True)
                continue
            res = json.loads(path.read_text())
            if "skip" in res:
                skip += 1
                print("  skip", flush=True)
                continue
            ok += 1
            rl = res["roofline"]
            e = res.get("energy") or {}
            e_tag = (f" energy={e['energy_j']:.1f}J@{e['avg_watts']:.0f}W"
                     if e else "")
            print(f"  ok trace={res['trace_s']}s dominant={rl['dominant']} "
                  f"step={rl['step_time_s']:.4f}s{e_tag}", flush=True)
        except subprocess.TimeoutExpired:
            path.write_text(json.dumps(
                {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "error": f"timeout after {args.timeout}s"}, indent=1))
            fail += 1
            print("  TIMEOUT", flush=True)
    _rank_by_policy(args.policy, todo, out_dir, plan_tag)
    print(f"[dryrun] done: {ok} ok, {skip} skip, {fail} fail")
    return 1 if fail else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--plan", default="auto")
    ap.add_argument("--plan-json", default=None,
                    help="JSON dict of Plan field overrides")
    ap.add_argument("--schedule", default=None,
                    choices=["gpipe", "one_f_one_b", "interleaved"],
                    help="pipeline schedule gene (repro_torch.dist."
                         "schedules); overrides Plan.pipeline_schedule and "
                         "folds the schedule's bubble fraction into the "
                         "roofline on meshes with a pod axis")
    ap.add_argument("--virtual-stages", type=int, default=None,
                    help="chunks per rank for --schedule interleaved")
    ap.add_argument("--policy", default="host-time",
                    help="selection policy ranking the traced cells "
                         "(repro_torch.backends.policy): host-time | "
                         "modeled rank the modeled step time; "
                         "price-weighted step time x card count; power the "
                         "cell's modeled joules a step (the H100 envelope "
                         "at the roofline's utilization) and edp its "
                         "energy-delay product.  With --all, the best mesh "
                         "per (arch, shape) under the policy is printed.")
    ap.add_argument("--device", default=None,
                    help="device type of the traced fake tensors (default: "
                         "cuda when a card is present, else cpu)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-search-cache", action="store_true",
                    help="bypass the structure-keyed trace cache "
                         "(<out>/search_cache.json) and always trace")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record a repro_torch.obs trace of this "
                         "invocation's cells: JSONL events if PATH ends in "
                         ".jsonl, else a Chrome trace (single-cell mode "
                         "only; --all runs each cell in a subprocess)")
    args = ap.parse_args(argv)
    args.device = args.device or default_device()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # schedule flags ride the Plan overrides; a pipelined cell caches under
    # a tag of its own, whether its genes come by --schedule or --plan-json
    sched: dict = {}
    if args.schedule:
        sched["pipeline_schedule"] = args.schedule
    if args.virtual_stages:
        if not args.schedule:
            ap.error("--virtual-stages requires --schedule")
        sched["virtual_stages"] = args.virtual_stages
    try:
        overrides = json.loads(args.plan_json) if args.plan_json else {}
    except json.JSONDecodeError as e:
        ap.error(f"--plan-json is not valid JSON: {e}")
    overrides = dict(overrides, **sched)
    plan_tag = args.plan
    if "pipeline_schedule" in overrides:
        plan_tag = f"{args.plan}-{overrides['pipeline_schedule']}"
        if overrides.get("virtual_stages"):
            plan_tag += f"-v{overrides['virtual_stages']}"

    if args.all:
        return _run_all(args, out_dir, plan_tag)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape name the cell (or --all)")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    from repro_torch import obs
    tracer = obs.Tracer() if args.trace else obs.NULL_TRACER
    rc = 0
    try:
        for mesh_kind in meshes:
            path = cell_path(out_dir, args.arch, args.shape, mesh_kind,
                             plan_tag)
            try:
                with obs.use_tracer(tracer):
                    res = run_cell(args.arch, args.shape, mesh_kind,
                                   args.plan, out_dir, overrides or None,
                                   policy=args.policy,
                                   use_cache=not args.no_search_cache,
                                   device=args.device)
            except Exception:
                res = {"arch": args.arch, "shape": args.shape,
                       "mesh": mesh_kind,
                       "error": traceback.format_exc()[-6000:]}
                rc = 1
            path.write_text(json.dumps(res, indent=1))
            print(json.dumps({k: v for k, v in res.items()
                              if k in ("arch", "shape", "mesh", "trace_s",
                                       "verify_s", "cache_hit", "roofline",
                                       "energy", "fits_80GiB", "memory",
                                       "skip", "error")}, indent=1))
    finally:
        if args.trace:
            if args.trace.endswith(".jsonl"):
                obs.write_jsonl(tracer.records, args.trace)
            else:
                obs.write_chrome_trace(tracer.records, args.trace)
    return rc


if __name__ == "__main__":
    sys.exit(main())
