"""Framework-side offload search: the paper's GA over execution-plan genes
(sharding, remat, microbatching, compression, the pipeline schedule) for
an LM training step, with the traced roofline as the fitness measurement:
the ``CompiledCostRunner`` verification environment.  The counterpart of
``examples/autoplan_model.py``, with its flags and printout (``compile
time`` is the trace time here) and ``--device``.

    PYTHONPATH=src python -m repro_torch.autoplan_model [--arch h2o-danube-1.8b]

The mesh is (pod 2, data 2, model 2) over a fake process group of 8 ranks
(``launch.dryrun.fake_group``): each candidate's train step is built as
``launch.dryrun.build_step`` builds a cell's (the pod-parallel step, the
LM partitioned on each pod's sub-mesh) and traced on one rank's fake
shards of ``--device``'s type (default the card's; nothing is allocated
or launched there).  Candidates are deduped by ``Plan.structural_key()``
before tracing, the model-only schedule genes are charged by the bubble
they would impose on the pod ranks, and the on-disk search cache lets a
repeat search over the same (arch, shape, mesh) run with no trace.  The
best plan is selected by ``--policy`` over every traced candidate
(``Candidate.from_roofline``, charged with the H100 envelope by
``power.cell_energy``).
"""
from __future__ import annotations

import argparse
from pathlib import Path

MESH = ((2, 2, 2), ("pod", "data", "model"))
DEFAULT_CACHE = (Path(__file__).resolve().parents[2] / "experiments"
                 / "search_cache_torch")


def main(argv=None):
    """Run the search; returns (best plan, its evaluation, the cache's
    stats)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--generations", type=int, default=4)
    ap.add_argument("--population", type=int, default=5)
    ap.add_argument("--compile-workers", type=int, default=4,
                    help="threads tracing one generation's unique "
                         "structural candidates")
    ap.add_argument("--cache-dir", default=str(DEFAULT_CACHE),
                    help="directory for the on-disk search-cache JSON "
                         "(repro_torch.core.search_cache); a warm cache "
                         "scores repeat searches with zero traces")
    ap.add_argument("--no-disk-cache", action="store_true",
                    help="keep the search cache in memory only")
    ap.add_argument("--policy", default="modeled",
                    help="plan-selection policy (repro_torch.backends."
                         "policy): modeled / host-time rank pure modeled "
                         "step time; price-weighted weights each plan's "
                         "per-device memory traffic (a machine-size proxy); "
                         "power / edp rank the modeled joules per step of "
                         "each candidate's roofline under the mesh's H100 "
                         "envelope (repro_torch.power)")
    ap.add_argument("--device", default=None,
                    help="device type of the traced fake tensors (default "
                         "cuda; nothing runs on it)")
    args = ap.parse_args(argv)

    from repro_torch.backends import get_policy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import search_cache as sc
    from repro_torch.core.candidates import Candidate
    from repro_torch.core.ga import GAConfig, run_ga
    from repro_torch.core.measure import CompiledCostRunner
    from repro_torch.core.trace_analysis import Traceable
    from repro_torch.device import resolve
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import mesh_axes
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.power import cell_energy

    device = resolve(args.device).type
    cfg = get_config(args.arch).reduced()
    shape = ShapeConfig("plan-search", 64, 16, "train")
    pol = get_policy(args.policy)
    with dryrun.fake_group(world=8):
        # a pod axis so that the pipeline-schedule genes have a
        # destination: they are scored by model (the traced step stays the
        # dp / tp pod step), each candidate's step stretched by the bubble
        # its schedule would impose on the pod ranks
        mesh = make_test_mesh(*MESH, device=device)
        pipe_ranks = mesh_axes(mesh)["pod"]
        runner = CompiledCostRunner(mesh)

        def trace_plan(plan):
            """One candidate's step, not yet traced (the worker pool
            traces it: at most once per unique structural key)."""
            return Traceable(*dryrun.build_step(cfg, shape, mesh, plan,
                                                device))

        cache_path = None if args.no_disk_cache else (
            Path(args.cache_dir) / f"autoplan-{args.arch}.json")
        cache = sc.SearchCache(cache_path)
        evaluate_batch = sc.make_cached_batch_evaluator(
            trace_plan, runner, cache,
            key_extra=("autoplan", args.arch, shape.name, device,
                       sc.mesh_fingerprint(mesh)),
            pipe_ranks=pipe_ranks, workers=args.compile_workers)
        cards = Plan.gene_cardinalities()
        res = run_ga(len(cards), evaluate_batch.evaluate,
                     GAConfig(population=args.population,
                              generations=args.generations, seed=0,
                              cardinalities=cards),
                     evaluate_batch=evaluate_batch)
        n_chips = mesh.size()

    # policy selection over every traced candidate: price is proxied by
    # the plan's per-device memory traffic (relative to the leanest
    # candidate); power / edp rerank by the modeled energy of each
    # candidate's roofline under the mesh's H100 envelope
    valid = [e for e in res.evaluations.values()
             if e.correct and "roofline" in e.info]
    base_bytes = max(min((e.info["roofline"]["bytes_per_device"]
                          for e in valid), default=1.0), 1.0)

    def cand_score(e):
        return pol.score_candidate(Candidate.from_roofline(
            e.info["roofline"], n_chips=n_chips,
            price=e.info["roofline"]["bytes_per_device"] / base_bytes,
            time_s=e.time_s, backend="mesh", arch=args.arch, ref=e))

    scored = [(cand_score(e), genes, e)
              for genes, e in res.evaluations.items()
              if e.correct and "roofline" in e.info]
    if scored:
        _, best_genes, best_eval = min(scored, key=lambda s: s[0])
    else:
        best_genes, best_eval = res.best_genes, res.best_eval
    best = Plan.from_genes(list(best_genes))
    energy = ("roofline" in best_eval.info
              and cell_energy(best_eval.info["roofline"], n_chips))
    e_tag = (f", {energy.energy_j:.1f} J/step @ {energy.avg_watts:.0f} W"
             if energy else "")
    shape_tag = dict(zip(MESH[1], MESH[0]))
    print(f"\nbest plan for {args.arch} under policy={pol.name} "
          f"(modeled step {best_eval.time_s * 1e6:.1f} us{e_tag} "
          f"on {shape_tag}):")
    for gene in Plan.GENE_SPACE:
        tag = "" if gene.structural else "   [model-only]"
        print(f"  {gene.field:22s} = {getattr(best, gene.field)}{tag}")
    st = cache.stats
    print(f"scored {res.n_measurements} candidates | "
          f"unique traces {st.unique_compiles} | "
          f"cache hit rate {st.hit_rate:.0%} "
          f"(disk {st.disk_hits}) | "
          f"trace time {st.compile_s:.1f}s")
    if cache_path is not None:
        print(f"search cache: {cache_path}")
    return best, best_eval, st


if __name__ == "__main__":
    main()
