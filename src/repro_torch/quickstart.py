"""Quickstart: automatic offloading of the paper's three applications to a
mixed destination environment (paper Fig. 3 behaviour), on the card.

    PYTHONPATH=src python -m repro_torch.quickstart [--full] [--device cpu]

For each app the planner runs the six ordered verifications (FB->many-core,
FB->GPU, FB->FPGA, loops->many-core, loops->GPU, loops->FPGA analogues),
measures every candidate in the verification environment, checks result
equality against the single-core reference, and picks the fastest pattern
meeting the user target.  The counterpart of ``examples/quickstart.py``,
with the same printout.
"""
from __future__ import annotations

import argparse

from repro_torch.apps import APPS
from repro_torch.core.ga import GAConfig
from repro_torch.core.measure import TimedRunner
from repro_torch.core.planner import PlanReport, UserTarget, plan_offload

APP_ORDER = ("3mm", "NAS.BT", "tdFIR")


def run_app(name: str, target: UserTarget, *, full: bool, policy: str,
            device=None, **planner_kw) -> PlanReport:
    """One app through the planner with the quickstart's settings;
    ``planner_kw`` go to ``plan_offload`` (``cost_runner=``,
    ``publish=``)."""
    app = APPS[name]()
    inputs = app.make_inputs(seed=0, small=not full, device=device)
    return plan_offload(
        app, target, inputs=inputs, runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig.for_gene_length(min(app.gene_length, 6), seed=0),
        policy=policy, device=device, **planner_kw)


def print_report(name: str, report: PlanReport) -> None:
    print(f"\n=== {name} ===  single-core: "
          f"{report.ref_time_s*1e3:.2f} ms  [policy={report.policy}]"
          f"{'  (early stop)' if report.early_stopped else ''}")
    for r in report.records:
        mark = " <== selected" if r is report.selected else ""
        t = ("-" if r.best_time_s == float("inf")
             else f"{r.best_time_s*1e3:8.2f} ms")
        measured = r.cache_stats.get("measured", r.n_measurements)
        reused = r.cache_stats.get("reused", 0)
        dedupe = f", reused {reused}" if reused else ""
        modeled = ("" if r.mesh_time_s is None
                   else f"  modeled {r.mesh_time_s*1e6:.2f} us")
        print(f"  {r.order}. {r.paper_analogue:14s} {r.method:15s} "
              f"{t}  x{r.improvement:6.2f}  "
              f"(measured {measured} patterns{dedupe}){modeled}{mark}")
    sel = report.selected
    print(f"  offload pattern: "
          f"{ {k: v for k, v in sel.choice.items() if v != 'seq'} }")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full paper sizes (slower)")
    ap.add_argument("--device", default=None,
                    help="device to run on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--target-speedup", type=float, default=None)
    ap.add_argument("--max-price", type=float, default=None)
    ap.add_argument("--policy", default="host-time",
                    help="destination-selection policy "
                         "(repro_torch.backends.policy): host-time (paper's "
                         "fastest-correct rule) | modeled | price-weighted "
                         "| power (modeled joules per step) | edp")
    args = ap.parse_args(argv)

    target = UserTarget(target_speedup=args.target_speedup,
                        max_price=args.max_price)
    for name in APP_ORDER:
        report = run_app(name, target, full=args.full, policy=args.policy,
                         device=args.device)
        print_report(name, report)


if __name__ == "__main__":
    main()
