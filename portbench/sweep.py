"""Find the highest Poisson rate a serving mix sustains: run the mix at
each rate of ``--rates`` in turn on the card and print, per rate, the
queue at the window's start and end, TTFT and ITL percentiles and the
tokens served per second.  A rate is sustained while the queue does not
grow through the window.

    python3 portbench/sweep.py --workload granite-3-2b.chat.poisson \
        --rates 16,20,24,28,32 --seconds 15 --seed 7
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    import torch
    from portbench import harness, reduce, yardstick as ys
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = {c["name"]: c for c in harness.benchmark()["workloads"]}[
        args.workload]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for rate in [float(r) for r in args.rates.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(cell, args.seed, args.seconds, False,
                          torch.device("cuda", 0), t0)
        run.mix = copy.deepcopy(run.mix)
        run.mix["arrivals"]["rate_per_s"] = rate
        run.limits = {"gap_max": float("inf"), "logit_err": float("inf")}
        run.mix["check"] = {"min_tokens": 0, "max_requests": 0}
        harness.execute(run)
        q = run.ticks
        print(json.dumps({
            "rate": rate, "queue_start": q[0][2], "queue_end": q[-1][2],
            "queue_max": max(x[2] for x in q), "ticks": len(q),
            "ttft_p50_ms": reduce.ms(ys.percentile(reduce.ttft_s(run), 50)),
            "ttft_p95_ms": reduce.ms(ys.percentile(reduce.ttft_s(run), 95)),
            "itl_p50_ms": reduce.ms(ys.percentile(reduce.itl_s(run), 50)),
            "itl_p95_ms": reduce.ms(ys.percentile(reduce.itl_s(run), 95)),
            "failed": run.failed, "attempted": run.attempted,
            "mean_tick_ms": 1e3 * (q[-1][1] - q[0][0]) / len(q),
            "card": smi}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
