"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: the cell, its configuration, traffic, limits
and metric readers are found by name (``portbench/harness.py``), the port
(``src/repro_torch``) is the system under test.  The last line of standard
output is the result as one JSON object; the numbers compared for
``correct`` close standard error.  Without a card, or with fewer cards than
the cell asks for, it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own nvcc builds live in ``src/repro_torch/csrc/build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("CUDA_MODULE_LOADING", "LAZY")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches()
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch
    from portbench import harness

    bench = harness.benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cell {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_PROCESS)
    harness.execute(run)
    if run.forbidden:
        print(f"JAX or the JAX package was loaded: {run.forbidden}",
              file=sys.stderr)
        return 3
    out = harness.result(run, bench)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
