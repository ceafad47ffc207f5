"""Readings that the limits in ``portbench/limits/`` are set from: the
program's numbers on many seeds, and the lower-precision control's on the
same inputs (the reference with every matrix product in float8 e4m3).
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 6 [--fault half_batch|altered_token]

For each seed it drives the cell's window at its own load for
``--seconds``, judges the program as a run does, and then reads the
control: for a serving cell, at each position of the same sampled prompts
and served tokens, the gap of the token the fp8 reference ranks first;
for a training cell, the fp8 reference's three steps against the fp32
reference's.  ``--fault`` reads a fault of the program instead:
``half_batch``, a training loss taken over half of each batch;
``altered_token``, each decode step's token replaced where it is produced
by the one its logits rank second.  One JSON line a seed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


@contextlib.contextmanager
def half_batch():
    """The port's training loss taken over the first half of each batch's
    rows."""
    from repro_torch.models.lm import LM
    orig = LM.train_loss

    def half(self, batch):
        b = batch["tokens"].shape[0] // 2
        return orig(self, {k: v[:b] for k, v in batch.items()})

    LM.train_loss = half
    try:
        yield
    finally:
        LM.train_loss = orig


@contextlib.contextmanager
def altered_token():
    """Each decode step's token replaced, where it is produced, by the one
    the step's logits rank second."""
    from repro_torch.serve.batching import ContinuousBatcher
    orig = ContinuousBatcher._step

    def step(self):
        logits = orig(self)
        v = self.cfg.vocab_size
        second = logits[:, :v].topk(2, dim=1).indices[:, 1:]
        return logits.scatter(1, second, logits[:, :v].amax(1, True) + 1.0)

    ContinuousBatcher._step = step
    try:
        yield
    finally:
        ContinuousBatcher._step = orig


FAULTS = {"half_batch": half_batch, "altered_token": altered_token}


def control_readings(run) -> dict:
    """The control's numbers on the run's own inputs."""
    from portbench import judge
    from portbench.reference import lm as reflm
    if run.mix["kind"] == "train":
        low = judge.reference_training(run, judge.CHECK_STEPS,
                                       reflm.mm_fp8)
        return judge.compare(low, run.readings["reference"])
    done = [(rid, run.requests[rid]) for rid in run.judged]
    got = judge.serving(run, done, control=True)
    return {k: got[k][0] for k in ("gap_max", "logit_err")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fault", choices=tuple(FAULTS), default=None)
    args = ap.parse_args()
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = {c["name"]: c for c in harness.benchmark()["workloads"]}[
        args.workload]
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = harness.Run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter())
        fault = FAULTS[args.fault]() if args.fault else \
            contextlib.nullcontext()
        with fault:
            harness.execute(run)
        line = {"seed": seed, "fault": args.fault,
                "program": {k: v for k, (v, _, _) in run.checks.items()}}
        if not args.fault:
            line["control"] = control_readings(run)
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
