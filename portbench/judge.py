"""The comparisons that decide ``correct``: the program's outputs against
the plain reference (``portbench/reference``), each number beside the
cell's limit (``portbench/limits/<cell>.json``).

Serving: the requests recorded in the window (a sample drawn from the
seed, ``portbench/drivers/serve.py``) that finished; the reference runs
once over each prompt and its served tokens.  Two numbers: the widest gap
by which a served token's logit lies below the reference's best at its
position (``gap_max``), and the widest error of the program's logits there
against the reference's, over the spread of the reference's row
(``logit_err``).

Training: the first steps' losses, each leaf's norm of the first gradient
as the optimizer got it (read from its first moment after step 1) and of
the parameters' change over the steps; each norm is compared by the gap
between the program's and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf, and the worst leaf
counts.  Leaves whose reference gradient is under a thousandth of the
median leaf's are left out of the change (they move by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic, weights
from portbench.reference import lm as reflm


def serving(run, done: List[tuple], control: bool = False) -> Dict:
    """The serving check over ``done``, (rid, record) of the recorded
    requests that finished, each record holding its prompt, its served
    tokens and the program's logits [n, V] that produced them.  With
    ``control`` the fp8 control's readings on the same inputs instead."""
    done = sorted(done, key=lambda rq: int(rq[0]))
    reflm.tf32_off()
    p = weights.draw(run.cfg, run.seed, run.device)
    prompts = [torch.as_tensor(np.asarray(q["tokens"]), device=run.device)
               for _, q in done]
    served = [torch.as_tensor(q["served"], device=run.device)
              for _, q in done]
    ref = reflm.served_logits(prompts, served, p, run.cfg)
    if control:
        low = reflm.served_logits(prompts, served, p, run.cfg, reflm.mm_fp8)
        got, picks = low, [r.argmax(-1) for r in low]
    else:
        got, picks = [q["logits"] for _, q in done], served
    del p
    g = torch.cat([reflm.gaps(r, t) for r, t in zip(ref, picks)]) \
        if ref else torch.zeros(0)
    n = int(g.numel())
    gap = float(g.max()) if n else float("inf")
    gap = gap if np.isfinite(gap) else 1e30
    err = max((reflm.logit_error(a, b) for a, b in zip(got, ref)),
              default=float("inf"))
    lim = run.limits
    need = run.mix["check"]["min_tokens"] // 2
    run.judged = [rid for rid, _ in done]
    return {"gap_max": (gap, lim["gap_max"], gap <= lim["gap_max"]),
            "logit_err": (err, lim["logit_err"], err <= lim["logit_err"]),
            "judged_tokens": (n, need, n >= need)}


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    """The worst leaf's gap between the program's and the reference's
    norm, over the larger of the reference's norm of that leaf and of the
    median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The three training numbers of a program's readings against the
    reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = {n for n, x in g.items() if x >= 1e-3 * med}
    return {"loss_gap": loss,
            "grad_norm_gap": norm_gaps(prog["grad_norms"], g),
            "change_norm_gap": norm_gaps(prog["change_norms"],
                                         ref["change_norms"], moving)}


CHECK_STEPS = 3     # training steps the reference follows


def reference_training(run, steps: int, mm=reflm.mm_fp32) -> dict:
    reflm.tf32_off()
    p0 = weights.draw(run.cfg, run.seed, run.device)
    batches = [traffic.train_batch(run.mix, run.cfg, run.seed, k,
                                   run.device) for k in range(steps)]
    return reflm.train(p0, batches, run.cfg, run.mix["train_config"], mm)


def training(run, prog: dict) -> Dict:
    ref = reference_training(run, len(prog["losses"]))
    got = compare(prog, ref)
    run.readings = {"program": prog, "reference": ref}
    return {k: (v, run.limits[k], v <= run.limits[k])
            for k, v in got.items()}
