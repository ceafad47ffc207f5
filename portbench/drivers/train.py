"""The training window: the port's ``make_train_step`` with AdamW on the
LM, one fresh seeded batch a step.

Set-up builds the one step object with its model and optimizer state and
drives it through the first ``judge.CHECK_STEPS`` steps with the window's own
call and feed; it reads each step's loss, each leaf's norm of the first
gradient (from the first moment after step 1) and of the parameters'
change after those steps (the fp32 master copy, or the parameters
themselves without one).  The window then runs steps back to back, each
closed by a synchronisation, from its start until the first step that ends
past ``--seconds``; its rate is over all of them and all their time.  A
traced run profiles the window's first ``trace_s`` seconds and times the
steps after the profiler has stopped on the host clock
(``untraced_steps`` in ``untraced_s``).
Then the program's state is freed and the reference follows the first
steps (:func:`portbench.judge.training`).
"""
from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from portbench import judge, traffic, weights
from portbench.harness import Run, model_config


def leaf_norms(tree, scale: float = 1.0) -> dict:
    names = list(tree)
    norms = torch.stack([torch.linalg.vector_norm(tree[n].float())
                         for n in names]) * scale
    return dict(zip(names, norms.tolist()))


def run(run: Run) -> Run:
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer, train_step

    cfg, mix, dev = run.cfg, run.mix, run.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lm = LM(model_config(cfg), weights.draw(cfg, run.seed, dev),
            Plan(remat=mix["remat"], vocab_chunk=mix["vocab_chunk"]))
    tcfg = TrainConfig(**mix["train_config"])
    step_fn = train_step.make_train_step(lm, tcfg)
    opt = optimizer.init(lm.params(), tcfg)

    def one(k: int):
        batch = traffic.train_batch(mix, cfg, run.seed, k, dev)
        with record_function("portbench.step"):
            _, _, metrics = step_fn(lm.params(), opt, batch, k)
            sync()
        return metrics["loss"]

    losses = []
    for k in range(judge.CHECK_STEPS):
        losses.append(one(k))
        if k == 0:
            grad_norms = leaf_norms(opt["m"], 1.0 / (1.0 - tcfg.beta1))
    base = opt.get("master") or lm.params()
    p0 = weights.draw(cfg, run.seed, dev)
    change = {n: float(torch.linalg.vector_norm(base[n].float()
                                                - p0[n].float()))
              for n in base}
    del p0
    prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}

    session = None
    if run.trace:
        from portbench.trace import Session
        session = Session(dev)
        session.start()
    w0 = time.perf_counter()
    run.setup_s = w0 - run.t_process
    w1, trace_end = w0 + run.seconds, w0 + min(run.seconds, run.trace_s)
    k = judge.CHECK_STEPS
    ends, window_losses = [], []
    resumed = None      # (steps, time) where the profiler had stopped
    while not ends or ends[-1] < w1:
        window_losses.append(one(k))
        k += 1
        ends.append(time.perf_counter())
        if session is not None and ends[-1] >= trace_end:
            run.traced = session.stop()
            session = None
            resumed = (len(ends), time.perf_counter())
    run.after_window()
    if resumed and len(ends) > resumed[0]:
        run.untraced_steps = len(ends) - resumed[0]
        run.untraced_s = ends[-1] - resumed[1]
    run.window = (w0, ends[-1])
    run.train_steps = len(ends)
    run.train_tokens = mix["batch"] * mix["seq"]
    vals = torch.stack(window_losses).float()
    run.attempted = len(ends)
    run.failed = int((~torch.isfinite(vals)).sum())
    del lm, opt, step_fn, base
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    run.checks = judge.training(run, prog)
    run.check_s = time.perf_counter() - t
    return run
