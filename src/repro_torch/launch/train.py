"""The end-to-end training command line: the port of ``repro.launch.train``.

The reference's flags, plus ``--device`` (default ``cuda``; without a card
it raises unless ``--device cpu`` is given): a seeded random-weight model,
the deterministic data pipeline, the train step through the backward
kernels, and the fault-tolerant checkpointed loop with its straggler
watchdog.  As the reference does, it builds a host mesh
(``launch.mesh.make_host_mesh``: the process group's ranks on one
``("data",)`` axis, a one-rank group started when none exists and
destroyed at the end) and runs the pod-parallel step when ``"pod"`` is
among its axes (the model, built with ``Rules`` on the mesh, is then
partitioned on each pod's ("data", "model") sub-mesh), else the plain
step: on a host mesh ``--pod-parallel`` falls back to the plain step.  ``--compress`` sets
``plan.grad_compression`` (int8 cross-pod gradients in the pod step).

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --steps 100 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--pod-parallel", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--remat", default="block",
                    choices=["none", "block", "full"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticTokens, data_config_for
    from repro_torch.device import resolve
    from repro_torch.dist.plan import Plan
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LM, init_params
    from repro_torch.runtime.fault_tolerance import run_resilient
    from repro_torch.train import optimizer, train_step as ts

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    plan = Plan(name="train-cli", remat=args.remat,
                microbatches=args.microbatches,
                grad_compression=args.compress,
                vocab_chunk=min(2048, args.seq))
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       microbatches=args.microbatches)
    data = SyntheticTokens(data_config_for(cfg, shape), device=dev)

    def seeded_params():
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        return init_params(cfg, gen, dev)

    started = not torch.distributed.is_initialized()
    try:
        mesh = make_host_mesh(dev)
        model = LM(cfg, seeded_params(), plan, Rules(mesh, plan))
        if args.pod_parallel and "pod" in mesh.mesh_dim_names:
            step_fn = ts.make_pod_parallel_train_step(model, tcfg, mesh)
        else:
            step_fn = ts.make_train_step(model, tcfg)
        ckpt = Checkpointer(args.ckpt_dir, keep=2)

        def init_state():
            params = model.load_params(seeded_params())
            return {"params": params, "opt": optimizer.init(params, tcfg)}

        def body(state, step):
            batch = data.batch(step)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(state["params"], state["opt"],
                                           batch, step)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={time.perf_counter()-t0:.3f}s", flush=True)
            return {"params": params, "opt": opt}, metrics

        res = run_resilient(total_steps=args.steps, checkpointer=ckpt,
                            init_state=init_state, step_fn=body,
                            save_every=args.save_every, device=dev)
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    losses = [h.get("loss") for h in res.metrics_history if "loss" in h]
    if losses:
        print(f"done: {res.last_step} steps, {res.restarts} restarts, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{len(res.watchdog.flagged)} straggler flags")
    return res


if __name__ == "__main__":
    main()
