"""End-to-end training driver: a small LM for a few hundred steps through
the full stack (the train step with the flash backward kernel on the card,
deterministic data, the fault-tolerant checkpointed loop, its watchdog).
The counterpart of ``examples/train_lm.py``, with its flags and
``--device``.

    PYTHONPATH=src python -m repro_torch.train_lm [--device cpu]
    PYTHONPATH=src python -m repro_torch.train_lm --steps 300 --wide

``--wide`` registers the reference's ~100M-parameter widening of the
reduced config (d_model 768, 12 layers, 12 heads over 4 KV heads,
head dim 64, d_ff 3072, a 32k vocabulary) as ``<arch>-100m`` in
``repro_torch.configs.ARCHS`` and trains it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile


def wide_config(arch: str):
    """The reference's ~100M-parameter config: the reduced ``arch``
    widened by ``dataclasses.replace``, registered in ``ARCHS``."""
    from repro_torch.configs import ARCHS, get_config
    cfg = dataclasses.replace(
        get_config(arch).reduced(), d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=4, d_head=64, d_ff=3072, vocab_size=32000,
        name=arch + "-100m")
    ARCHS[cfg.name] = cfg
    return cfg


def main(argv=None):
    """Train through ``launch.train.main``; returns its
    ``ResilientLoopResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--wide", action="store_true",
                    help="~100M params instead of the CPU-sized default")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    from repro_torch.launch.train import main as train_main

    argv = ["--arch", args.arch, "--reduced", "--steps", str(args.steps),
            "--batch", "8", "--seq", "128", "--ckpt-dir", args.ckpt_dir,
            "--save-every", "50", "--log-every", "20",
            "--device", args.device]
    if args.wide:
        cfg = wide_config(args.arch)
        argv[1] = cfg.name
        argv.remove("--reduced")
        print(f"wide config: ~{cfg.n_params() / 1e6:.0f}M params")
    res = train_main(argv)
    losses = [h["loss"] for h in res.metrics_history if "loss" in h]
    print(f"\nfinal: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps; restarts={res.restarts}")
    return res


if __name__ == "__main__":
    main()
