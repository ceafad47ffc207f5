"""recurrentgemma-2b's bf16 training step (``chip_smoke.py`` phase 13 (d):
all 26 layers, B 2, S 4096, block remat, vocab_chunk 2048, AdamW) on one
NVIDIA card: a warm-up step and STEPS timed steps (host clock around a
synchronised step), then one step traced by torch.profiler for its device
time and the flash backward's share of it (its three kernels a call,
summed by name), beside the flash forward's.  Run it from the root of a
checkout; copied into another checkout's root it times that checkout's
kernels (it imports only helpers every ``chip_smoke.py`` since the
training phase has), so two checkouts compare on one card (run them in
turns).

    python3 scripts/train_steps.py
"""
from __future__ import annotations

import os
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

ARCH = "recurrentgemma-2b"
SHAPE = (2, 4096)           # B, S: chip_smoke.py's TRAIN_RG_SHAPE
STEPS = 3
SEED = 7
BWD_KERNELS = ("bwd_prep_kernel", "bwd_dkdv_", "bwd_dq_")


def main() -> int:
    if not torch.cuda.is_available():
        print("train_steps: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.kernels import _build, ops
    from repro_torch.train import optimizer, train_step
    print(f"  {cs.nvidia_smi_line()}  ({ROOT})")
    _build.build_all(["flash_attention", "flash_attention_bwd"])
    cfg = get_config(ARCH)
    b, s = SHAPE
    lm = cs.watched_lm(cfg, SEED, Plan(remat="block",
                                       vocab_chunk=cs.TRAIN_VOCAB_CHUNK))
    tcfg = TrainConfig(lr=cs.TRAIN_LR, warmup_steps=1,
                       total_steps=STEPS + 2)
    step_fn = train_step.make_train_step(lm, tcfg)
    opt = optimizer.init(lm.params(), tcfg)
    batches = [cs.train_batch(cfg, b, s, i) for i in range(STEPS + 2)]
    walls, losses = [], []
    for i, batch in enumerate(batches[:STEPS + 1]):
        if i == 1:
            ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt, metrics = step_fn(lm.params(), opt, batch, i)
        losses.append(metrics["loss"].item())
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v / STEPS for k, v in ops.launch_counts().items() if v}

    def step():
        step_fn(lm.params(), opt, batches[-1], STEPS + 1)
    _, traced = cs.traced_kernels(step, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    traced = [(n, ms) for n, ms in traced if not n.startswith("train.")]
    total = sum(ms for _, ms in traced)
    bwd = {}
    for n, ms in traced:
        if any(k in n for k in BWD_KERNELS):
            bwd[n] = bwd.get(n, 0.0) + ms
    fwd = sum(ms for n, ms in traced if "flash_bf16_kernel" in n)
    wall = sum(walls[1:]) / STEPS
    print(f"  {ARCH}, {cfg.n_layers} layers, bf16, B={b} S={s}: losses "
          f"{[round(x, 4) for x in losses]}; step wall {wall:.1f} ms (each "
          f"{[round(w, 1) for w in walls[1:]]}), device {total:.1f} ms (the "
          f"profiled step); flash backward {sum(bwd.values()):.2f} ms "
          f"({sum(bwd.values()) / total:.1%} of the step), flash forward "
          f"{fwd:.2f} ms; launches a step {launches}")
    for n, ms in sorted(bwd.items(), key=lambda kv: -kv[1]):
        print(f"      {ms:9.3f}  {n[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
