"""The captured decode step of the serving cells whose decode attention
groups query heads over KV heads (``chip_smoke.py``'s (c) h2o-danube, (d)
nemotron, (e) command-r-plus, (h) arctic, (j) recurrentgemma and (k)
llama-3.2-vision, at that script's depths, prompts and cache lengths), on
one NVIDIA card: each cell serves its 8 requests through the engine, then
its step is replayed from the CUDA graph and timed (host clock, and device
time from torch.profiler), and the decode-attention kernels' share of the
step's device time is summed from the same trace.  Run it from the root of
a checkout; copied into another checkout's root it times that checkout's
kernels, so two checkouts compare on one card (run them in turns).

    python3 scripts/decode_steps.py
"""
from __future__ import annotations

import gc
import os
import sys

ROOT = os.getcwd()
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CELLS = ("c", "d", "e", "h", "j", "k")


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_steps: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    print(f"  {cs.nvidia_smi_line()}  ({ROOT})")
    _build.build_all()
    table = {}
    for label, arch, n, prompts, cache_len, _ in cs.FAMILY_CELLS:
        table[label] = (arch, n, prompts, cache_len)
    for label, arch, n, _ in cs.MOE_CELLS:
        table[label] = (arch, n, cs.SERVE_PROMPTS, cs.SERVE_CACHE_LEN)
    for label, arch, n, prompts, cache_len in cs.RECURRENT_CELLS:
        table[label] = (arch, n, prompts, cache_len)
    for label, arch, n, _, _ in cs.CROSS_CELLS:
        table[label] = (arch, n, cs.SERVE_PROMPTS, cs.SERVE_CACHE_LEN)
    for label in CELLS:
        arch, n, prompts, cache_len = table[label]
        cfg, cut = cs.cut_depth(get_config(arch), n)
        lm = cs.watched_lm(cfg, 2)
        reqs = cs.serve_trace(cfg, (cs.SERVE_MAX_GEN,) * len(cs.SERVE_GENS),
                              seed=1, prompts=prompts)
        engine, _, _, launches = cs.serve_engine(ops, lm, reqs, label,
                                                 cache_len=cache_len)
        wall, dev = cs.step_times(engine, lm, prompts, label,
                                  eager_too=False)
        step_dev, kernels, _ = cs.device_profile(engine._step, 5)
        decode = [(name, ms) for name, ms in kernels if "decode_" in name]
        print(f"  ({label}) {arch}, {cut}: step {wall:.3f} ms wall, "
              f"{dev:.3f} ms device, idle {1 - dev / wall:.1%}; decode "
              f"attention {sum(ms for _, ms in decode):.4f} ms device a step "
              f"({', '.join(f'{nm[:40]} {ms:.4f}' for nm, ms in decode)}); "
              f"{launches['decode_attention']} decode launches in the run")
        del engine, lm
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
