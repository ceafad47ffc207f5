"""The library yardstick of the port's capped and windowed attention rows:
PyTorch's ``flex_attention`` under ``torch.compile``, with a tanh
``score_mod`` (Gemma 2's logit soft cap) or a sliding-window block mask,
beside the hand-written kernels, on one NVIDIA card.  SDPA has no soft
cap, and under a boolean window mask it computes every (query, key) pair;
flex_attention is the one PyTorch call that computes the capped function
and the windowed one skipping the masked tiles.  It is timed here and used
nowhere in the port.

    python3 scripts/softcap_library.py

Rows (the shapes of PERF.md's 3-cap, 3-bwd-cap and 4-cap rows, bf16, cap
50): the causal prefill of granite-3-2b's heads (B 1, H 32 over KV 8,
S 2048, D 64), its backward at B 4, and a decode step over the 4-slot
pool [4, 2112, 8, 64] at lengths 1/300/1000/2112; then rows 3-bwd-256 and
3-bwd-256' uncapped: recurrentgemma-2b's attention backward (H 10 over KV
1, D 256, causal under the window of 2048) at B 2, S 4096 and at B 4,
S 2048.  Each row prints the kernel's and the compiled flex call's
CUDA-event and device ms per call, flex's compile seconds, and flex's
largest error against the plain version; a flex call that does not build
prints why (at D = 256 it is retried with smaller tiles).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

CAP = 50.0


def main() -> int:
    if not torch.cuda.is_available():
        print("softcap_library: no CUDA device available", file=sys.stderr)
        return 1
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build_all()
    gen = torch.Generator().manual_seed(29)

    def score_mod(score, b, h, q_idx, kv_idx):
        return CAP * torch.tanh(score / CAP)

    def row(what, kernel, library, want, iters=50):
        t0 = time.perf_counter()
        try:
            got = library()
            torch.cuda.synchronize()
        except Exception as e:   # the yardstick may not build on this card
            print(f"  {what}: kernel {cs.time_ms(kernel, iters):.4f} ms "
                  f"(device {cs.device_profile(kernel)[0]:.4f}); flex did "
                  f"not build: {type(e).__name__}: {str(e)[:300]}")
            return False
        compile_s = time.perf_counter() - t0
        err = max(cs.max_abs_err(g, w) for g, w in zip(got, want))
        print(f"  {what}: kernel {cs.time_ms(kernel, iters):.4f} ms (device "
              f"{cs.device_profile(kernel)[0]:.4f})  flex "
              f"{cs.time_ms(library, iters):.4f} ms (device "
              f"{cs.device_profile(library)[0]:.4f}); flex's first call "
              f"{compile_s:.1f} s, its largest error {err:.3e} against the "
              f"plain version")
        return True

    # the backward is timed by calling autograd.grad on one graph again
    # and again, which donated buffers forbid
    import torch._functorch.config as functorch_config
    functorch_config.donated_buffer = False
    flex = torch.compile(flex_attention)
    b, h, kv, s, d = cs.FLASH_MAIN
    q, k, v, rep = cs.flash_inputs(gen, s, torch.bfloat16)
    q4, k4, v4 = (x.reshape(b, -1, s, d) for x in (q, k, v))
    causal = create_block_mask(lambda b, h, qi, ki: qi >= ki, None, None, s,
                               s, device="cuda")
    row(f"3-cap: flash S={s} D={d} causal bf16 cap {CAP:g}",
        lambda: ops.flash_attention(q, k, v, kv_group=rep, softcap=CAP),
        lambda: (flex(q4, k4, v4, score_mod=score_mod, block_mask=causal,
                      enable_gqa=True),),
        (ref.mha_ref(q, k, v, kv_group=rep, softcap=CAP).reshape(q4.shape),))

    bt, s = cs.TRAIN_SHAPE
    q, k, v, do = cs.bwd_inputs(gen, h, kv, s, s, d, torch.bfloat16, b=bt)
    o, lse = ops.flash_attention_lse(q, k, v, kv_group=rep, softcap=CAP)
    leaves = [x.detach().reshape(bt, -1, s, d).requires_grad_()
              for x in (q, k, v)]
    out4 = flex(*leaves, score_mod=score_mod, block_mask=causal,
                enable_gqa=True)
    do4 = do.reshape(bt, h, s, d)
    want = ref.mha_backward_ref(q, k, v, o, do, lse, kv_group=rep,
                                softcap=CAP)
    row(f"3-bwd-cap: flash backward B={bt} S={s} D={d} causal bf16 cap "
        f"{CAP:g}",
        lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, kv_group=rep,
                                        softcap=CAP),
        lambda: torch.autograd.grad(out4, leaves, do4, retain_graph=True),
        [w.reshape(g.shape) for w, g in zip(want, leaves)], iters=20)
    del leaves, out4, want
    cs.free_card()

    b, h, kv, s, d = cs.DECODE_MAIN
    q, kc, vc, lens = cs.decode_inputs(gen, torch.bfloat16, b, h, kv, s, d,
                                       cs.DECODE_MAIN_LENS)
    q4 = q[:, :, None, :]
    k4, v4 = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    valid = create_block_mask(lambda b, h, qi, ki: ki < lens[b], b, None, 1,
                              s, device="cuda")
    row(f"4-cap: decode [4,{s},{kv},{d}] bf16 cap {CAP:g}",
        lambda: ops.decode_attention(q, kc, vc, lens, softcap=CAP),
        lambda: (flex(q4, k4, v4, score_mod=score_mod, block_mask=valid,
                      enable_gqa=True),),
        (ref.decode_attention_ref(q, kc, vc, lens, softcap=CAP)[:, :, None],),
        iters=200)
    cs.free_card()

    _, h, kv, s_rg, d = cs.GRIFFIN_FLASH
    win = cs.GRIFFIN_WINDOW
    for name, bt, s in (("3-bwd-256", 2, s_rg), ("3-bwd-256'", 4, s_rg // 2)):
        q, k, v, do = cs.bwd_inputs(gen, h, kv, s, s, d, torch.bfloat16,
                                    b=bt)
        kw = dict(kv_group=h // kv, window=win)
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
        want = ref.mha_backward_ref(q, k, v, o, do, lse, **kw)
        window = create_block_mask(
            lambda b, h, qi, ki: (qi >= ki) & (qi - ki < win), None, None,
            s, s, device="cuda")
        do4 = do.reshape(bt, h, s, d)
        for opts in (None, {"BLOCK_M1": 32, "BLOCK_N1": 64,
                            "BLOCK_M2": 64, "BLOCK_N2": 32}):
            leaves = [x.detach().reshape(bt, -1, s, d).requires_grad_()
                      for x in (q, k, v)]
            try:
                out4 = flex(*leaves, block_mask=window, enable_gqa=True,
                            kernel_options=opts)
            except Exception as e:
                print(f"  {name}: flex's forward did not build "
                      f"(kernel_options {opts}): {type(e).__name__}: "
                      f"{str(e)[:300]}")
                continue
            if row(f"{name}: flash backward B={bt} H={h} KV={kv} S={s} "
                   f"D={d} causal window {win} bf16 (flex: sliding-window "
                   f"block mask, kernel_options {opts})",
                   lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, **kw),
                   lambda: torch.autograd.grad(out4, leaves, do4,
                                               retain_graph=True),
                   [w.reshape(g.shape) for w, g in zip(want, leaves)],
                   iters=20):
                break
        del leaves, want
        cs.free_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
