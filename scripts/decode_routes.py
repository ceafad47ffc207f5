"""The bf16 decode kernel's two routes side by side on one NVIDIA card:
the tensor-core route (``"hmma"``: the group's rows share each K/V tile in
one ``mma.sync``) and the CUDA-core kernel (``"lanes"``), each forced
through the C entry of ``csrc/decode_attention.cu`` at the serving rows of
PERF.md (rows 4-4k: the pools and lengths of ``chip_smoke.py``'s phase 4)
and at groups 2-4 of the main pool at D = 64 and 128, where the CUDA-core
kernel still holds the group in one row pass; then the tensor-core route
at recurrentgemma's ring (row 4g) at 4 to 64 splits, and at every
grouped row with the grid sized for 0.5 to 2.5 waves of the SMs (splits
of at least 256 keys).  Each launch is
held to the plain version (the bf16 limits of ``kernels/parity.py``) and
to its own bits on a second call, then timed (CUDA events, and profiler
device time) over four cache pairs in turn, so each call finds its cache
cold, beside masked SDPA and the bound (the valid rows' bytes).
``kernels/decode_attention.py``'s ``plan`` picks the route by these
numbers.  It also prints the decode library's ``-Xptxas -v`` lines for the
tensor-core kernels and its HMMA and LDGSTS counts.

    python3 scripts/decode_routes.py
"""
from __future__ import annotations

import itertools
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MAIN_LENS = (1, 300, 1000, 2112)
# (row, (B, H, KV, S, D), lengths): PERF.md's rows 4-4k
ROWS = (("4", (4, 32, 8, 2112, 64), MAIN_LENS),
        ("4'", (4, 32, 8, 2112, 64), (2112,) * 4),
        ("4''", (4, 32, 8, 4096, 80), (1, 1000, 4096, 4096)),
        ("4'''", (4, 48, 8, 2112, 128), MAIN_LENS),
        ("4''''", (4, 96, 8, 2112, 128), MAIN_LENS),
        ("4e", (4, 56, 8, 2112, 128), MAIN_LENS),
        ("4f", (4, 16, 16, 2112, 128), MAIN_LENS),
        ("4g", (4, 10, 1, 2048, 256), (1, 1000, 2048, 2048)),
        ("4h", (4, 64, 8, 2112, 128), MAIN_LENS),
        ("4i", (4, 64, 8, 1024, 128), (1024,) * 4),
        ("4j", (4, 16, 16, 2112, 64), MAIN_LENS),
        ("4k", (4, 16, 16, 3072, 64), (3072,) * 4))
# the threshold's cases: groups the CUDA-core kernel holds in one pass
SMALL = tuple(("group", (4, 8 * rep, 8, 2112, d), MAIN_LENS)
              for d, reps in ((64, (2, 3, 4)), (128, (2,)), (80, (2,)))
              for rep in reps)
RING_SPLITS = (4, 6, 8, 16, 64)
# the tensor-core route's splits: the grid for these waves of the SMs
WAVES = (0.5, 0.75, 1.0, 2.5)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_routes: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, parity, ref
    from repro_torch.kernels import decode_attention as da
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log = _build.build_all(["decode_attention"])["decode_attention"]
    for name, regs, spill in cs.ptxas_kernels(log):
        if "mma" in name:
            print(f"  {name[name.index('decode_mma'):]}: {regs} registers, "
                  f"{spill} bytes spill")
    print(f"decode_attention SASS: "
          f"{cs.count_sass(_build, 'decode_attention', 'HMMA')} HMMA, "
          f"{cs.count_sass(_build, 'decode_attention', 'LDGSTS')} LDGSTS")
    lib = da._lib()
    gen = torch.Generator().manual_seed(31)
    dev = torch.device("cuda")

    # scratch as the wrapper keeps it: partials, and merge counters that
    # every launch leaves at zero
    part = torch.empty(1 << 24, dtype=torch.float32, device=dev)
    counters = torch.zeros(1 << 10, dtype=torch.int32, device=dev)

    def forced(p, q, kc, vc, ln):
        b, h, d = q.shape
        s_len, kvh = kc.shape[1], kc.shape[2]
        out = torch.empty_like(q)
        err = lib.repro_decode_attention(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ln.data_ptr(),
            out.data_ptr(), None, part.data_ptr(), counters.data_ptr(), b,
            h, kvh, s_len, d, p.chunk, p.n_splits, 1.0 / math.sqrt(d), 0.0,
            1, da.ROUTES[p.route], torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, f"decode_attention ({p.route})")
        return out

    ok = True

    def run(what, shape, lens, plans):
        nonlocal ok
        b, h, kvh, s_len, d = shape
        q, kc, vc, ln = cs.decode_inputs(gen, torch.bfloat16, *shape, lens)
        caches = itertools.cycle(
            [(kc, vc)] + [cs.decode_inputs(gen, torch.bfloat16, *shape,
                                           lens)[1:3] for _ in range(3)])
        mask = (torch.arange(s_len, device=dev)[None, :]
                < ln[:, None])[:, None, None, :]

        def sdpa():
            k, v = next(caches)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        valid = sum(min(n, s_len) for n in lens)
        t_bound, by = cs.bound(*da.work(b, h, kvh, d, valid),
                               cs.BF16_PEAK_FLOPS)
        lib_dev = cs.device_profile(sdpa)[0]
        print(f"{what} {list(shape)} lens {list(lens)}: bound "
              f"{t_bound:.4f} ms ({by}); masked SDPA "
              f"{cs.time_ms(sdpa, 200):.4f} ms (device {lib_dev:.4f}); plan "
              f"{da.plan(b, h, kvh, s_len, d, torch.bfloat16)}")
        want = ref.decode_attention_ref(q, kc, vc, ln)
        want32 = parity.decode_want32(q, kc, vc, ln)
        for i, p in enumerate(plans):
            part.fill_(float("nan"))    # a partial never written shows
            try:
                got = forced(p, q, kc, vc, ln)
            except RuntimeError as e:   # an instantiation no call takes
                print(f"  {p}: not launched ({e})")
                ok &= i > 0             # the plan's own route must launch
                continue
            again = forced(p, q, kc, vc, ln)
            torch.cuda.synchronize()
            good, err, rerr = parity.within_decode_limits(got, want, want32)
            same = torch.equal(got, again)
            ok &= good and same
            live = da.live_blocks(p, lens, kvh)

            def call():
                k, v = next(caches)
                return forced(p, q, k, v, ln)
            ms, t_dev = cs.time_ms(call, 200), cs.device_profile(call)[0]
            print(f"  {p.route:5s} chunk {p.chunk:4d} x {p.n_splits:3d} "
                  f"({live} live): max_abs_err {err:.3e} row_err "
                  f"{rerr:.3e} {'ok' if good else 'MISMATCH'}, repeat "
                  f"{'bitwise' if same else 'DIFFERS'}; {ms:.4f} ms (device "
                  f"{t_dev:.4f}), {t_bound / t_dev:.1%} of the bound, "
                  f"{t_dev / lib_dev:.2f}x masked SDPA")

    for what, shape, lens in ROWS:
        b, h, kvh, s_len, d = shape
        if not 1 < h // kvh <= da.hmma_group(d):
            continue
        run(f"row {what}, waves {WAVES}", shape, lens,
            [da.DecodePlan(*da.hmma_splits(b * kvh, s_len, h // kvh * d, w),
                           "hmma") for w in WAVES])
    for what, shape, lens in ROWS + SMALL:
        b, h, kvh, s_len, d = shape
        p = da.plan(b, h, kvh, s_len, d, torch.bfloat16)
        # the other route at its own splits (the CUDA-core kernel's merge
        # cap: MERGE_LOADS)
        width = h // kvh * d
        plans = [p, da.DecodePlan(*da.splits(
            b * kvh, s_len, width, da.KEY_TILE[torch.bfloat16],
            da.MERGE_LOADS), "lanes") if p.route == "hmma" else
            da.DecodePlan(*da.hmma_splits(b * kvh, s_len, width), "hmma")]
        if h // kvh > da.hmma_group(d):
            plans.pop()
        run(f"row {what}", shape, lens, plans)
    shape, lens = ROWS[7][1], ROWS[7][2]
    ring = [da.DecodePlan(16 * -(-shape[3] // (16 * n)), n, "hmma")
            for n in RING_SPLITS]
    run("row 4g's ring, splits", shape, lens, ring)
    print("decode_routes:", "ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
