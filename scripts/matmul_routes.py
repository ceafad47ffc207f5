"""The bf16 matmul's routes side by side on one NVIDIA card: each route of
``csrc/matmul.cu`` ("small" and "wide", wgmma over a TMA ring at 64 x 64
and 128 x 256 tiles; "unaligned", wgmma over stages
filled from registers, which takes any operands) forced through the C
entry at 3mm's 512^3, at 2048^3, at granite-3-2b's MLP up-projection
``[8192, 2048] @ [2048, 8192]`` (B 4 x S 2048 tokens, d_model 2048, d_ff
8192) and at 513 x 1001 x 511 (which only the unaligned route takes),
each held to the plain version at 2e-2 (as ``chip_smoke.py`` phase 3
holds the kernel) and to its own bits on a second call, then timed
beside ``torch.matmul`` and the bound.  ``kernels/matmul.py``'s
``bf16_plan`` picks among the routes by these numbers.  It also prints
the matmul library's ``-Xptxas -v`` report and its HGMMA count.

    python3 scripts/matmul_routes.py
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SHAPES = ((512, 512, 512), (2048, 2048, 2048), (8192, 2048, 8192),
          (513, 1001, 511))                          # (M, K, N)


def main() -> int:
    if not torch.cuda.is_available():
        print("matmul_routes: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import matmul as mm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    logs = _build.build_all(["matmul"])
    print(logs["matmul"])
    print(f"matmul SASS: {cs.count_sass(_build, 'matmul', 'HGMMA')} HGMMA, "
          f"{cs.count_sass(_build, 'matmul', 'LDGSTS')} LDGSTS")
    lib = mm._lib()
    gen = torch.Generator().manual_seed(30)

    def forced(route, a, b):
        m, k = a.shape
        n = b.shape[1]
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        err = lib.repro_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                               m, n, k, 1, mm.BF16_ROUTES[route].code,
                               torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, f"matmul ({route})")
        return out

    ok = True
    for m, k, n in SHAPES:
        a = cs.randn(gen, m, k, dtype=torch.bfloat16)
        b = cs.randn(gen, k, n, dtype=torch.bfloat16)
        want = ref.matmul_ref(a, b)
        t_bound, by = cs.bound(*mm.work(m, n, k, itemsize=2),
                               cs.BF16_PEAK_FLOPS)
        lib_ms = cs.time_ms(lambda: torch.matmul(a, b), 50)
        lib_dev = cs.device_profile(lambda: torch.matmul(a, b))[0]
        print(f"{m}x{k}x{n} bf16: bound {t_bound:.5f} ms ({by}); "
              f"torch.matmul {lib_ms:.4f} ms (device {lib_dev:.4f}); "
              f"the plan's route {mm.bf16_plan(m, n, k).route}")
        for route in mm.BF16_ROUTES:
            if route != "unaligned" and not mm.bf16_mappable(n, k):
                continue
            got = forced(route, a, b)
            again = forced(route, a, b)
            torch.cuda.synchronize()
            err = cs.max_abs_err(got, want)
            close = torch.allclose(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
            same = torch.equal(got.view(torch.int16), again.view(torch.int16))
            ok &= close and same
            ms = cs.time_ms(lambda: forced(route, a, b), 100)
            dev = cs.device_profile(lambda: forced(route, a, b))[0]
            print(f"  {route:9s} max_abs_err {err:.3e} "
                  f"{'ok' if close else 'MISMATCH'}, repeat "
                  f"{'bitwise' if same else 'DIFFERS'}; {ms:.4f} ms "
                  f"(device {dev:.4f}), {t_bound / dev:.1%} of the bound, "
                  f"{dev / lib_dev:.2f}x torch.matmul")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
