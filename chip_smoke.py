#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels itself.  Phases,
each printing its seconds:

  1. card      the card's name and power limit (nvidia-smi) and the two TF32
               flags, both off;
  2. build     one nvcc per ``src/repro_torch/csrc/*.cu``, all started
               together, with each kernel's ``-Xptxas -v`` report;
  3. check     every kernel against its plain PyTorch version on the card: the
               JAX tests' shapes at their tolerances, the main-path shapes,
               and a K and an N that are not multiples of the tile;
  4. time      each kernel, its plain version and the library call at the
               main-path shapes (CUDA events over many launches after a
               warm-up), beside the least time the card could take;
  5. plan      the port's planner (``repro_torch.quickstart`` settings) over
               3mm, tdFIR and NAS.BT at the paper's sizes, with the launch
               counters set to 0 just before and read just after.

It then prints one JSON line of per-kernel numbers, the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failure ends the script with a traceback and a non-zero exit; without a
CUDA device it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
FP32_PEAK_FLOPS = 67e12          # non-tensor fp32
HBM_BYTES_PER_S = 3.35e12

MATMUL_MAIN = (512, 512, 512)              # 3mm at N=512, fp32
TDFIR_MAIN = (64, 4096, 128)               # F, N, K of the paper's tdFIR
TDFIR_MAIN_BLOCK_N = 128                   # the app's max(128, K)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextmanager
def phase(name: str):
    print(f"\n--- phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"--- phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(
        "cuda", dtype)


def max_abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(what: str, got, want, tol: float) -> float:
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    print(f"  {what:48s} max_abs_err {err:.3e}  tol {tol:g}  "
          f"{'ok' if ok else 'MISMATCH'}")
    require(ok, f"{what}: kernel disagrees with its plain version")
    return err


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call over ``iters`` calls after a warm-up."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    """Least time (ms) for the work, and which term sets it."""
    t_ops = flops / FP32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_kernels(ops, ref):
    """Phase 3: returns the main-path max errors."""
    gen = torch.Generator().manual_seed(0)
    errs = {}
    print(" matmul (JAX test shapes: fp32 at 1e-5, bf16 at 2e-2)")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for m, k, n in ((32, 32, 32), (100, 70, 130), (128, 256, 64),
                        (17, 19, 23)):
            a, b = randn(gen, m, k, dtype=dtype), randn(gen, k, n, dtype=dtype)
            check_close(f"matmul {m}x{k}x{n} {dtype}", ops.matmul(a, b),
                        ref.matmul_ref(a, b), tol)
    # fp32 sums of 512-1000 products in another order than cuBLAS: 1e-4
    print(" matmul (main path 512^3; ragged K=1000 and N=130 vs 64x64x16 "
          "tiles; fp32 at 1e-4 for the longer sums, bf16 at 2e-2)")
    m, k, n = MATMUL_MAIN
    a, b = randn(gen, m, k), randn(gen, k, n)
    errs["matmul"] = check_close("matmul 512^3 float32 (main path)",
                                 ops.matmul(a, b), ref.matmul_ref(a, b), 1e-4)
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    check_close("matmul 512^3 bfloat16", ops.matmul(a16, b16),
                ref.matmul_ref(a16, b16), 2e-2)
    a, b = randn(gen, 192, 1000), randn(gen, 1000, 130)
    check_close("matmul 192x1000x130 float32 (ragged K, N)",
                ops.matmul(a, b), ref.matmul_ref(a, b), 1e-4)

    print(" tdfir (JAX test shapes at 3e-4)")
    for f, nn, kk, bn in ((2, 128, 8, 32), (4, 300, 16, 64),
                          (8, 256, 32, 128), (1, 512, 4, 256)):
        x, h = randn(gen, f, nn), randn(gen, f, kk)
        check_close(f"tdfir F={f} N={nn} K={kk} block_n={bn}",
                    ops.tdfir(x, h, block_n=bn), ref.tdfir_ref(x, h), 3e-4)
    xr, xi = randn(gen, 2, 128), randn(gen, 2, 128)
    hr, hi = randn(gen, 2, 8), randn(gen, 2, 8)
    for part, got, want in zip(
            ("re", "im"), ops.tdfir_complex(xr, xi, hr, hi, block_n=64),
            ref.tdfir_complex_ref(xr, xi, hr, hi)):
        check_close(f"tdfir_complex F=2 N=128 K=8 ({part})", got, want, 3e-4)
    print(" tdfir (main path: complex 64x4096x128, block_n=128; ragged "
          "N=1000 with K=200 > tile)")
    f, nn, kk = TDFIR_MAIN
    xr, xi = randn(gen, f, nn), randn(gen, f, nn)
    hr, hi = randn(gen, f, kk) * 0.1, randn(gen, f, kk) * 0.1
    errs["tdfir"] = max(
        check_close(f"tdfir_complex 64x4096x128 ({part}, main path)", got,
                    want, 3e-4)
        for part, got, want in zip(
            ("re", "im"),
            ops.tdfir_complex(xr, xi, hr, hi, block_n=TDFIR_MAIN_BLOCK_N),
            ref.tdfir_complex_ref(xr, xi, hr, hi)))
    x, h = randn(gen, 4, 1000), randn(gen, 4, 200)
    check_close("tdfir F=4 N=1000 K=200 block_n=128 (ragged N)",
                ops.tdfir(x, h, block_n=128), ref.tdfir_ref(x, h), 3e-4)
    return errs


def time_kernels(ops, ref):
    """Phase 4: per-kernel times at the main-path shapes."""
    gen = torch.Generator().manual_seed(1)
    rows = {}
    m, k, n = MATMUL_MAIN
    a, b = randn(gen, m, k), randn(gen, k, n)
    t_bound, by = bound(2.0 * m * n * k, 4.0 * (m * k + k * n + m * n))
    rows["matmul"] = {
        "ms": time_ms(lambda: ops.matmul(a, b), 200),
        "plain_ms": time_ms(lambda: ref.matmul_ref(a, b), 200),
        "library_ms": time_ms(lambda: torch.matmul(a, b), 200),
        "bound_ms": t_bound, "bound_by": by}
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    print(f"  matmul 512^3 bfloat16: kernel "
          f"{time_ms(lambda: ops.matmul(a16, b16), 200):.4f} ms, "
          f"torch.matmul {time_ms(lambda: torch.matmul(a16, b16), 200):.4f}"
          f" ms")

    f, nn, kk = TDFIR_MAIN
    x, h = randn(gen, f, nn), randn(gen, f, kk) * 0.1
    w = h.flip(-1)[:, None, :]
    t_bound, by = bound(2.0 * f * nn * kk, 4.0 * (2 * f * nn + f * kk))
    rows["tdfir"] = {
        "ms": time_ms(lambda: ops.tdfir(x, h, block_n=TDFIR_MAIN_BLOCK_N),
                      200),
        "plain_ms": time_ms(lambda: ref.tdfir_ref(x, h), 20),
        "library_ms": time_ms(
            lambda: F.conv1d(x[None], w, padding=kk - 1, groups=f), 200),
        "bound_ms": t_bound, "bound_by": by}
    xi, hi = randn(gen, f, nn), randn(gen, f, kk) * 0.1
    t_complex = time_ms(lambda: ops.tdfir_complex(
        x, xi, h, hi, block_n=TDFIR_MAIN_BLOCK_N), 100)
    print(f"  tdfir_complex 64x4096x128 (4 launches + combine): "
          f"{t_complex:.4f} ms")
    for name, r in rows.items():
        print(f"  {name:7s} kernel {r['ms']:.4f} ms  bound {r['bound_ms']:.4f}"
              f" ms ({r['bound_by']})  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms")
    return rows


def run_planner(ops):
    """Phase 5: the port's main path; returns launches per kernel."""
    from repro_torch.core.planner import UserTarget
    from repro_torch.quickstart import print_report, run_app

    ops.reset_launch_counts()
    grew = {}
    for name in ("3mm", "tdFIR", "NAS.BT"):
        before = ops.launch_counts()
        t0 = time.perf_counter()
        report = run_app(name, UserTarget(), full=True, policy="host-time",
                         device="cuda")
        after = ops.launch_counts()
        print_report(name, report)
        print(f"  [{time.perf_counter() - t0:.1f} s, kernel launches "
              f"{ {k: after[k] - before[k] for k in after} }]", flush=True)
        grew[name] = {k: after[k] - before[k] for k in after}
        recs = report.records
        require(len(recs) == 6, f"{name}: {len(recs)} verifications, not 6")
        sel = report.selected
        require(sel is not None and sel.correct
                and sel.best_time_s < float("inf"),
                f"{name}: no correct destination selected")
        fpga_loop = [r for r in recs if r.paper_analogue == "FPGA"
                     and r.method == "loop"]
        require(len(fpga_loop) == 1 and fpga_loop[0].n_measurements <= 4,
                f"{name}: FPGA loop verification measured more than 4")
        if name == "NAS.BT":
            require(sel.choice.get("seidel_relax", "seq") not in ("dp", "tp"),
                    "NAS.BT: the wrong Jacobi smoother was selected")
    require(grew["3mm"]["matmul"] > 0, "3mm never launched the matmul kernel")
    require(grew["tdFIR"]["tdfir"] > 0, "tdFIR never launched the tdfir "
            "kernel")
    return ops.launch_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import device as port_device
    from repro_torch.kernels import _build, ops, ref

    with phase("1 card"):
        smi = nvidia_smi_line()
        port_device.resolve("cuda")
        print(f"  {smi}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
        print(f"  torch.backends.cuda.matmul.allow_tf32 = "
              f"{torch.backends.cuda.matmul.allow_tf32}")
        print(f"  torch.backends.cudnn.allow_tf32 = "
              f"{torch.backends.cudnn.allow_tf32}")
        require(not torch.backends.cuda.matmul.allow_tf32
                and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    with phase("2 build"):
        for name, log in _build.build_all().items():
            print(f"  [{name}] {_build.library_path(name).name}\n{log}")
    with phase("3 check"):
        errs = check_kernels(ops, ref)
    with phase("4 time"):
        times = time_kernels(ops, ref)
    with phase("5 plan"):
        launches = run_planner(ops)

    sources = {"matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:18"),
               "tdfir": ("src/repro_torch/csrc/tdfir.cu",
                         "src/repro/kernels/tdfir.py:21")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": errs[name], **times[name]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
