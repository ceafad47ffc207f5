"""Serving example: continuous-batching greedy decode across architectures,
the attention-free and hybrid families included, on the card.  Each arch
runs through ``repro_torch.serve.ContinuousBatcher`` (a slot pool, its
decode step captured once in a CUDA graph and replayed every tick;
requests join and leave at decode-step granularity); ``--trace N``
replays a synthetic open-loop arrival trace instead of one gang batch.
The counterpart of ``examples/serve_lm.py``, with its flags and ``--device``.

    PYTHONPATH=src python -m repro_torch.serve_lm [--arch mamba2-1.3b]
    PYTHONPATH=src python -m repro_torch.serve_lm --trace 6 [--device cpu]
"""
from __future__ import annotations

import argparse

TRIO = ("granite-3-2b", "mamba2-1.3b", "recurrentgemma-2b")


def main(argv=None) -> dict:
    """Serve each arch in turn through ``launch.serve.main``; returns
    {arch: its requests' tokens}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="one arch id; default: a representative trio")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--trace", type=int, default=0,
                    help="serve N staggered arrivals (open-loop trace)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.launch.serve import main as serve_main

    out = {}
    for arch in [args.arch] if args.arch else TRIO:
        flags = ["--arch", arch, "--batch", str(args.batch),
                 "--prompt-len", "32", "--gen", str(args.gen)]
        if args.trace:
            flags += ["--trace", str(args.trace)]
        if args.device:
            flags += ["--device", args.device]
        out[arch] = serve_main(flags)
    return out


if __name__ == "__main__":
    main()
