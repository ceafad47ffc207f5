"""Serving driver: continuous-batching engine over one model replica; the
port of ``repro.launch.serve``.

``generate`` is the sequential batch reference (prefill + greedy decode in
lock-step); the CLI routes through
:class:`repro_torch.serve.ContinuousBatcher`, where requests join and leave
the running batch at decode-step granularity and the KV slot pool persists
across requests.  The weights are random, drawn from a seeded generator.
``--arch`` takes any config (granite-3-2b, h2o-danube-1.8b,
nemotron-4-15b, command-r-plus-104b, moonshot-v1-16b-a3b, arctic-480b,
mamba2-1.3b, recurrentgemma-2b, llama-3.2-vision-90b, seamless-m4t-medium;
at ``--full`` command-r-plus-104b's 208 GB, arctic-480b's 952 GB and
llama-3.2-vision-90b's 175 GB of bf16 are past one 80 GB card,
moonshot-v1-16b-a3b's 58 GB, mamba2-1.3b's 2.7 GB, recurrentgemma-2b's
5.4 GB and seamless-m4t-medium's 2 GB fit).  A VLM or audio request
carries its own context, as the JAX launcher's ``_request_extras`` makes
it: seeded normal image embeddings ``[1, n_img_tokens, d_model]`` or
audio frames ``[1, n_frames, d_model]`` (the reference's stub
frontends).  The engine routes each slot through the
MoE on its own, as the JAX engine does; ``generate`` routes its batch
jointly, as the JAX ``generate`` does.  mamba2-1.3b's prompt length must be
a multiple of its SSD chunk (256 at ``--full``) or shorter than one, as the
JAX model requires.  Runs on the card unless ``--device`` names another:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --batch 4 --prompt-len 32 --gen 16
  # full width on the card, open-loop synthetic trace with staggered
  # arrivals:
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8 \\
      --arch h2o-danube-1.8b --prompt-len 5000 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8 \\
      --arch moonshot-v1-16b-a3b --prompt-len 1000 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8 \\
      --arch mamba2-1.3b --prompt-len 1024 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8 \\
      --arch recurrentgemma-2b --prompt-len 4096 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --full --trace 8 \\
      --arch seamless-m4t-medium --prompt-len 1000 --gen 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def generate(model, batch, prompt_len: int, gen: int, cache_len: int):
    """Greedy decode ``gen`` tokens after prefilling ``batch['tokens']``
    [B, prompt_len] (with ``batch``'s context, for a VLM or audio model);
    returns the tokens [B, gen] (int64, on the model's device).

    The sequential reference the continuous engine's parity test compares
    against: whole batch prefilled together, decoded in lock-step."""
    logits, cache = model.prefill(batch, cache_len)
    tok = logits.argmax(dim=-1)[:, None]
    toks = [tok]
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, tok, prompt_len + i)
        tok = logits.argmax(dim=-1)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)


def request_extras(cfg, seed: int, i: int) -> dict:
    """The modality context of request ``i`` (VLM: ``img_embed``, audio:
    ``frames``; nothing for the other families): float32 normal numpy
    ``[1, S_ctx, d_model]`` drawn from ``(seed, i)``, the stub frontend of
    the JAX launcher's ``_request_extras`` (whose values come from
    ``jax.random`` and differ)."""
    n = {"vlm": cfg.n_img_tokens, "audio": cfg.n_frames}.get(cfg.family)
    if n is None:
        return {}
    ctx = np.random.default_rng([seed, i]).standard_normal(
        (1, n, cfg.d_model), dtype=np.float32)
    return {"img_embed" if cfg.family == "vlm" else "frames": ctx}


def synthetic_trace(cfg, n: int, prompt_len: int, gen: int, *,
                    gap_s: float = 0.02, seed: int = 1):
    """Open-loop arrival trace: ``n`` requests arriving ``gap_s`` apart
    (staggered — the shape continuous batching wins on), each with its own
    context (:func:`request_extras`) where the family takes one."""
    from repro_torch.serve import Request
    return [Request(rid=f"r{i}", arch=cfg.name, prompt_len=prompt_len,
                    max_gen=gen, arrival_s=i * gap_s,
                    extras=request_extras(cfg, seed, i)) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch at its published width and depth")
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-pool width (concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="serve a synthetic open-loop trace of N staggered "
                         "arrivals instead of one gang batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve
    from repro_torch.models.lm import LM, init_params
    from repro_torch.power import envelope_for
    from repro_torch.serve import ContinuousBatcher, Request

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.ssm is not None and args.prompt_len % min(cfg.ssm.chunk,
                                                     args.prompt_len):
        ap.error(f"{cfg.name} takes a prompt length that is a multiple of "
                 f"its SSD chunk {cfg.ssm.chunk} or shorter than it, got "
                 f"{args.prompt_len}")
    gen = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, init_params(cfg, gen, dev))

    cache_len = args.prompt_len + args.gen
    engine = ContinuousBatcher(model, n_slots=args.batch,
                               cache_len=cache_len,
                               envelope=envelope_for(None))
    if args.trace:
        reqs = synthetic_trace(cfg, args.trace, args.prompt_len, args.gen)
    else:
        reqs = [Request(rid=f"r{i}", arch=cfg.name,
                        prompt_len=args.prompt_len, max_gen=args.gen,
                        extras=request_extras(cfg, 1, i))
                for i in range(args.batch)]

    t0 = time.perf_counter()
    out = engine.run(reqs)
    dt = time.perf_counter() - t0
    s = engine.metrics.summary()
    n_tok = sum(len(v) for v in out.values())
    print(f"arch={cfg.name} on {dev} served {len(out)} requests, {n_tok} "
          f"tokens in {dt:.2f}s wall ({n_tok / dt:.1f} tok/s incl. kernel "
          f"builds); ttft_p50={s['ttft_p50_s']}s calls={engine.calls}")
    first = sorted(out)[0]
    print("sample tokens:", out[first][:12].tolist())
    return out


if __name__ == "__main__":
    main()
