"""Deterministic synthetic token pipeline: the port of
``repro.data.pipeline``.

A batch is a pure function of (seed, step): its random draws come from a
``torch.Generator`` seeded with both, so checkpoint and resume need only
the step counter.  The tokens follow the reference's noisy affine
recurrence, token_{t+1} = (31 token_t + 17 + eps) mod V, eps a random
token with probability ``noise`` (else 0), so a model has structure to
learn and its loss falls; the VLM's and the audio family's contexts are
the reference's stubs (standard normal image embeddings and frames).  The
draws are not ``jax.random``'s, so the two packages' batches differ;
parity tests hand both the JAX batch through numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.device import DeviceLike, resolve


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05
    # modality stubs
    n_img_tokens: int = 0
    n_frames: int = 0
    d_model: int = 0


class SyntheticTokens:
    """Stateless-by-construction LM data pipeline: batches are drawn on the
    CPU and handed over on ``device`` (default ``cuda``)."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve(device)

    def _generator(self, step: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.cfg.seed * 1_000_003 + int(step)) % (2 ** 63))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} int64 [B, S] (and "img_embed" or "frames"
        fp32 [B, n, d_model] where the config has them) on the device."""
        cfg = self.cfg
        gen = self._generator(step)
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        tok = torch.randint(0, v, (b,), generator=gen)
        hit = torch.rand((s, b), generator=gen) < cfg.noise
        eps = hit.long() * torch.randint(0, v, (s, b), generator=gen)
        toks = torch.empty((b, s), dtype=torch.long)
        for t in range(s):
            tok = (31 * tok + 17 + eps[t]) % v
            toks[:, t] = tok
        if s > 1:       # next-token pairs, a zero pad keeping length S
            tokens = torch.cat([toks[:, :-1], toks.new_zeros((b, 1))], 1)
            labels = torch.cat([toks[:, 1:], toks.new_zeros((b, 1))], 1)
        else:
            tokens = labels = toks
        out = {"tokens": tokens, "labels": labels}
        if cfg.n_img_tokens:
            out["img_embed"] = torch.randn(
                (b, cfg.n_img_tokens, cfg.d_model), generator=gen)
        if cfg.n_frames:
            out["frames"] = torch.randn((b, cfg.n_frames, cfg.d_model),
                                        generator=gen)
        return {k: x.to(self.device) for k, x in out.items()}

    # --- checkpointable state ---
    def state_dict(self, step: int) -> dict:
        return {"step": int(step), "seed": self.cfg.seed}

    @staticmethod
    def resume_step(state: dict) -> int:
        return int(state["step"])


def data_config_for(cfg, shape, seed=0) -> DataConfig:
    return DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        n_img_tokens=cfg.n_img_tokens if cfg.family == "vlm" else 0,
        n_frames=cfg.n_frames if cfg.family == "audio" else 0,
        d_model=cfg.d_model)
