"""The plain reference of the dense LM: PyTorch alone, fp32 with TF32 off,
one layer at a time.

It follows the port's equations as the configuration file states them
(``portbench/configs/<name>.json``): the embedding scaled by sqrt(d_model)
rounded to the served type, pre-norm layers (RMSNorm or LayerNorm, in
fp32, ``norm_eps``), rotary embeddings on the two halves of each head,
causal grouped-query attention with scores scaled by 1/sqrt(d_head), a
SwiGLU or squared-ReLU MLP, residual adds, a final norm and the logits over
the real vocabulary.  It imports nothing of the program and takes nothing
the program made: the weights come from ``portbench.weights.draw`` with the
run's seed.

Every matrix product goes through ``mm``: :func:`mm_fp32`, or
:func:`mm_fp8` (both operands rounded to float8 e4m3 with a scale per row
of the left operand and per column of the right one, the products
accumulated in fp32), the lower-precision control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

NEG = -1e30
FP8_MAX = 448.0      # float8 e4m3fn's largest finite value


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def mm_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()       # the gradient passes straight through


def mm_fp8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_fp8(x, -1), _fp8(w, -2))


def embed_scale(cfg: dict) -> float:
    """sqrt(d_model) rounded to the served type, as the port's embedding
    multiplies by it."""
    dt = {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(
        cfg["dtype"], torch.float32)
    return float(torch.tensor(math.sqrt(cfg["d_model"]), dtype=dt))


def norm(x, p: Dict[str, torch.Tensor], prefix: str, cfg: dict):
    scale = p[prefix + "scale"].float()
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + cfg["norm_eps"]) * scale \
            + p[prefix + "bias"].float()
    ms = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + cfg["norm_eps"]) * scale


def rope(x, pos, theta: float):
    """x [..., S, H, D] at positions ``pos`` [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs                    # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, chunk: int = 512):
    """Causal GQA: q [B, S, H, D], k/v [B, S, KV, D] -> [B, S, H, D], the
    queries in chunks so that one chunk's scores [B, H, chunk, S] are the
    largest temporary."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    kk = k.repeat_interleave(g, dim=2).transpose(1, 2)   # [B, H, S, D]
    vv = v.repeat_interleave(g, dim=2).transpose(1, 2)
    qq = q.transpose(1, 2)
    outs = []
    keys = torch.arange(s, device=q.device)
    for q0 in range(0, s, chunk):
        q1 = min(s, q0 + chunk)
        sc = torch.matmul(qq[:, :, q0:q1], kk.transpose(-1, -2)) \
            / math.sqrt(d)
        rows = torch.arange(q0, q1, device=q.device)
        sc = sc.masked_fill(keys[None, :] > rows[:, None], NEG)
        outs.append(torch.matmul(torch.softmax(sc, dim=-1), vv))
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(h, p: Dict[str, torch.Tensor], i: int, cfg: dict, mm: Callable):
    """One decoder layer over h [B, S, d] (fp32), weights ``blocks.{i}.*``
    (any dtype; taken in fp32)."""
    pre = f"blocks.{i}."
    b, s, d = h.shape
    hh, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_head"]
    pos = torch.arange(s, device=h.device)

    def w(name):
        return p[pre + name].float()

    x = norm(h, p, pre + "attn_norm.", cfg)
    q = mm(x, w("attn.wq").reshape(d, hh * hd)).reshape(b, s, hh, hd)
    k = mm(x, w("attn.wk").reshape(d, kv * hd)).reshape(b, s, kv, hd)
    v = mm(x, w("attn.wv").reshape(d, kv * hd)).reshape(b, s, kv, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = attention(q, k, v).reshape(b, s, hh * hd)
    h = h + mm(o, w("attn.wo").reshape(hh * hd, d))
    x = norm(h, p, pre + "ffn_norm.", cfg)
    up = mm(x, w("ffn.w_in"))
    if cfg["ffn_act"] == "swiglu":
        up = F.silu(mm(x, w("ffn.w_gate"))) * up
    elif cfg["ffn_act"] == "relu2":
        up = torch.square(F.relu(up))
    else:
        raise ValueError(f"activation {cfg['ffn_act']} is not in the "
                         f"reference")
    return h + mm(up, w("ffn.w_out"))


def embed(tokens, p, cfg):
    return p["embed"][tokens.long()].float() * embed_scale(cfg)


def unembed_matrix(p, cfg):
    return (p["embed"].T if cfg["tie_embeddings"] else p["unembed"]).float()


def logits(hidden, p, cfg, mm: Callable, u=None):
    """fp32 logits [..., V] of final-normed ``hidden`` (``u`` the
    unembedding in fp32 when the caller holds it), the real vocabulary
    only."""
    out = mm(hidden, unembed_matrix(p, cfg) if u is None else u)
    return out[..., :cfg["vocab_size"]]


@torch.no_grad()
def hidden_states(seqs: Sequence[torch.Tensor], p, cfg,
                  mm: Callable = mm_fp32) -> List[torch.Tensor]:
    """Final-normed hidden states [S_i, d] of each token sequence, every
    sequence walked through one layer before the next."""
    hs = [embed(t[None], p, cfg) for t in seqs]
    for i in range(cfg["n_layers"]):
        pre = f"blocks.{i}."
        pl = {n: t.float() for n, t in p.items() if n.startswith(pre)}
        hs = [layer(h, pl, i, cfg, mm) for h in hs]
        del pl
    return [norm(h, p, "final_norm.", cfg)[0] for h in hs]


@torch.no_grad()
def served_logits(prompts: Sequence[torch.Tensor],
                  served: Sequence[torch.Tensor], p, cfg,
                  mm: Callable = mm_fp32) -> List[torch.Tensor]:
    """For each request, the logits [n, V] at the positions that produced
    its ``n`` served tokens: the reference run once over the prompt and
    the served tokens."""
    seqs = [torch.cat([a.long(), b.long()])[:-1]
            for a, b in zip(prompts, served)]
    hs = hidden_states(seqs, p, cfg, mm)
    u = unembed_matrix(p, cfg)
    return [logits(h[len(a) - 1:len(a) - 1 + len(b)], p, cfg, mm, u)
            for h, a, b in zip(hs, prompts, served)]


def gaps(ref: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """By how much each picked token's logit lies below the best of its
    row of ``ref`` [n, V] (infinite for a token outside the
    vocabulary)."""
    last = ref.shape[-1] - 1
    picks = picks.long().to(ref.device)
    best = ref.max(-1).values
    gap = best - ref.gather(-1, picks.clamp(0, last)[:, None])[:, 0]
    return torch.where((picks < 0) | (picks > last), torch.inf, gap)


def logit_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest error of a row of logits ``got`` against ``ref`` [n, V],
    over the spread (standard deviation) of that row of ``ref``."""
    err = (got.float() - ref).abs().amax(-1) / ref.std(-1)
    return float(err.max()) if err.numel() else 0.0


# ---------------------------------------------------------------- training

def lr_at(tcfg: dict, step: int) -> float:
    """Linear warmup, then cosine decay to a tenth (the step count from
    1)."""
    warm = min(step / max(tcfg["warmup_steps"], 1), 1.0)
    t = min(max((step - tcfg["warmup_steps"])
                / max(tcfg["total_steps"] - tcfg["warmup_steps"], 1), 0.0),
            1.0)
    return tcfg["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi
                                                                   * t)))


def train_loss(p, batch, cfg, mm: Callable, chunk: int = 2048):
    """Mean cross-entropy of ``batch["labels"]`` under the model, each
    layer recomputed in the backward pass."""
    h = embed(batch["tokens"], p, cfg)
    for i in range(cfg["n_layers"]):
        h = checkpoint.checkpoint(layer, h, p, i, cfg, mm,
                                  use_reentrant=False)
    h = norm(h, p, "final_norm.", cfg)
    labels = batch["labels"].long()
    total = 0.0
    for c0 in range(0, h.shape[1], chunk):
        lg = logits(h[:, c0:c0 + chunk], p, cfg, mm)
        gold = lg.gather(-1, labels[:, c0:c0 + chunk, None])[..., 0]
        total = total + (torch.logsumexp(lg, -1) - gold).sum()
    return total / labels.numel()


def train(p0: Dict[str, torch.Tensor], batches: Sequence[dict], cfg: dict,
          tcfg: dict, mm: Callable = mm_fp32) -> dict:
    """AdamW from ``p0`` over ``batches``, as the port's optimizer states
    it: gradients clipped by their global norm, moments and bias
    corrections in fp32, decoupled weight decay on every leaf.  Returns
    the losses, each leaf's norm of the first clipped gradient and of its
    change after the last step."""
    p = {n: t.detach().float().clone().requires_grad_(True)
         for n, t in p0.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2, eps = tcfg["beta1"], tcfg["beta2"], tcfg["eps"]
    losses, first = [], None
    for c, batch in enumerate(batches, start=1):
        loss = train_loss(p, batch, cfg, mm)
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            clip = torch.clamp(tcfg["grad_clip"] / (gnorm + 1e-9), max=1.0)
            lr = lr_at(tcfg, c)
            if first is None:
                first = {n: float(torch.linalg.vector_norm(g * clip))
                         for n, g in zip(p, grads)}
            for (n, t), g in zip(p.items(), grads):
                g = g * clip
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).add_(g.square(), alpha=1 - b2)
                step = (m[n] / (1 - b1 ** c)) / (
                    (v[n] / (1 - b2 ** c)).sqrt() + eps)
                step.add_(t, alpha=tcfg["weight_decay"])
                t.sub_(step * lr)
            del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(t - p0[n].float()))
                  for n, t in p.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
