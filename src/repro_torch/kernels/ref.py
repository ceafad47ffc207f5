"""Plain PyTorch versions of every kernel: what the CPU path runs and what
the CUDA kernels are held against on the card."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in float64 and rounded once to ``a.dtype``.

    The JAX reference sums in fp32 (``matmul_ref`` there), which on its
    CPU comes out close to the exact product; a library fp32 GEMM sums in
    another order and drifts past the reference tests' 1e-5 at K=256.
    Summing in float64 makes the plain version the correctly rounded
    product, which both fp32 kernels are held against.
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(a.dtype)


def tdfir_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal per-filter FIR: y[f,n] = sum_k h[f,k] x[f,n-k]."""
    n = x.shape[1]
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for kk in range(k):
        y = y + h[:, kk:kk + 1] * xp[:, k - 1 - kk:k - 1 - kk + n]
    return y.to(x.dtype)


def tdfir_complex_ref(x_re, x_im, h_re, h_im):
    rr = tdfir_ref(x_re, h_re)
    ii = tdfir_ref(x_im, h_im)
    ri = tdfir_ref(x_re, h_im)
    ir = tdfir_ref(x_im, h_re)
    return rr - ii, ri + ir


NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)


def softcap_scores(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """Scaled scores under a logit soft cap ``c``: ``c tanh(s / c)`` (the
    JAX layers' rule); 0 is no cap."""
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, kv_group: int = 1, window: int = 0,
            softcap: float = 0.0, q_offset: int = 0,
            return_lse: bool = False):
    """q [BH, Sq, D], k/v [BH // kv_group, Skv, D]: row ``bh`` of q attends
    over K/V row ``bh // kv_group`` (the GQA layout).  ``window`` > 0 keeps
    only keys with ``qpos - kpos < window`` (the JAX layers' sliding-window
    rule); 0 is no window.  ``softcap`` > 0 caps the scaled scores at
    ``c tanh(s / c)`` before the mask; query row ``i`` sits at position
    ``i + q_offset`` for the causal and window compares.  With
    ``return_lse`` it returns (out, lse): lse float32 [BH, Sq], each row's
    log-sum-exp of its (capped) scaled scores in base 2, L2 = log2(e)
    logsumexp(s) over the keys the row attends (0 for a row that attends
    none), what the forward kernels save for the backward."""
    if kv_group != 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * scale
    s = softcap_scores(s, softcap)
    mask = None
    if causal or window:
        mask = _attention_mask(q.shape[1], k.shape[1], causal, window,
                               q.device, q_offset)
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1) * LOG2E
    if mask is not None:
        lse = torch.where(mask.any(-1)[None], lse, 0.0)
    return out, lse


def _attention_mask(sq: int, sk: int, causal: bool, window: int, device,
                    q_offset: int = 0):
    """[Sq, Sk] bool: key kept for query (all True without causal or
    window); query row ``i`` sits at position ``i + q_offset``."""
    diff = (torch.arange(sq, device=device)[:, None] + q_offset
            - torch.arange(sk, device=device)[None, :])
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window:
        mask &= diff < window
    return mask


def mha_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                     *, causal: bool = True, kv_group: int = 1,
                     window: int = 0, softcap: float = 0.0,
                     q_offset: int = 0):
    """The gradient of :func:`mha_ref` by its explicit formulas, in fp32,
    given the forward's row log-sum-exps (``lse``, base 2, as
    ``mha_ref(..., return_lse=True)`` returns them):
    P = exp2(log2(e) s - lse) (0 where masked) with s = scale Q K^T, or
    under a soft cap c, s = c t with t = tanh(scale Q K^T / c);
    dV = P^T dO, dP = dO V^T, Delta = rowsum(dO * O),
    dS = P * (dP - Delta), times the cap's derivative 1 - t^2 under a cap,
    dQ = scale dS K, dK = scale dS^T Q.  Under GQA each KV head's dK and
    dV sum over its ``kv_group`` query heads.  ``o`` is the forward's
    output; returns (dq, dk, dv) in the inputs' dtypes.  A row that
    attends no key (lse 0) adds nothing, as in the kernels."""
    n_kv, sk, d = k.shape
    bh, sq = q.shape[:2]
    scale = 1.0 / math.sqrt(d)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(kv_group, dim=0)
    vf = v.float().repeat_interleave(kv_group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    if softcap > 0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _attention_mask(sq, sk, causal, window, q.device, q_offset)
    p = torch.where(mask[None],
                    torch.exp2(s * LOG2E - lse.float()[..., None]), 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = torch.where(mask[None], p * (dp - delta), 0.0)
    if softcap > 0:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
    dk = dk.reshape(n_kv, kv_group, sk, d).sum(1)
    dv = dv.reshape(n_kv, kv_group, sk, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len,
                         return_lse: bool = False, softcap: float = 0.0):
    """One query per row over a GQA cache.

    q [B, H, D]; caches [B, S, KV, D]; ``cache_len`` an int or an int
    tensor [B] (key ``s`` of row ``b`` is valid iff ``s < cache_len[b]``).
    Query head ``h`` reads KV head ``h // (H // KV)``.  With H = KV = 1 this
    is the TPU oracle ``decode_attention_ref`` on ``[BH, D]`` /
    ``[BH, S, D]``.  A row with no valid key is zeros, as in the kernel.
    With ``return_lse`` it returns (out, lse): lse float32 [B, H], each
    row's log-sum-exp of its scaled scores over its valid keys in base 2
    (``NEG_INF`` for a row with none), as the kernel writes it.
    ``softcap`` > 0 caps the scaled scores at ``c tanh(s / c)`` first.
    """
    b, h, d = q.shape
    s_len, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_cache).to(torch.float32) * scale
    s = softcap_scores(s, softcap)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s_len, device=q.device)[None, :] < lens   # [B?, S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.where(valid[:, None, None, :], torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype), v_cache)
    if not return_lse:
        return out.reshape(b, h, d)
    lse = torch.where(valid.any(-1)[:, None, None],
                      torch.logsumexp(s, dim=-1) * LOG2E, NEG_INF)
    return out.reshape(b, h, d), lse.reshape(b, h)
