"""A plain simulation of the bf16 decode kernel's tensor-core route
(``csrc/decode_attention.cu`` ``decode_mma_kernel``, the plan's ``"hmma"``
route), shared by ``tests/test_torch_decode_mma.py`` and the plan checks of
``tests/test_torch_kernel_plans.py``.

Per (slot, KV head) the group's query rows take one 16-row tile.  The
cache splits into the plan's ``chunk`` keys; warp w of a split's block
takes its key tiles w, w + 8, ... of ``warp_tile`` keys (16, 8 at D =
256).  A tile's scores
are Q K^T with bf16 products summed in fp32 one 16-wide step of D at a
time, scaled (and capped) into the log2 domain, masked past the slot's
length; the online softmax carries (max, denominator, sums) in fp32 and
rounds p to bf16 per key tile before P V.  The warps merge in warp order,
the live splits in split order against their common max (past
``MERGE_FAN`` of them in a tree: each 16 consecutive splits into one, then
those in order), and the output
is the sums over the denominator floored at 1e-20, with each row's base-2
log-sum-exp beside it (-1e30 and zeros for a row of length 0).
"""
import math

import torch

from repro_torch.kernels import decode_attention as da

NEG_INF = -1e30
LOG2E = 1.4426950408889634
WARPS = 8       # csrc/decode_attention.cu: a block's warps


def _scores(q, k):
    """Q K^T, each 16-wide step of D summed in fp32 and the steps added in
    order, as the HMMA k16 steps accumulate."""
    s = torch.zeros(q.shape[0], k.shape[0])
    for lo in range(0, q.shape[1], 16):
        s = s + q[:, lo:lo + 16] @ k[:, lo:lo + 16].T
    return s


def _warp(q, k, v, tiles, scale, softcap):
    """One warp's walk over its key tiles of a split: (m, l, acc)."""
    r = q.shape[0]
    m = torch.full((r,), NEG_INF)
    l = torch.zeros(r)
    acc = torch.zeros(r, q.shape[1])
    for lo, hi in tiles:
        raw = _scores(q, k[lo:hi])
        if softcap > 0:
            x = softcap * LOG2E * torch.tanh(raw * (scale / softcap))
        else:
            x = raw * (scale * LOG2E)
        mx = torch.maximum(m, x.amax(dim=1))
        p = torch.exp2(x - mx[:, None])
        corr = torch.exp2(m - mx)
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + \
            p.to(torch.bfloat16).float() @ v[lo:hi]
        m = mx
    return m, l, acc


def _merge(parts):
    """(max, denominator, sums) of partials merged in the order given, each
    weighted by 2^(m - max)."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        w = torch.exp2(m - mx)
        l = l + pl * w
        acc = acc + pa * w[:, None]
    return mx, l, acc


def simulate(q, kc, vc, lens, softcap: float = 0.0, chunk=None):
    """q [B, H, D] and caches [B, S, KV, D] (bf16 values, any float dtype),
    per-slot ``lens``: (out [B, H, D] fp32, lse [B, H]) as the tensor-core
    route computes them at the plan's ``chunk`` (or the one given)."""
    b, h, d = q.shape
    s_len, kvh = kc.shape[1], kc.shape[2]
    rep = h // kvh
    if chunk is None:
        chunk = da.plan(b, h, kvh, s_len, d, torch.bfloat16).chunk
    tile = da.warp_tile(d, torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, h, d)
    lse = torch.full((b, h), NEG_INF)
    for bi in range(b):
        n = min(int(lens[bi]), s_len)
        for g in range(kvh):
            rows = slice(g * rep, (g + 1) * rep)
            qg = q[bi, rows].float()
            splits = []
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                ks, vs = kc[bi, lo:hi, g].float(), vc[bi, lo:hi, g].float()
                n_tiles = -(-(hi - lo) // tile)
                warps = [_warp(qg, ks, vs,
                               [(t * tile, min((t + 1) * tile, hi - lo))
                                for t in range(w, n_tiles, WARPS)],
                               scale, softcap)
                         for w in range(WARPS)]
                splits.append(_merge(warps))
            if not splits:
                continue
            if len(splits) > da.MERGE_FAN:
                fan = da.MERGE_FAN
                splits = [_merge(splits[i:i + fan])
                          for i in range(0, len(splits), fan)]
            mx, l, acc = _merge(splits)
            out[bi, rows] = acc / l.clamp_min(1e-20)[:, None]
            lse[bi, rows] = mx + torch.log2(l)
    return out, lse
