"""How the bf16 attention kernels are held against their plain versions:
shared by ``chip_smoke.py`` (phase 3) and ``tests/test_torch_cuda.py``.

A flat absolute limit is blind to late causal rows: row i averages i+1
values, so its entries are about (i+1)**-0.5 (0.02-0.05 at S=1000-2048
with randn inputs) and a 5e-2 limit is as large as what it compares.
``row_err`` divides each row's largest error by that row's own rms, so a
fault that disturbs only late rows (a stale K/V ring stage, a skipped key
tile) shows as plainly as one in row 0.  ``BF16_ROW_TOL`` lies between the
largest reading of sound kernel runs and the smallest reading of the
simulated faults of ``fault_controls`` (both in PERF.md, from
``chip_smoke.py`` on the card); the 5e-2 absolute limit is kept beside it.

Decode attention has the same blind spot: a row over L keys has entries of
about (e / L)**0.5 (0.036 at L=2112), so the bf16 decode kernel is held to
``row_err`` too, at ``DECODE_ROW_TOL``, beside simulated faults of its own
design (``decode_fault_controls``).

The bf16 flash-attention backward (``csrc/flash_attention_bwd.cu``) sums in
fp32 and rounds only its outputs to bf16, so it is held to the plain
backward run in fp32 on the same bf16 inputs: each of dq, dk and dv within
``BWD_ABS_TOL`` of that tensor's largest entry and ``BWD_ROW_TOL`` on
``bwd_row_err``, limits that must reject the simulated faults of
``bwd_fault_controls``; the log-sum-exp the forward saves for it is
held to the plain one at ``LSE_TOL``, a limit that must reject
``lse_fault``.  ``bwd_row_err`` is ``row_err`` with each row's
rms floored at ``BWD_ROW_FLOOR`` of the whole tensor's: a causal dQ row
with few keys is all cancellation (row 0's is P = 1 times dP - Delta = dO
V - dO O with O = V, zero but for rounding), so its own rms measures fp32
noise, not the gradient.

A logit soft cap and a query offset (``softcap``, ``q_offset``) leave each
kernel's limits as they are; the faults they add are the cap dropped (the
uncapped function), the cap's derivative dropped in the backward, and the
offset dropped (:func:`cap_fault_controls`, :func:`bwd_cap_fault_controls`,
:func:`decode_cap_fault_controls`), which the limits must reject at a cap
that bends the checked scores (about 2 for unit-scale scores).

The bf16 matmul is held to the plain version (``ref.matmul_ref``, the
correctly rounded product) at ``MATMUL_BF16_TOL`` absolute and relative
(the JAX tests' 2e-2), a limit that must reject the simulated faults of
:func:`matmul_fault_controls`: the ring's last K tile dropped, and B read
K-major (the transpose bit lost).

The fp32 tdfir kernels are held at a flat 3e-4 (the reference's own limit)
at the shapes of ``tdfir_edges``: the edges of their blocked tap loop, kept
here once for ``chip_smoke.py``, ``tests/test_torch_cuda.py`` and the plan
checks of ``tests/test_torch_kernel_plans.py``.
"""
from __future__ import annotations

import math

import torch

from . import flash_attention as _fa
from . import matmul as _mm
from . import tdfir as _fir
from . import ref
from .ref import NEG_INF

BF16_ABS_TOL = 5e-2
BF16_ROW_TOL = 0.15
DECODE_ROW_TOL = 0.04
SWEEP_D = (16, 32, 64, 80, 128, 256)
SWEEP_S = (1, 63, 64, 65, 200, 1000)


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / rms(want) along the last dim."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    return (diff / rms.clamp_min(1e-30)).max().item()


def within_limits(got: torch.Tensor, want: torch.Tensor):
    """(ok, max abs error, row error) against both bf16 limits."""
    err = (got.float() - want.float()).abs().max().item()
    rerr = row_err(got, want)
    return err <= BF16_ABS_TOL and rerr <= BF16_ROW_TOL, err, rerr


# (Sq, Skv) of non-causal cross-attention: the VLM's prompts over its 1024
# image tokens, the audio prompts over its 3072 frames, and lengths ragged
# against the bf16 kernel's 128-row and 128- or 64-key tiles on both sides
CROSS_LENGTHS = ((1000, 1024), (2048, 1024), (1000, 3072), (2048, 3072),
                 (77, 200), (300, 65), (129, 1), (1, 129))


def cross_cases(gen: torch.Generator, d: int, sq: int, skv: int, dtype,
                device="cuda"):
    """H=8 query heads over KV=8 or 1 (kv_group 1 and 8), each a strided
    [H, S, D] view of [1, S, H, D] with its own length: yields
    (kv_group, q [8, Sq, D], k, v [8 // kv_group, Skv, D])."""
    def heads(n, s):
        x = torch.randn(1, s, n, d, generator=gen).to(device, dtype)
        return x.transpose(1, 2).reshape(n, s, d)

    for rep in (1, 8):
        yield rep, heads(8, sq), heads(8 // rep, skv), heads(8 // rep, skv)


def sweep_cases(gen: torch.Generator, d: int, s: int, device="cuda"):
    """H=8 bf16 query heads over KV=8 or 2 heads (kv_group 1 and 4), each
    a strided [B*H, S, D] view of [1, S, H, D], causal and not: yields
    (kv_group, causal, q, k, v)."""
    def heads(n):
        x = torch.randn(1, s, n, d, generator=gen).to(device, torch.bfloat16)
        return x.transpose(1, 2).reshape(n, s, d)

    for rep in (1, 4):
        q, k, v = heads(8), heads(8 // rep), heads(8 // rep)
        for causal in (True, False):
            yield rep, causal, q, k, v


def _attention(q, k, v, kv_group, p_dtype, drop=None, window=0,
               causal=True):
    """``ref.mha_ref`` (causal unless ``causal=False``, under ``window`` if
    one is given), with the keys in ``drop`` masked out and p rounded to
    ``p_dtype`` before it returns to V's type."""
    k = k.repeat_interleave(kv_group, dim=0)
    v = v.repeat_interleave(kv_group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q, k).float() / math.sqrt(q.shape[-1])
    pos = torch.arange(q.shape[1], device=q.device)
    diff = pos[:, None] - torch.arange(k.shape[1], device=q.device)
    keep = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window:
        keep &= diff < window
    if drop is not None:
        keep[:, drop] = False
    s = torch.where(keep[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(p_dtype).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def fault_controls(q, k, v, kv_group: int, window: int = 0,
                   causal: bool = True) -> dict:
    """Outputs (causal unless ``causal=False``, under ``window`` if one is
    given) of kernel faults that disturb late rows, or in a non-causal walk
    every row, simulated on the plain version: key tile t = 2*STAGES + 1
    skipped (past the ring's first two fills), or only its first 16 keys
    (one k16 step of P V), tile t's K/V read from the stale stage that held
    tile t - STAGES, and P rounded to fp8 e4m3 instead of bf16."""
    bkv, stages = _fa.kv_ring(q.shape[-1])
    t = 2 * stages + 1
    tile = slice(t * bkv, (t + 1) * bkv)
    step = slice(t * bkv, t * bkv + 16)
    stale = slice((t - stages) * bkv, (t - stages + 1) * bkv)
    n = len(range(k.shape[1])[tile])
    ks, vs = k.clone(), v.clone()
    ks[:, tile], vs[:, tile] = k[:, stale][:, :n], v[:, stale][:, :n]
    kw = dict(window=window, causal=causal)
    return {
        f"key tile {t} skipped": _attention(q, k, v, kv_group, v.dtype,
                                            drop=tile, **kw),
        f"keys {t * bkv}-{t * bkv + 15} skipped": _attention(
            q, k, v, kv_group, v.dtype, drop=step, **kw),
        f"tile {t} from stale stage": _attention(q, ks, vs, kv_group,
                                                 v.dtype, **kw),
        "P rounded to fp8": _attention(q, k, v, kv_group,
                                       torch.float8_e4m3fn, **kw),
    }



# the bf16 flash backward against the plain backward in fp32 (both limits
# from chip_smoke.py's readings on the card, PERF.md)
BWD_ABS_TOL = 1e-2      # of each gradient's largest entry
BWD_ROW_TOL = 0.05
BWD_ROW_FLOOR = 0.05    # of the tensor's rms: the least row rms divided by
# csrc/flash_attention_bwd.cu's query-row tile on the bf16 route (64 at
# every head dim)
BWD_TILE = 64


def bwd_want32(q, k, v, o, do, **kw):
    """What the bf16 backward is held to: the plain backward in fp32 on
    the same inputs, with the log-sum-exps of the plain forward in fp32 on
    them."""
    from .ref import mha_backward_ref, mha_ref
    qf, kf, vf = q.float(), k.float(), v.float()
    lse = mha_ref(qf, kf, vf, return_lse=True, **kw)[1]
    return mha_backward_ref(qf, kf, vf, o.float(), do.float(), lse, **kw)


# the forward's saved log-sum-exp (base 2) against the plain one on the same
# inputs, bf16 inputs against the plain forward in fp32 (the kernels sum
# their bf16 products in fp32): sound runs read within a few ulp of L2 ~ 16
# (PERF.md), and ``lse_fault`` must break it
LSE_TOL = 1e-5


def lse_fault(q, k, v, *, causal: bool = True, kv_group: int = 1,
              window: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """The plain L2 with a simulated fault: each row's sum l taken over its
    P rounded to bf16 (the P the bf16 forward feeds to P V), not over the
    fp32 P.  Inputs in fp32; rows with no key keep the sentinel 0."""
    from .ref import LOG2E, NEG_INF, _attention_mask, softcap_scores
    if kv_group != 1:
        k = k.repeat_interleave(kv_group, dim=0)
    s = softcap_scores(torch.einsum("bqd,bkd->bqk", q, k)
                       / math.sqrt(q.shape[-1]), softcap) * LOG2E
    keep = _attention_mask(q.shape[1], k.shape[1], causal, window, q.device,
                           q_offset)
    s = torch.where(keep[None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep[None], torch.exp2(s - m), 0.0).bfloat16().float()
    lse = m[..., 0] + torch.log2(p.sum(-1))
    return torch.where(keep.any(-1)[None], lse, 0.0)


def bwd_row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of max|got - want| / max(rms(want row), BWD_ROW_FLOOR
    rms(want))."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    floor = BWD_ROW_FLOOR * want.square().mean().sqrt()
    return (diff / torch.maximum(rms, floor).clamp_min(1e-30)).max().item()


def bwd_within_limits(got, want32):
    """(ok, largest error over each tensor's max, largest
    :func:`bwd_row_err`) of a backward's (dq, dk, dv) against
    :func:`bwd_want32`'s."""
    errs = [((g.float() - w).abs().max() / w.abs().max().clamp_min(1e-30)
             ).item() for g, w in zip(got, want32)]
    rerrs = [bwd_row_err(g, w) for g, w in zip(got, want32)]
    return (max(errs) <= BWD_ABS_TOL and max(rerrs) <= BWD_ROW_TOL,
            max(errs), max(rerrs))


def _backward(q, k, v, o, do, kv_group, keep, *, delta_shift=False,
              drop_member=False, dq_scale=None):
    """The plain backward in fp32 over an explicit [Sq, Skv] ``keep``
    mask, with one kernel fault simulated: Delta read from the next row
    (``delta_shift``), each KV head's dK summed without its last query
    head (``drop_member``), dQ scaled by ``dq_scale`` in place of
    1/sqrt(D)."""
    n_kv, sk, d = k.shape
    scale = 1.0 / math.sqrt(d)
    qf, of, dof = q.float(), o.float(), do.float()
    kf = k.float().repeat_interleave(kv_group, 0)
    vf = v.float().repeat_interleave(kv_group, 0)
    s = torch.where(keep[None], torch.einsum("bqd,bkd->bqk", qf, kf) * scale,
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (dof * of).sum(-1, keepdim=True)
    if delta_shift:
        delta = torch.cat([delta[:, 1:], delta[:, -1:]], 1)
    ds = torch.where(keep[None], p * (dp - delta), 0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * (dq_scale or scale)
    dk = (torch.einsum("bqk,bqd->bkd", ds, qf) * scale).reshape(
        n_kv, kv_group, sk, d)
    if drop_member:
        dk = dk[:, :-1]
    return dq, dk.sum(1), dv.reshape(n_kv, kv_group, sk, d).sum(1)


def bwd_fault_controls(q, k, v, o, do, kv_group: int, causal: bool = True,
                       window: int = 0) -> dict:
    """(dq, dk, dv) of backward faults, simulated on the plain version in
    fp32: the causal mask dropped on the diagonal tile of query tile 1
    (tile 0 where S has no two tiles: its rows attend to the tile's later
    keys; under no causal mask the tile's rows attend to nothing from key
    64, or half of Skv, on), each KV head's dK
    missing one group member (where the group has more than one), Delta
    read one row off, and dQ scaled by sqrt(D) in place of 1/sqrt(D)."""
    sq, sk = q.shape[1], k.shape[1]
    pos = torch.arange(sq, device=q.device)[:, None]
    diff = pos - torch.arange(sk, device=q.device)[None, :]
    keep = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    if window:
        keep &= diff < window
    i = 1 if min(sq, sk) > 2 * BWD_TILE else 0
    t = slice(i * BWD_TILE, (i + 1) * BWD_TILE)
    bad = keep.clone()
    if causal:
        bad[t, t] = True
    else:
        bad[t, min(BWD_TILE, sk // 2):] = False
    args = (q, k, v, o, do, kv_group)
    controls = {f"mask dropped on tile {i}": _backward(*args, bad),
                "Delta one row off": _backward(*args, keep,
                                               delta_shift=True),
                "dQ scaled by sqrt(D)": _backward(
                    *args, keep, dq_scale=math.sqrt(q.shape[-1]))}
    if kv_group > 1:
        controls["dK missing a group member"] = _backward(
            *args, keep, drop_member=True)
    return controls


def cap_fault_controls(q, k, v, kv_group: int, *, causal: bool = True,
                       window: int = 0, softcap: float = 0.0,
                       q_offset: int = 0) -> dict:
    """Forward outputs of the faults of a capped or offset launch,
    simulated on the plain version in the inputs' dtype: the cap dropped
    (under a cap) and the offset dropped (under an offset)."""
    from .ref import mha_ref
    kw = dict(causal=causal, kv_group=kv_group, window=window)
    controls = {}
    if softcap > 0:
        controls["cap dropped"] = mha_ref(q, k, v, q_offset=q_offset, **kw)
    if q_offset:
        controls["offset dropped"] = mha_ref(q, k, v, softcap=softcap, **kw)
    return controls


def bwd_cap_fault_controls(q, k, v, o, do, kv_group: int, *,
                           causal: bool = True, window: int = 0,
                           softcap: float = 0.0, q_offset: int = 0) -> dict:
    """(dq, dk, dv) of the faults of a capped or offset backward, in fp32
    as :func:`bwd_want32` gives the sound one: the cap dropped (the
    uncapped backward at the uncapped forward's lse), the cap's derivative
    dropped (P from the capped scores, dS not multiplied by 1 - t^2), and
    the offset dropped."""
    from .ref import LOG2E, _attention_mask, mha_backward_ref, mha_ref
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    kw = dict(causal=causal, kv_group=kv_group, window=window)
    controls = {}
    if softcap > 0:
        lse = mha_ref(qf, kf, vf, q_offset=q_offset, return_lse=True,
                      **kw)[1]
        controls["cap dropped"] = mha_backward_ref(
            qf, kf, vf, of, dof, lse, q_offset=q_offset, **kw)
        # the capped P and dS without the cap's derivative
        lse = mha_ref(qf, kf, vf, q_offset=q_offset, softcap=softcap,
                      return_lse=True, **kw)[1]
        n_kv, sk, d = kf.shape
        scale = 1.0 / math.sqrt(d)
        kr = kf.repeat_interleave(kv_group, 0)
        vr = vf.repeat_interleave(kv_group, 0)
        s = softcap * torch.tanh(torch.einsum("bqd,bkd->bqk", qf, kr)
                                 * scale / softcap)
        keep = _attention_mask(q.shape[1], sk, causal, window, q.device,
                               q_offset)
        p = torch.where(keep[None], torch.exp2(s * LOG2E - lse[..., None]),
                        0.0)
        dp = torch.einsum("bqd,bkd->bqk", dof, vr)
        ds = p * (dp - (dof * of).sum(-1, keepdim=True))
        dq = torch.einsum("bqk,bkd->bqd", ds, kr) * scale
        dk = (torch.einsum("bqk,bqd->bkd", ds, qf) * scale).reshape(
            n_kv, kv_group, sk, d).sum(1)
        dv = torch.einsum("bqk,bqd->bkd", p, dof).reshape(
            n_kv, kv_group, sk, d).sum(1)
        controls["cap's derivative dropped"] = (dq, dk, dv)
    if q_offset:
        lse = mha_ref(qf, kf, vf, softcap=softcap, return_lse=True, **kw)[1]
        controls["offset dropped"] = mha_backward_ref(
            qf, kf, vf, of, dof, lse, softcap=softcap, **kw)
    return controls


def decode_cap_fault_controls(q, kc, vc, lens) -> dict:
    """The decode output with the cap dropped, in fp32 as
    :func:`decode_want32` gives the sound one."""
    from .ref import decode_attention_ref
    return {"cap dropped": decode_attention_ref(q.float(), kc.float(),
                                                vc.float(), lens)}


# csrc/decode_attention.cu: 8 warps a block, warp w takes the split's key
# tiles w, w + 8, ...; each warp's cp.async ring has 3 stages
DECODE_WARPS = 8
DECODE_STAGES = 3


def decode_want32(q, kc, vc, lens, softcap: float = 0.0) -> torch.Tensor:
    """What the row-scaled decode limit compares with: the plain version
    run in fp32 on the same (bf16) inputs.  The bf16 plain version rounds
    its scores to bf16, which alone reads up to about 0.05 on ``row_err``
    (three times a sound kernel); the kernel keeps them in fp32."""
    from .ref import decode_attention_ref
    return decode_attention_ref(q.float(), kc.float(), vc.float(), lens,
                                softcap=softcap)


def within_decode_limits(got, want, want32):
    """(ok, max abs error, row error) of bf16 decode attention [B, H, D]:
    at most ``BF16_ABS_TOL`` from the bf16 plain version ``want`` and
    ``DECODE_ROW_TOL`` on ``row_err`` from its fp32 run ``want32``."""
    err = (got.float() - want.float()).abs().max().item()
    rerr = row_err(got, want32)
    return err <= BF16_ABS_TOL and rerr <= DECODE_ROW_TOL, err, rerr


def _decode(q, kc, vc, lens, p_dtype, drop=None):
    """``ref.decode_attention_ref`` with fp32 scores, the keys in ``drop``
    masked out, and the unnormalised p = exp(s - max), as the kernel forms
    it, rounded to ``p_dtype`` before it returns to V's type."""
    b, h, d = q.shape
    s_len, kvh = kc.shape[1], kc.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, kc.float()) / math.sqrt(d)
    pos = torch.arange(s_len, device=q.device)
    keep = pos[None, :] < lens.reshape(-1, 1).to(q.device)
    if drop is not None:
        keep[:, drop] = False
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * keep[:, None, None, :]
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    pv = torch.einsum("bgrk,bkgd->bgrd", p.to(p_dtype).to(vc.dtype).float(),
                      vc.float())
    return (pv / l).to(q.dtype).reshape(b, h, d)


def decode_fault_controls(q, kc, vc, lens, chunk: int, key_tile: int
                          ) -> dict:
    """Outputs of faults of the decode kernel, simulated on the plain
    version: split 1 (keys chunk..2*chunk-1) left out of the merge, where
    the cache has a second split; one warp tile (warp 1's first, keys
    key_tile..2*key_tile-1) dropped; tile t = WARPS*STAGES + 1 read from
    the stale ring stage, which held the same warp's tile 1 (what a missing
    wait gives in a split long enough to wrap the ring); and p rounded to
    fp8 e4m3 instead of V's type."""
    tile = slice(key_tile, 2 * key_tile)
    t = DECODE_WARPS * DECODE_STAGES + 1
    late = slice(t * key_tile, (t + 1) * key_tile)
    ks, vs = kc.clone(), vc.clone()
    ks[:, late], vs[:, late] = kc[:, tile], vc[:, tile]
    controls = {}
    if chunk < kc.shape[1]:
        controls["split 1 dropped"] = _decode(
            q, kc, vc, lens, vc.dtype, drop=slice(chunk, 2 * chunk))
    controls.update({
        f"keys {key_tile}-{2 * key_tile - 1} (warp tile) dropped":
            _decode(q, kc, vc, lens, vc.dtype, drop=tile),
        f"tile {t} from stale stage": _decode(q, ks, vs, lens, vc.dtype),
        "P rounded to fp8": _decode(q, kc, vc, lens, torch.float8_e4m3fn),
    })
    return controls


# (F, N, K) at the edges of the tdfir kernel's blocked loop (8 outputs a
# thread, taps in groups of 4, each plane's window swizzled in 8-float
# blocks): K not a multiple of 4; K' = 36, 44 or 100 mod 64, where the
# window's last quad is swizzled past the window (N of several tiles);
# N below one thread's outputs, and N not a multiple of 4 (rows not
# 16-byte aligned: 4-byte copies); N < K; F = 1; K past the block tile
TDFIR_EDGES = ((3, 1000, 1), (3, 1000, 3), (3, 1000, 4), (3, 1000, 5),
               (3, 1000, 127), (3, 1000, 129), (3, 1000, 36), (3, 1000, 44),
               (3, 1000, 100), (2, 1001, 36), (2, 1, 16), (2, 7, 16),
               (2, 4093, 128), (2, 100, 128), (1, 4096, 128), (4, 1000, 200))


def tdfir_edges() -> tuple:
    """``TDFIR_EDGES`` and the largest K each form takes, complex then
    real."""
    return TDFIR_EDGES + ((2, 3000, _fir.max_taps(2)),
                          (2, 3000, _fir.max_taps(1)))


MATMUL_BF16_TOL = 2e-2


def matmul_within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether a bf16 product is within ``MATMUL_BF16_TOL`` of the plain
    version, absolute and relative, at every entry."""
    return torch.allclose(got.float(), want.float(), rtol=MATMUL_BF16_TOL,
                          atol=MATMUL_BF16_TOL)


def matmul_fault_controls(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Outputs of bf16 matmul kernel faults, simulated on the plain
    version: the last TMA_K-deep K tile of the ring dropped (a producer
    that stops one tile short), and B [K, N] read K-major, as if its
    memory held [N, K] (the wgmma transpose bit lost)."""
    k, n = b.shape
    last = (k - 1) // _mm.TMA_K * _mm.TMA_K
    return {
        f"K tile {last // _mm.TMA_K} dropped":
            ref.matmul_ref(a[:, :last], b[:last]),
        "B read K-major": ref.matmul_ref(a, b.reshape(n, k).t()),
    }
