"""The host-side plans of the matmul and decode-attention kernels: the
matmul's tile grid and warp split cover every product term exactly once
and fill the card at 512^3; the decode split sizes are whole key tiles, cover
the cache and give about one wave of live blocks at the serving lengths;
a plain simulation of the decode kernel's splits, warp tiles and
in-order logsumexp merges at the plan's chunk sizes matches the Pallas
decode kernel (interpret mode); and the card's bf16 decode limits pass
both and reject simulated kernel faults.  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import decode_attention as jax_da
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import parity, ref

NEG_INF = -1e30
KERNEL_WARPS = 8    # csrc/decode_attention.cu: warp w takes tiles w, w + 8..


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (100, 70, 130),
                                   (17, 19, 23), (513, 1001, 511),
                                   (1, 1, 1), (64, 4, 64)])
def test_matmul_plan_covers_each_product_once(m, k, n):
    """Every product term A[i, kk] B[kk, j] lies in exactly one block's tile
    and one of its warps' K slabs, no block row or column is empty, and
    512^3 fills about one wave of the 132 SMs."""
    p = mm.plan(m, n, k)
    bm, bn, wk = mm.BLOCK_M, mm.BLOCK_N, mm.SLAB_K
    if (m, k, n) == (512, 512, 512):
        assert p.blocks >= 128 and p.warps == mm.MAX_WARPS
    assert p.warps in (1, 2, 4, 8)
    owners = np.zeros((m, n), np.int64)
    for i in range(p.grid_m):
        for j in range(p.grid_n):
            owners[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn] += 1
    assert (owners == 1).all()
    assert p.grid_m * bm >= m > (p.grid_m - 1) * bm
    assert p.grid_n * bn >= n > (p.grid_n - 1) * bn
    # one block's warps over K: warp w takes slabs w, w + warps, ...
    slabs = -(-k // wk)
    k_seen = np.zeros(slabs * wk, np.int64)
    for w in range(p.warps):
        for s in range(w, slabs, p.warps):
            k_seen[s * wk:(s + 1) * wk] += 1
    assert (k_seen == 1).all()


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 64), kv=st.sampled_from([1, 2, 4, 8, 16]),
       s_len=st.integers(0, 40000), d=st.sampled_from(da.HEAD_DIMS),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       data=st.data())
def test_decode_plan_splits_whole_tiles_over_the_cache(b, kv, s_len, d,
                                                       dtype, data):
    tile = da.KEY_TILE[dtype]
    p = da.plan(b * kv, s_len, tile)
    assert p.chunk % tile == 0 and p.chunk >= tile
    assert p.n_splits * p.chunk >= s_len
    assert p.n_splits == 1 or (p.n_splits - 1) * p.chunk < s_len
    lens = data.draw(st.lists(st.integers(1, max(1, s_len)), min_size=b,
                              max_size=b))
    assert da.live_blocks(p, lens, kv) <= b * kv * p.n_splits
    if s_len:       # a full cache makes every split live
        assert da.live_blocks(p, [s_len] * b, kv) == b * kv * p.n_splits
    # every group the wrapper admits (rep * D <= 2048) takes one of the
    # kernel's row-pass counts: 1..8 in bf16, 1..16 in fp32, a lane per
    # 16-byte chunk of D and query row
    rep = data.draw(st.integers(1, da.MAX_GROUP_WIDTH // d))
    chunks_per_row = d * dtype.itemsize // 16
    passes = math.ceil(rep / (32 // chunks_per_row))
    assert passes <= (16 if dtype == torch.float32 else 8)


def test_decode_plan_fills_the_card_at_the_serving_shape():
    p = da.plan(4 * 8, 2112, da.KEY_TILE[torch.bfloat16])
    assert 192 <= p.chunk <= 256
    assert da.live_blocks(p, (1, 300, 1000, 2112), 8) >= 120


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_plan_wraps_the_rings_of_a_64_slot_pool(dtype):
    """The card's checks reach the wrap-around of each warp's 3-stage
    cp.async ring through a 64-slot pool: one split a row, at least five
    wraps a warp."""
    tile = da.KEY_TILE[dtype]
    p = da.plan(64 * 8, 2112, tile)
    assert p.n_splits == 1
    assert p.chunk // tile >= 5 * parity.DECODE_STAGES * KERNEL_WARPS


def _online(q, k, v, tiles, scale, dtype):
    """One warp's online softmax over its key tiles (as the kernel runs it):
    q [R, D]; k, v [S, D] of this split; returns (m [R], l [R], acc [R, D]),
    unnormalised, p rounded to ``dtype`` before P V."""
    r = q.shape[0]
    m = torch.full((r,), NEG_INF, dtype=torch.float32)
    l = torch.zeros(r)
    acc = torch.zeros(r, q.shape[1])
    for lo, hi in tiles:
        s = (q @ k[lo:hi].T) * scale
        mx = torch.maximum(m, s.max(dim=1).values)
        p = torch.exp(s - mx[:, None])
        corr = torch.exp(m - mx)
        l = l * corr + p.sum(dim=1)
        acc = acc * corr[:, None] + p.to(dtype).float() @ v[lo:hi]
        m = mx
    return m, l, acc


def _merge(parts):
    """Logsumexp merge of (m, l, acc) partials in the order given."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, pl, pa in parts:
        w = torch.exp(m - mx)
        l = l + pl * w
        acc = acc + pa * w[:, None]
    return mx, l, acc


def _simulate(q, kc, vc, lens, dtype):
    """The kernel's split + warp-tile + in-order merge structure in plain
    torch (fp32): q [B, H, D], caches [B, S, KV, D]."""
    b, h, d = q.shape
    s_len, kvh = kc.shape[1], kc.shape[2]
    rep = h // kvh
    tile = da.KEY_TILE[dtype]
    p = da.plan(b * kvh, s_len, tile)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty(b, h, d)
    for bi in range(b):
        n = min(int(lens[bi]), s_len)
        for g in range(kvh):
            qg = q[bi, g * rep:(g + 1) * rep].float()
            splits = []
            for sp in range(p.n_splits):
                lo, hi = sp * p.chunk, min((sp + 1) * p.chunk, n)
                if lo >= hi:
                    continue
                ks, vs = kc[bi, lo:hi, g].float(), vc[bi, lo:hi, g].float()
                n_tiles = math.ceil((hi - lo) / tile)
                warps = [_online(qg, ks, vs,
                                 [(t * tile, min((t + 1) * tile, hi - lo))
                                  for t in range(w, n_tiles, KERNEL_WARPS)],
                                 scale, dtype)
                         for w in range(KERNEL_WARPS)]
                splits.append(_merge(warps))
            _, l, acc = _merge(splits)
            out[bi, g * rep:(g + 1) * rep] = acc / l.clamp_min(1e-20)[:, None]
    return out


def test_decode_split_merge_matches_pallas():
    """Lengths 1, chunk - 1, chunk, chunk + 1 and s_len, grouped heads
    (H=8 over KV=2): the simulation against the Pallas kernel, run per slot
    on K/V repeated per query head, at 2e-4 in fp32."""
    b, h, kvh, s_len, d = 5, 8, 2, 864, 32
    p = da.plan(b * kvh, s_len, da.KEY_TILE[torch.float32])
    assert p.chunk > da.KEY_TILE[torch.float32] and p.n_splits > 4
    lens = [1, p.chunk - 1, p.chunk, p.chunk + 1, s_len]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, s_len, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s_len, kvh, d)).astype(np.float32)
    got = _simulate(*map(torch.from_numpy, (q, kc, vc)), lens,
                    torch.float32).numpy()
    rep = h // kvh
    for bi, n in enumerate(lens):
        k_rows = np.repeat(kc[bi].transpose(1, 0, 2), rep, axis=0)
        v_rows = np.repeat(vc[bi].transpose(1, 0, 2), rep, axis=0)
        want = jax_da.decode_attention(
            jnp.asarray(q[bi]), jnp.asarray(k_rows), jnp.asarray(v_rows),
            jnp.int32(n), block_kv=96, interpret=True)
        np.testing.assert_allclose(got[bi], np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=f"len {n}")


@pytest.mark.parametrize("d", [64, 128])
def test_decode_bf16_limits_pass_tiled_kernels_and_reject_faults(d):
    """The card's bf16 decode limits (absolute, and row-scaled against the
    fp32 plain version) pass two sound tiled online softmaxes, the Pallas
    kernel (128-key tiles, interpret mode) and the simulation of the CUDA
    kernel's splits and warp tiles, and reject each simulated fault of
    ``parity.decode_fault_controls`` by over twice the row limit."""
    b, h, kvh, s_len = 3, 8, 2, 1024
    lens = torch.tensor([s_len, 700, 450], dtype=torch.int32)
    rng = np.random.default_rng(12)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(torch.bfloat16)
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))
    want = ref.decode_attention_ref(q, kc, vc, lens)
    want32 = parity.decode_want32(q, kc, vc, lens)
    rep = h // kvh
    pallas = torch.stack([torch.from_numpy(np.asarray(jax_da.decode_attention(
        jnp.asarray(q[bi].float().numpy(), jnp.bfloat16),
        jnp.asarray(kc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .float().numpy(), jnp.bfloat16),
        jnp.asarray(vc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .float().numpy(), jnp.bfloat16),
        jnp.int32(int(lens[bi])), block_kv=128, interpret=True), np.float32))
        for bi in range(b)]).to(torch.bfloat16)
    simulated = _simulate(q, kc, vc, lens, torch.bfloat16).to(torch.bfloat16)
    for got in (pallas, simulated):
        assert parity.within_decode_limits(got, want, want32)[0]
    tile = da.KEY_TILE[torch.bfloat16]
    controls = parity.decode_fault_controls(
        q, kc, vc, lens, da.plan(b * kvh, s_len, tile).chunk, tile)
    assert len(controls) == 4
    for fault, bad in controls.items():
        assert parity.row_err(bad, want32) > 2 * parity.DECODE_ROW_TOL, fault
