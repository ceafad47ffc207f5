"""The host-side plans of the matmul, decode-attention and tdfir kernels
and the flash kernel's tiles (each within the 227 KB of shared memory a
block may opt into): the matmul's tile grid and warp split cover every product term exactly once
and fill the card at 512^3; the decode split sizes are whole key tiles, cover
the cache and give about one wave of live blocks at the serving lengths;
a plain simulation of the decode kernel's splits, warp tiles and
in-order logsumexp merges at the plan's chunk sizes matches the Pallas
decode kernel (interpret mode), also at D = 80 with the scores summed as
the kernel's padded lanes sum them; and the card's bf16 decode limits pass
both and reject simulated kernel faults; at D = 256 with 10 query heads a
KV head (recurrentgemma) the decode plan's lanes, passes, warp tiles and
split cap, and the simulation against Pallas; at the cross-attention
families' layouts (8 query heads a KV head at D = 128, one at D = 64, every
row's length the whole context) the plans, the simulation against Pallas,
and the bf16 flash limits against simulated faults of a non-causal walk
over a context of another length.  For tdfir: the plan and the
kernel's index arithmetic cover every output and every (output, tap) pair
once and read inside the staged window, the window swizzle is free of bank
conflicts, a plain simulation of the blocked tap loop matches the Pallas
tdfir, and the card's 3e-4 limit rejects simulated faults of that loop.
The bf16 groups of 2 to 16 query heads a KV head take the decode kernel's
tensor-core route, simulated by ``decode_mma_sim`` (its own checks:
tests/test_torch_decode_mma.py).  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import decode_mma_sim
from repro.kernels import decode_attention as jax_da
from repro.kernels import tdfir as jax_fir
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import parity, ref
from repro_torch.kernels import tdfir as fir

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
    # every group the wrapper admits takes one of the kernel's row-pass
    # counts: 1, 2, 4, 8 (and 16 in fp32) up to rep * padded D = 2048, and
    # 10 at D = 256; a lane per 16-byte chunk of D and query row (two past
    # 32 chunks: fp32 at D = 256), a row's chunks rounded up to a
    # power-of-two count of lanes (D = 80: 10 or 20 chunks on 16 or 32), a
    # lane's rows holding at most 80 query elements
    rep = data.draw(st.integers(1, da.max_group(d, dtype)))
    p = da.plan(b, rep * kv, kv, s_len, d, dtype)
    assert p.chunk % tile == 0 and p.chunk >= tile
    assert p.n_splits * p.chunk >= s_len
    assert p.n_splits == 1 or (p.n_splits - 1) * p.chunk < s_len
    lens = data.draw(st.lists(st.integers(1, max(1, s_len)), min_size=b,
                              max_size=b))
    assert da.live_blocks(p, lens, kv) <= b * kv * p.n_splits
    if s_len:       # a full cache makes every split live
        assert da.live_blocks(p, [s_len] * b, kv) == b * kv * p.n_splits
    # the merging block's threads load at most MERGE_LOADS partials each
    # on the CUDA-core route; the tensor-core route (bf16 groups of 2-16)
    # sizes 0.75 waves of splits of 256 keys or more, and merges in a tree
    assert p.route == da.route(rep * kv, kv, d, dtype)
    if p.route == "lanes":
        assert p.n_splits * rep * d <= da.MERGE_LOADS * da.THREADS
    else:
        assert p.n_splits <= max(1, -(-3 * da.SMS // (4 * b * kv)))
        assert p.chunk >= da.HMMA_MIN_CHUNK
    chunks_per_row = d * dtype.itemsize // 16
    lanes = da.lanes_per_row(d, dtype)
    per_lane = da.chunks_per_lane(d, dtype)
    assert lanes * per_lane >= chunks_per_row and 32 % lanes == 0
    assert lanes * per_lane == chunks_per_row or d == 80
    assert per_lane == 1 or (lanes == 32 and d == 256)
    passes = math.ceil(rep / (32 // lanes))
    assert passes <= (10 if d == 256 else
                      16 if dtype == torch.float32 else 8)
    assert passes * per_lane * 16 // dtype.itemsize <= 80
    # a split is whole warp tiles
    assert p.chunk % da.warp_tile(d, dtype) == 0


def test_decode_plan_fills_the_card_at_the_serving_shape():
    """The CUDA-core route (fp32 here) sizes its grid for 2.5 waves: about
    one wave of live blocks at the serving lengths.  The tensor-core route
    (bf16 at 4 query heads a KV head) sizes it for 0.75 waves of splits of
    at least 256 keys: half the SMs at the serving lengths, all of them
    (128 blocks) with every slot full."""
    p = da.plan(4, 32, 8, 2112, 64, torch.float32)
    assert p.route == "lanes" and 192 <= p.chunk <= 256
    assert da.live_blocks(p, (1, 300, 1000, 2112), 8) >= 120
    p = da.plan(4, 32, 8, 2112, 64, torch.bfloat16)
    assert p == da.DecodePlan(528, 4, "hmma")
    assert da.live_blocks(p, (1, 300, 1000, 2112), 8) == 64
    assert da.live_blocks(p, (2112,) * 4, 8) == 128 <= da.SMS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_plan_wraps_the_rings_of_a_64_slot_pool(dtype):
    """The card's checks reach the wrap-around of each warp's 3-stage
    cp.async ring through a 64-slot pool: one split a row, at least five
    wraps a warp."""
    tile = da.KEY_TILE[dtype]
    p = da.plan(64, 32, 8, 2112, 64, dtype)
    assert p.n_splits == 1
    assert p.chunk // tile >= 5 * parity.DECODE_STAGES * KERNEL_WARPS


def _online(q, k, v, tiles, scale, dtype, dot=torch.matmul):
    """One warp's online softmax over its key tiles (as the kernel runs it):
    q [R, D]; k, v [S, D] of this split; returns (m [R], l [R], acc [R, D]),
    unnormalised, p rounded to ``dtype`` before P V.  ``dot(q, k^T)`` gives
    the raw scores."""
    r = q.shape[0]
    m = torch.full((r,), NEG_INF, dtype=torch.float32)
    l = torch.zeros(r)
    acc = torch.zeros(r, q.shape[1])
    for lo, hi in tiles:
        s = dot(q, k[lo:hi].T) * scale
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


def _simulate(q, kc, vc, lens, dtype, dot=torch.matmul):
    """The kernel's split + warp-tile + in-order merge structure in plain
    torch (fp32): q [B, H, D], caches [B, S, KV, D]."""
    b, h, d = q.shape
    s_len, kvh = kc.shape[1], kc.shape[2]
    rep = h // kvh
    p = da.plan(b, h, kvh, s_len, d, dtype)
    tile = da.warp_tile(d, dtype)
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
                                 scale, dtype, dot)
                         for w in range(KERNEL_WARPS)]
                splits.append(_merge(warps))
            _, l, acc = _merge(splits)
            out[bi, g * rep:(g + 1) * rep] = acc / l.clamp_min(1e-20)[:, None]
    return out


def _route_sim(q, kc, vc, lens, dtype, dot=torch.matmul):
    """The simulation of the route the plan takes: the tensor-core route's
    (``decode_mma_sim``) for bf16 groups of 2 to 16 query heads a KV head,
    else the CUDA-core kernel's splits and warp tiles with ``dot``."""
    b, h, d = q.shape
    kvh = kc.shape[2]
    if da.plan(b, h, kvh, kc.shape[1], d, dtype).route == "hmma":
        return decode_mma_sim.simulate(q, kc, vc, lens)[0]
    return _simulate(q, kc, vc, lens, dtype, dot)


def test_decode_split_merge_matches_pallas():
    """Lengths 1, chunk - 1, chunk, chunk + 1 and s_len, grouped heads
    (H=8 over KV=2): the simulation against the Pallas kernel, run per slot
    on K/V repeated per query head, at 2e-4 in fp32."""
    b, h, kvh, s_len, d = 5, 8, 2, 864, 32
    p = da.plan(b, h, kvh, s_len, d, torch.float32)
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


def _lane_dot(dtype):
    """Scores as csrc/decode_attention.cu sums them: a lane holds one
    16-byte chunk of the row (EPC elements, fmaf in order), or chunks c and
    c + 32 where a row has 64 (fp32 at D = 256), a row takes
    ``lanes_per_row`` lanes, the lanes past its chunks hold zeros, and the
    lanes' partials meet in an xor butterfly over the row's lanes."""
    epc = 16 // dtype.itemsize

    def dot(q, kt):
        d = q.shape[1]
        lanes = da.lanes_per_row(d, dtype)
        cpl = da.chunks_per_lane(d, dtype)
        pad = cpl * lanes * epc - d
        qp = F.pad(q, (0, pad)).reshape(q.shape[0], cpl, lanes, epc)
        kp = F.pad(kt.T, (0, pad)).reshape(kt.shape[1], cpl, lanes, epc)
        part = torch.zeros(q.shape[0], kt.shape[1], lanes)
        for u in range(cpl):
            for e in range(epc):
                part = part + qp[:, None, u, :, e] * kp[None, :, u, :, e]
        assert not part[..., -(-d // epc):].any()  # the padded lanes add 0
        off = lanes // 2
        while off:
            part = part + part[..., torch.arange(lanes) ^ off]
            off //= 2
        return part[..., 0]
    return dot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_d80_padded_lanes_match_pallas(dtype):
    """D = 80 (h2o-danube): 10 chunks a row on 16 lanes in bf16, 20 on 32
    in fp32 (the CUDA-core kernel's rows; bf16 at 4 query heads a KV head
    takes the tensor-core route, on five k16 steps of D).  The simulation
    of the route's splits (with the CUDA-core kernel's lane sums) against
    the Pallas kernel (interpret mode) on the same values, per slot with K/V
    repeated per query head: 2e-4 in fp32, the bf16 limits against the fp32
    plain version in bf16."""
    b, h, kvh, s_len, d = 3, 8, 2, 700, 80
    assert da.lanes_per_row(d, dtype) == (16 if dtype == torch.bfloat16
                                          else 32)
    assert da.max_group(d, dtype) >= 4            # h2o: 32 over 8 heads
    lens = [1, 333, s_len]
    rng = np.random.default_rng(13)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dtype).float()
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))
    assert da.plan(b, h, kvh, s_len, d, dtype).route == (
        "hmma" if dtype == torch.bfloat16 else "lanes")
    got = _route_sim(q, kc, vc, lens, dtype, _lane_dot(dtype))
    rep = h // kvh
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = torch.stack([torch.from_numpy(np.array(jax_da.decode_attention(
        jnp.asarray(q[bi].numpy(), jdt),
        jnp.asarray(kc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.asarray(vc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.int32(lens[bi]), block_kv=100, interpret=True), np.float32))
        for bi in range(b)])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    else:
        lens_t = torch.tensor(lens, dtype=torch.int32)
        qb, kb, vb = (t.to(dtype) for t in (q, kc, vc))
        plain = ref.decode_attention_ref(qb, kb, vb, lens_t)
        want32 = parity.decode_want32(qb, kb, vb, lens_t)
        for out in (got, want):
            assert parity.within_decode_limits(out.to(dtype), plain,
                                               want32)[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kvh", [(14, 2), (16, 16)])
def test_decode_row_passes_at_the_moe_groups_match_pallas(h, kvh, dtype):
    """D = 128 at arctic's group of 7 query heads a KV head (the CUDA-core
    kernel's rows, bf16: 2 rows a pass, 4 passes, the last half empty;
    fp32: 1 row a pass, 7 passes on the 8-pass instantiation) and at
    moonshot's group of 1 over 16 KV rows a slot (one pass).  Each row of
    the group is placed once and the rows past it only in the last pass;
    the kernel's splits, lane sums and passes, simulated with zero queries
    in the empty rows, against the Pallas kernel (interpret mode) per slot
    on K/V repeated per query head: 2e-4 in fp32, the bf16 limits in bf16.
    bf16 at group 7 takes the tensor-core route: its 7 rows in one 16-row
    tile over 9 zero rows, simulated so."""
    b, s_len, d = 2, 300, 128
    rep = h // kvh
    # a pass holds the rows whose lanes fill the warp; the kernel runs the
    # passes on the smallest instantiation NP, a power of two, not below them
    rows = 32 // da.lanes_per_row(d, dtype)
    passes = -(-rep // rows)
    n_pass = 1 << (passes - 1).bit_length()
    want_plan = {(torch.bfloat16, 7): (2, 4, 4), (torch.float32, 7): (1, 7, 8),
                 (torch.bfloat16, 1): (2, 1, 1), (torch.float32, 1): (1, 1, 1)}
    assert (rows, passes, n_pass) == want_plan[(dtype, rep)]
    assert rep <= da.max_group(d, dtype)
    slots = [(i % rows, i // rows) for i in range(n_pass * rows)]
    assert [lane + rows * p for lane, p in slots] == \
        list(range(n_pass * rows))
    assert all(p == passes - 1 or p >= passes
               for i, (_, p) in enumerate(slots) if i >= rep)
    lens = [1, 257]
    rng = np.random.default_rng(17)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dtype).float()
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))
    # the warp's rows: the group's rep queries, then zeros to n_pass * rows
    # (to the 16-row tile on the tensor-core route)
    hmma = da.plan(b, h, kvh, s_len, d, dtype).route == "hmma"
    assert hmma == (dtype == torch.bfloat16 and rep == 7)
    width = da.HMMA_ROWS if hmma else n_pass * rows
    padded = torch.zeros(b, kvh, width, d)
    padded[:, :, :rep] = q.reshape(b, kvh, rep, d)
    flat = padded.reshape(b, kvh * width, d)
    sim = (decode_mma_sim.simulate(flat, kc, vc, lens)[0] if hmma
           else _simulate(flat, kc, vc, lens, dtype, _lane_dot(dtype)))
    got = sim.reshape(b, kvh, width, d)[:, :, :rep].reshape(b, h, d)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = torch.stack([torch.from_numpy(np.array(jax_da.decode_attention(
        jnp.asarray(q[bi].numpy(), jdt),
        jnp.asarray(kc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.asarray(vc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.int32(lens[bi]), block_kv=100, interpret=True), np.float32))
        for bi in range(b)])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    else:
        lens_t = torch.tensor(lens, dtype=torch.int32)
        qb, kb, vb = (t.to(dtype) for t in (q, kc, vc))
        plain = ref.decode_attention_ref(qb, kb, vb, lens_t)
        want32 = parity.decode_want32(qb, kb, vb, lens_t)
        for out in (got, want):
            assert parity.within_decode_limits(out.to(dtype), plain,
                                               want32)[0]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_decode_bf16_limits_pass_tiled_kernels_and_reject_faults(d):
    """The card's bf16 decode limits (absolute, and row-scaled against the
    fp32 plain version) pass two sound tiled online softmaxes, the Pallas
    kernel (128-key tiles, interpret mode) and the simulation of the CUDA
    kernel's splits and warp tiles (at 4 query heads a KV head its
    tensor-core route's), and reject each simulated fault of
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
    assert da.plan(b, h, kvh, s_len, d, torch.bfloat16).route == "hmma"
    simulated = _route_sim(q, kc, vc, lens, torch.bfloat16).to(torch.bfloat16)
    for got in (pallas, simulated):
        assert parity.within_decode_limits(got, want, want32)[0]
    tile = da.KEY_TILE[torch.bfloat16]
    controls = parity.decode_fault_controls(
        q, kc, vc, lens, da.plan(b, h, kvh, s_len, d, torch.bfloat16).chunk,
        da.warp_tile(d, torch.bfloat16))
    assert len(controls) == 4
    for fault, bad in controls.items():
        assert parity.row_err(bad, want32) > 2 * parity.DECODE_ROW_TOL, fault


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_kv_ring_per_head_dim(d):
    """The bf16 kernel's K/V ring that ``parity.fault_controls`` simulates
    (held to ``Tile<D>`` when the library loads on the card): 128-key tiles
    in 3 stages, 2 from D = 128 (D = 80 runs the D = 128 tile), and at
    D = 256 (recurrentgemma) 64-key tiles in 2 stages; a tile is whole k16
    steps of P V, and the faulted tile 2 * stages + 1 lies inside the
    1024-key prompts that the fault checks use."""
    bkv, stages = fa.kv_ring(d)
    assert (bkv, stages) == {256: (64, 2), 128: (128, 2),
                             80: (128, 2)}.get(d, (128, 3))
    assert bkv % 16 == 0
    assert (2 * stages + 2) * bkv <= 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_plan_at_head_dim_256_group_10(dtype):
    """recurrentgemma's decode: 10 query heads over one KV head at D = 256.
    A row takes the whole warp (32 chunks in bf16; 64 in fp32, two a lane,
    so no lane past the warp), one row a pass, 10 passes on the 10-pass
    instantiation, 80 query elements a lane; warp tiles of half the key
    tile keep the 8 warps' 3-stage rings within 192 KB; the [4, 2048, 1,
    256] pool splits into whole warp tiles and covers the cache."""
    d, rep = 256, 10
    epc = 16 // dtype.itemsize
    lanes, cpl = da.lanes_per_row(d, dtype), da.chunks_per_lane(d, dtype)
    assert lanes == 32
    assert cpl == (2 if dtype == torch.float32 else 1)
    assert lanes * cpl * epc == d
    rows = 32 // lanes
    passes = -(-rep // rows)
    assert (rows, passes) == (1, 10)
    assert passes * cpl * epc <= 80
    assert da.max_group(d, dtype) == 10 >= rep
    tile = da.warp_tile(d, dtype)
    assert tile == da.KEY_TILE[dtype] // 2
    ring = KERNEL_WARPS * parity.DECODE_STAGES * 2 * tile * d * dtype.itemsize
    merge = KERNEL_WARPS * rep * (d + 2) * 4
    assert max(ring, merge) <= 192 * 1024
    # the splits are capped so that the block merging them loads at most
    # MERGE_LOADS partials a thread: 16 splits, where 2.5 waves of 4 rows
    # would ask for 83; bf16 takes the tensor-core route, whose grid is
    # 0.75 waves of splits of 256 keys or more: 8 splits, 21 of them live
    p = da.plan(4, rep, 1, 2048, d, dtype)
    hmma = dtype == torch.bfloat16
    assert p.route == ("hmma" if hmma else "lanes")
    assert p.chunk % tile == 0 and p.chunk * p.n_splits >= 2048
    assert hmma or p.n_splits * rep * d <= da.MERGE_LOADS * da.THREADS
    assert (p.chunk, p.n_splits) == ((256, 8) if hmma else (128, 16))
    assert p.n_splits < -(-5 * da.SMS // (2 * 4)) == 83
    assert da.live_blocks(p, (1, 1000, 2048, 2048), 1) == (21 if hmma
                                                           else 41)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_d256_group_10_matches_pallas(dtype):
    """The simulation of the kernel at D = 256 with 10 query heads over one
    KV head (its splits, half-size warp tiles, and lane sums: two chunks a
    lane in fp32; in bf16 the tensor-core route's k16 steps and m16n8k8
    P V) against the Pallas kernel (interpret mode) per slot, on K/V
    repeated per query head: 2e-4 in fp32, the bf16 limits in bf16."""
    b, h, kvh, s_len, d = 2, 10, 1, 300, 256
    lens = [1, 257]
    rng = np.random.default_rng(19)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dtype).float()
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))
    got = _route_sim(q, kc, vc, lens, dtype, _lane_dot(dtype))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = torch.stack([torch.from_numpy(np.array(jax_da.decode_attention(
        jnp.asarray(q[bi].numpy(), jdt),
        jnp.asarray(kc[bi].repeat_interleave(h, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.asarray(vc[bi].repeat_interleave(h, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.int32(lens[bi]), block_kv=100, interpret=True), np.float32))
        for bi in range(b)])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    else:
        lens_t = torch.tensor(lens, dtype=torch.int32)
        qb, kb, vb = (t.to(dtype) for t in (q, kc, vc))
        plain = ref.decode_attention_ref(qb, kb, vb, lens_t)
        want32 = parity.decode_want32(qb, kb, vb, lens_t)
        for out in (got, want):
            assert parity.within_decode_limits(out.to(dtype), plain,
                                               want32)[0]


# ---- tdfir: csrc/tdfir.cu's blocked loop ---------------------------------

# (F, N, K): the main path and the card's phase-3 edges of the blocked loop
TDFIR_SHAPES = [(64, 4096, 128), *parity.tdfir_edges()]
R, GROUP = fir.OUTPUTS_PER_THREAD, fir.TAP_GROUP
CHUNK = 256         # tap groups a check takes at once (bounded memory)


def _swz(s):
    """csrc/tdfir.cu's window slot of sample s (bit 2 flipped in odd
    32-float blocks)."""
    return s ^ ((s >> 3) & 4)


def _block_reads(p, g0, g1):
    """csrc/tdfir.cu's index arithmetic for one block, over (thread t,
    group g in [g0, g1), tap i of the group, output j of the thread): the
    block-local output 8t + j, its tap 4g + i and the window sample it
    reads, w[4 + j - i] of the quad at s = 8t + K' - 4 - 4g."""
    t, g, i, j = np.ix_(np.arange(p.threads), np.arange(g0, g1),
                        np.arange(GROUP), np.arange(R))
    s = R * t + p.taps - 4 - 4 * g
    return np.broadcast_arrays(R * t + j, GROUP * g + i, s + 4 + j - i)


def _check_tdfir_plan(f, n, k):
    p = fir.plan(f, n, k)
    assert p.threads % 32 == 0 and 32 <= p.threads <= fir.MAX_THREADS
    assert p.taps % GROUP == 0 and k <= p.taps < k + GROUP
    assert (p.grid_n, p.grid_f) == (-(-n // p.tile), f)
    # every output sample in exactly one block's tile, one thread's 8
    owners = np.zeros(p.grid_n * p.tile, np.int64)
    for b in range(p.grid_n):
        np.add.at(owners, b * p.tile + _block_reads(p, 0, 1)[0][:, 0, 0, :]
                  .ravel(), 1)
    assert (owners == 1).all() and p.grid_n * p.tile - p.tile < n
    # every (output, tap) pair of a block once through the tap groups and
    # the zero padding to K' (chunks of groups cover disjoint tap ranges);
    # the sample read is x[n0 + out - tap]
    groups = p.taps // GROUP
    for g0 in range(0, groups, CHUNK):
        g1 = min(groups, g0 + CHUNK)
        out, tap, sample = _block_reads(p, g0, g1)
        span = GROUP * (g1 - g0)
        pairs = np.bincount((out * span + tap - GROUP * g0).ravel(),
                            minlength=p.tile * span)
        assert len(pairs) == p.tile * span and (pairs == 1).all()
        assert (sample == out - tap + p.taps).all()  # sample 0 = n0 - K'
        assert sample.min() >= 0 and sample.max() < p.window
    # the quads loaded (three at the start, one a group after) stay in the
    # staged window x[n0 - K', n0 + tile)
    first = R * np.arange(p.threads)[:, None] + p.taps - 4 \
        - 4 * np.arange(groups)[None, :]
    quads = np.concatenate([first.ravel(), first[:, 0] + 4, first[:, 0] + 8])
    assert quads.min() >= 0 and quads.max() + 4 <= p.window
    # every quad staged or loaded keeps its 4 slots, after the swizzle,
    # inside its plane's stride (the next plane starts there)
    slots = _swz(np.concatenate([np.arange(0, p.window, 4), quads]))
    assert slots.min() >= 0 and (slots + 4).max() <= p.stride
    # csrc/tdfir.cu's shared memory: per plane K' taps and the stride
    planes = 1 if k > fir.max_taps(2) else 2
    assert p.smem_bytes(planes) == 4 * planes * (p.taps + p.stride) \
        <= fir.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("f,n,k", TDFIR_SHAPES)
def test_tdfir_plan_covers_each_output_and_tap_once(f, n, k):
    _check_tdfir_plan(f, n, k)


@settings(max_examples=25, deadline=None)
@given(f=st.integers(1, 64), n=st.integers(1, 8192),
       k=st.integers(1, fir.max_taps(1)))
def test_tdfir_plan_sweep(f, n, k):
    _check_tdfir_plan(f, n, k)


def test_tdfir_plan_fills_the_card_at_the_main_shape():
    p = fir.plan(64, 4096, 128)
    assert p.blocks >= fir.SMS
    assert p.blocks * p.threads // 32 >= 4 * fir.SMS   # a warp a scheduler


def test_tdfir_window_swizzle_is_conflict_free():
    """Eight lanes reading 16 bytes at s0 + 8 lane (a quarter-warp of the
    x loads) hit 32 distinct banks for every 4-aligned s0, and the swizzle
    keeps each aligned quad one aligned quad (cp.async stages quads)."""
    for s0 in range(0, 512, 4):
        banks = [(_swz(s0 + 8 * lane) + e) % 32 for lane in range(8)
                 for e in range(4)]
        assert sorted(banks) == list(range(32)), s0
    slots = [_swz(s) for s in range(1024)]
    assert sorted(slots) == list(range(1024))
    assert all(_swz(q) % 4 == 0 and [_swz(q + e) for e in range(4)]
               == list(range(_swz(q), _swz(q) + 4)) for q in range(0, 1024, 4))


def _simulate_fir(x, h, fault=None):
    """csrc/tdfir.cu's blocked loop in plain torch (fp32): each block's
    staged window (zeros before n = 0 and past N), each thread's 12-sample
    register window slid by 4 a group, taps in groups of 4 (zero past K),
    each output's sums in ascending tap order.  ``fault`` simulates a
    kernel fault: "group_dropped" (group G/2 skipped), "window_off_by_one"
    (every read one sample late), "no_history" (the first tile's samples
    before n = 0 taken from the previous filter's row, not zeros)."""
    f, n = x.shape
    k = h.shape[1]
    p = fir.plan(f, n, k)
    hp = F.pad(h, (0, p.taps - k))
    xp = F.pad(x, (p.taps, p.grid_n * p.tile - n))
    if fault == "no_history":
        xp[:, :p.taps] = torch.roll(x, 1, 0)[:, -p.taps:] if n >= p.taps \
            else 1.0
    windows = xp.unfold(1, p.window, p.tile)      # [F, tiles, window]
    base = (R * torch.arange(p.threads)[:, None] + p.taps - 4
            + torch.arange(12)[None, :])           # [threads, 12]
    if fault == "window_off_by_one":
        base = torch.clamp(base + 1, max=p.window - 1)
    acc = torch.zeros(f, p.grid_n, p.threads, R)
    for g in range(p.taps // GROUP):
        if fault == "group_dropped" and g == p.taps // GROUP // 2:
            continue
        w = windows[:, :, base - 4 * g]            # [F, tiles, threads, 12]
        for i in range(GROUP):
            acc = acc + hp[:, GROUP * g + i, None, None, None] \
                * w[..., 4 - i:12 - i]
    return acc.reshape(f, -1)[:, :n]


def _jax_fir(x, h):
    """The Pallas tdfir (interpret mode) at the app's block_n = max(128, K);
    x is zero-extended to K samples first where N < K (the Pallas kernel
    needs its block to cover the taps; causal outputs do not see the
    extension)."""
    n, k = x.shape[1], h.shape[1]
    xe = np.pad(x, ((0, 0), (0, max(0, k - n))))
    return np.asarray(jax_fir.tdfir(jnp.asarray(xe), jnp.asarray(h),
                                    block_n=max(128, k),
                                    interpret=True))[:, :n]


SIM_SHAPES = [(3, 1000, 5), (2, 300, 129), (2, 100, 128), (1, 2048, 128),
              (2, 7, 16), (2, 1030, 3)]


@pytest.mark.parametrize("f,n,k", SIM_SHAPES)
def test_tdfir_blocked_loop_matches_pallas(f, n, k):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((f, n), np.float32)
    h = rng.standard_normal((f, k), np.float32)
    got = _simulate_fir(torch.from_numpy(x), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, _jax_fir(x, h), rtol=3e-4, atol=3e-4)


def test_tdfir_complex_blocked_loop_matches_pallas():
    """The one-launch complex form: four sums over the two staged windows
    (rr, ii, ri, ir), then rr - ii and ri + ir."""
    rng = np.random.default_rng(22)
    xr, xi = (rng.standard_normal((3, 700), np.float32) for _ in range(2))
    hr, hi = (rng.standard_normal((3, 130), np.float32) for _ in range(2))
    t = [torch.from_numpy(a) for a in (xr, xi, hr, hi)]
    got = (_simulate_fir(t[0], t[2]) - _simulate_fir(t[1], t[3]),
           _simulate_fir(t[0], t[3]) + _simulate_fir(t[1], t[2]))
    want = jax_fir.tdfir_complex(*map(jnp.asarray, (xr, xi, hr, hi)),
                                 block_n=max(128, 130), interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4)


@pytest.mark.parametrize("fault", ["group_dropped", "window_off_by_one",
                                   "no_history"])
def test_tdfir_limit_rejects_simulated_faults(fault):
    """The card's 3e-4 limit rejects each simulated fault of the blocked
    loop by far (at the planner's K=128, over two tiles)."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((4, 2048), np.float32))
    h = torch.from_numpy(rng.standard_normal((4, 128), np.float32)) * 0.1
    want = ref.tdfir_ref(x, h)
    assert (_simulate_fir(x, h) - want).abs().max() <= 3e-4
    err = (_simulate_fir(x, h, fault) - want).abs().max().item()
    assert err > 100 * 3e-4, err


# ---- the cross-attention families: group 8 at D = 128, full contexts ------

# (B, H, KV, S, D, lengths) of the decode calls phase 10 serves: the VLM's
# self-attention pool and its 1024-token image context (8 query heads a KV
# head at D = 128), the audio decoder's 3072-frame context (one a KV head
# at D = 64); a context is read whole by every row
CROSS_DECODE = [((4, 64, 8, 2112, 128), (1, 300, 1000, 2112)),
                ((4, 64, 8, 1024, 128), (1024,) * 4),
                ((4, 16, 16, 3072, 64), (3072,) * 4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,lens", CROSS_DECODE)
def test_decode_plans_of_the_cross_attention_families(shape, lens, dtype):
    """Group 8 at D = 128 (the CUDA-core kernel's rows, bf16: 2 rows a pass
    on 16 lanes each, 4 passes; fp32: one row on the whole warp, 8 passes;
    bf16 takes the tensor-core route, one 16-row tile) and group 1 at D =
    64 (one pass); whole warp tiles that cover the cache, the merge within
    its route's cap, and, with every row full, every split live: 11 x 32
    blocks over either VLM pool, 6 x 64 over the audio context."""
    b, h, kv, s, d = shape
    rep = h // kv
    assert rep <= da.max_group(d, dtype)
    rows = 32 // da.lanes_per_row(d, dtype)
    passes = -(-rep // rows)
    want = {(8, torch.bfloat16): (2, 4), (8, torch.float32): (1, 8),
            (1, torch.bfloat16): (4, 1), (1, torch.float32): (2, 1)}
    assert (rows, passes) == want[(rep, dtype)]
    p = da.plan(b, h, kv, s, d, dtype)
    assert p.chunk % da.warp_tile(d, dtype) == 0
    assert p.chunk * p.n_splits >= s > p.chunk * (p.n_splits - 1)
    assert p.route == ("hmma" if dtype == torch.bfloat16 and rep == 8
                       else "lanes")
    assert (p.route == "hmma"
            or p.n_splits * rep * d <= da.MERGE_LOADS * da.THREADS)
    # the tensor-core route's grid: 0.75 waves, splits of 256 keys or more
    assert (p.chunk, p.n_splits) == ({2112: (528, 4), 1024: (256, 4)}
                                     if p.route == "hmma" else
                                     {2112: (192, 11), 1024: (96, 11),
                                      3072: (512, 6)})[s]
    live = da.live_blocks(p, lens, kv)
    if set(lens) == {s}:
        assert live == b * kv * p.n_splits
    else:
        assert live < b * kv * p.n_splits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kvh,d", [(16, 2, 128), (4, 4, 64)])
def test_decode_full_context_rows_match_pallas(h, kvh, d, dtype):
    """The kernel's splits, lane sums and passes (bf16 at 8 query heads a
    KV head: the tensor-core route's tile), simulated at the cross layouts
    (8 query heads a KV head at D = 128, one at D = 64) with every row's
    length the whole cache (a context), against the Pallas kernel
    (interpret mode) per slot on K/V repeated per query head: 2e-4 in fp32,
    the bf16 limits in bf16."""
    b, s_len = 2, 300
    rep = h // kvh
    lens = [s_len] * b
    rng = np.random.default_rng(23)
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(dtype).float()
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))
    got = _route_sim(q, kc, vc, lens, dtype, _lane_dot(dtype))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = torch.stack([torch.from_numpy(np.array(jax_da.decode_attention(
        jnp.asarray(q[bi].numpy(), jdt),
        jnp.asarray(kc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.asarray(vc[bi].repeat_interleave(rep, 1).transpose(0, 1)
                    .numpy(), jdt),
        jnp.int32(lens[bi]), block_kv=100, interpret=True), np.float32))
        for bi in range(b)])
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    else:
        lens_t = torch.tensor(lens, dtype=torch.int32)
        qb, kb, vb = (t.to(dtype) for t in (q, kc, vc))
        plain = ref.decode_attention_ref(qb, kb, vb, lens_t)
        want32 = parity.decode_want32(qb, kb, vb, lens_t)
        for out in (got, want):
            assert parity.within_decode_limits(out.to(dtype), plain,
                                               want32)[0]


@pytest.mark.parametrize("sq,skv,h,kv,d", [(300, 1024, 8, 1, 128),
                                           (200, 3072, 2, 2, 64)])
def test_noncausal_bf16_limits_reject_simulated_faults(sq, skv, h, kv, d):
    """Non-causal flash over a context of another length: the bf16 limits
    pass the plain version run in fp32 and rounded once, and reject the
    simulated faults (``parity.fault_controls(causal=False)``), which
    disturb every row of a non-causal walk."""
    gen = torch.Generator().manual_seed(29)
    q, k, v = (torch.randn(n, s, d, generator=gen).to(torch.bfloat16)
               for n, s in ((h, sq), (kv, skv), (kv, skv)))
    want = ref.mha_ref(q, k, v, causal=False, kv_group=h // kv)
    sound = ref.mha_ref(q.float(), k.float(), v.float(), causal=False,
                        kv_group=h // kv).to(torch.bfloat16)
    assert parity.within_limits(sound, want)[0]
    faults = parity.fault_controls(q, k, v, h // kv, causal=False)
    assert len(faults) == 4
    for fault, bad in faults.items():
        assert not parity.within_limits(bad, want)[0], fault
