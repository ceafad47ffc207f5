"""The bf16 decode kernel's tensor-core route (``csrc/decode_attention.cu``
``decode_mma_kernel``, the plan's ``"hmma"`` route): the plan's route and
its bounds, the split count that fills the card at recurrentgemma's ring,
the ring's swizzle (a bijection, free of ldmatrix bank conflicts), and a
plain simulation of the route's arithmetic (``decode_mma_sim``) against
the Pallas decode kernel in interpret mode at every group the route takes
(2 to 16 query heads a KV head, 10 at D = 256) and every head dim, with a
row of length 0, lengths that are not whole tiles, the lse beside the
plain version's and the soft cap beside the JAX layers' capped decode,
at the bf16 limits of ``kernels/parity.py``.  The card's test holds the
route against the plain version at the serving rows (PERF.md rows 4-4i):
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_mma.py``
(JAX is imported inside the CPU tests only: the card has none)."""
import itertools

import numpy as np
import pytest
import torch

import decode_mma_sim as sim
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import parity, ref

BF16 = torch.bfloat16
GROUPS = (2, 3, 4, 6, 7, 8, 10, 12, 16)
SWEEP = [(rep, d) for d in da.HEAD_DIMS for rep in GROUPS
         if rep <= da.hmma_group(d)]
# (B, H, KV, S, D) and lengths of the serving rows that take the route
# (PERF.md rows 4, 4'', 4''', 4'''', 4e, 4g, 4h, 4i)
SERVING_ROWS = [((4, 32, 8, 2112, 64), (1, 300, 1000, 2112)),
                ((4, 32, 8, 4096, 80), (1, 1000, 4096, 4096)),
                ((4, 48, 8, 2112, 128), (1, 300, 1000, 2112)),
                ((4, 96, 8, 2112, 128), (1, 300, 1000, 2112)),
                ((4, 56, 8, 2112, 128), (1, 300, 1000, 2112)),
                ((4, 10, 1, 2048, 256), (1, 1000, 2048, 2048)),
                ((4, 64, 8, 2112, 128), (1, 300, 1000, 2112)),
                ((4, 64, 8, 1024, 128), (1024,) * 4)]
CAP = 1.5


@pytest.fixture(scope="module")
def jax_modules():
    """The JAX package's Pallas decode kernel and layers (imported here, not
    at the top, so that the card's test runs where there is no JAX)."""
    import jax.numpy as jnp
    from repro.kernels import decode_attention as jax_da
    from repro.models import layers as jax_layers
    return jnp, jax_da, jax_layers


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("d", da.HEAD_DIMS)
def test_plan_route_by_dtype_and_group(d, dtype):
    """bf16 groups of 2 to 16 query heads a KV head (10 at D = 256) take
    the tensor-core route; group 1, the larger groups the CUDA-core kernel
    takes at D <= 64, and every fp32 group take the CUDA-core kernel."""
    assert da.hmma_group(d) == (10 if d == 256 else 16)
    for rep in range(1, da.max_group(d, dtype) + 1):
        p = da.plan(4, 8 * rep, 8, 2112, d, dtype)
        want = ("hmma" if dtype == BF16 and 2 <= rep <= da.hmma_group(d)
                else "lanes")
        assert p.route == want == da.route(8 * rep, 8, d, dtype)
        if want == "lanes":
            assert p.n_splits * rep * d <= da.MERGE_LOADS * da.THREADS
        else:   # 0.75 waves, splits of 256 keys or more
            assert p.n_splits <= -(-3 * da.SMS // (4 * 32))
            assert p.chunk >= da.HMMA_MIN_CHUNK
        assert p.chunk % da.warp_tile(d, dtype) == 0
    # nothing the CUDA-core kernel took is refused: its groups reach past
    # the tensor-core route's only at D <= 64 in bf16
    assert da.max_group(d, BF16) >= da.hmma_group(d)


def test_plan_grid_at_the_serving_rows():
    """The tensor-core route sizes its grid for 0.75 waves of the 132 SMs
    over the whole cache, splits of at least 256 keys: fewer and longer
    splits than the CUDA-core route's 2.5 waves, because a block's fixed
    costs (its first loads, its partial, the merge) outweigh its keys
    (scripts/decode_routes.py on the card).  Row 4g, [4, 2048, 1, 256] at
    10 query heads and lengths 1/1000/2048/2048: 8 splits of 256 keys, 21
    live blocks (one wave, 64 splits and 161 live blocks, ran 1.7x
    slower); the serving pools: 4 splits of 528 keys; the VLM's 1024-token
    context: 4 of 256, 128 blocks, one wave; a 64-slot pool: a split a
    row.  A long cache over few rows takes the merge's tree (more than
    MERGE_FAN live splits)."""
    p = da.plan(4, 10, 1, 2048, 256, BF16)
    assert p == da.DecodePlan(256, 8, "hmma")
    assert da.live_blocks(p, (1, 1000, 2048, 2048), 1) == 21
    lanes = da.plan(4, 10, 1, 2048, 256, torch.float32)
    assert (lanes.n_splits, lanes.route) == (16, "lanes")
    assert da.live_blocks(lanes, (1, 1000, 2048, 2048), 1) == 41
    for h, d in ((32, 64), (96, 128), (48, 128), (56, 128)):
        assert da.plan(4, h, 8, 2112, d, BF16) == da.DecodePlan(528, 4,
                                                                "hmma")
    assert da.plan(4, 32, 8, 4096, 80, BF16) == da.DecodePlan(1024, 4,
                                                              "hmma")
    p = da.plan(4, 64, 8, 1024, 128, BF16)
    assert p == da.DecodePlan(256, 4, "hmma")
    assert da.live_blocks(p, (1024,) * 4, 8) == 128 <= da.SMS
    assert da.plan(64, 32, 8, 2112, 64, BF16)[:2] == (2112, 1)
    p = da.plan(1, 12, 1, 32768, 128, BF16)
    assert p.n_splits > da.MERGE_FAN and p.chunk >= da.HMMA_MIN_CHUNK
    assert da.counters(1, 1, p.n_splits) == 1 + -(-p.n_splits //
                                                  da.MERGE_FAN)


@pytest.mark.parametrize("d", da.HEAD_DIMS)
def test_ring_swizzle_is_a_bijection_free_of_bank_conflicts(d):
    """``ring_chunk`` places every 16-byte chunk of a warp tile (and of the
    16-row Q tile) once, and the 8 rows each ldmatrix phase reads (one
    chunk of rows 0-7 or 8-15) lie in 8 distinct 16-byte bank groups,
    but for D = 80's last two chunks (2-way)."""
    cpr = d // 8
    for rows in (da.warp_tile(d, BF16), da.HMMA_ROWS):
        placed = sorted(da.ring_chunk(r, c, d) for r in range(rows)
                        for c in range(cpr))
        assert placed == list(range(rows * cpr))
        for r0, c in itertools.product(range(0, rows, 8), range(cpr)):
            banks = [da.ring_chunk(r0 + r, c, d) % 8 for r in range(8)]
            ways = max(banks.count(x) for x in banks)
            tail = cpr > 8 and c >= cpr // 8 * 8
            assert ways == (2 if tail else 1), (r0, c, banks)


def _inputs(seed, b, h, kvh, s_len, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(BF16)
                 for shape in ((b, h, d), (b, s_len, kvh, d),
                               (b, s_len, kvh, d)))


def _pallas(jax_modules, q, kc, vc, lens, block_kv):
    """The Pallas kernel (interpret mode) per slot, K/V repeated per query
    head; zeros for a slot of length 0."""
    jnp, jax_da, _ = jax_modules
    rep = q.shape[1] // kc.shape[2]
    outs = []
    for bi, n in enumerate(lens):
        if n == 0:
            outs.append(torch.zeros(q.shape[1:]))
            continue

        def bf(x):
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        outs.append(torch.from_numpy(np.asarray(jax_da.decode_attention(
            bf(q[bi]), bf(kc[bi].repeat_interleave(rep, 1).transpose(0, 1)),
            bf(vc[bi].repeat_interleave(rep, 1).transpose(0, 1)),
            jnp.int32(n), block_kv=block_kv, interpret=True), np.float32)))
    return torch.stack(outs)


def _hold(got, lse, q, kc, vc, lens, softcap=0.0):
    """The bf16 limits against the plain version (bf16, and fp32 for the
    row limit), zeros and -1e30 at length 0, and the lse within 1e-3 of the
    plain version's in fp32."""
    lens_t = torch.tensor(lens, dtype=torch.int32)
    plain = ref.decode_attention_ref(q, kc, vc, lens_t, softcap=softcap)
    want32, want_lse = ref.decode_attention_ref(
        q.float(), kc.float(), vc.float(), lens_t, return_lse=True,
        softcap=softcap)
    ok, err, rerr = parity.within_decode_limits(got.to(BF16), plain, want32)
    assert ok, (err, rerr)
    empty = lens_t == 0
    assert not got[empty].any() and (lse[empty] == sim.NEG_INF).all()
    assert (lse - want_lse).abs().max().item() <= 1e-3
    return want32


@pytest.mark.parametrize("rep,d", SWEEP)
def test_hmma_simulation_matches_pallas(rep, d, jax_modules):
    """Each group and head dim of the route: 3 slots over 2 KV heads, a
    200-key cache at lengths 0, 77 and 200 (a row with no key, one ending
    inside a tile, one whole).  The simulation and the Pallas kernel are
    within the bf16 limits of the plain version, and of each other."""
    b, kvh, s_len, lens = 3, 2, 200, (0, 77, 200)
    q, kc, vc = _inputs(100 + rep * 7 + d, b, rep * kvh, kvh, s_len, d)
    assert da.plan(b, rep * kvh, kvh, s_len, d, BF16).route == "hmma"
    got, lse = sim.simulate(q, kc, vc, lens)
    want32 = _hold(got, lse, q, kc, vc, lens)
    pallas = _pallas(jax_modules, q, kc, vc, lens, block_kv=40)
    assert parity.within_decode_limits(pallas.to(BF16),
                                       ref.decode_attention_ref(
                                           q, kc, vc, torch.tensor(lens)),
                                       want32)[0]
    assert parity.within_decode_limits(got.to(BF16), pallas.to(BF16),
                                       pallas)[0]


@pytest.mark.parametrize("rep,d", [(4, 64), (12, 128), (10, 256), (16, 80),
                                   (3, 16)])
def test_hmma_simulation_capped_matches_jax(rep, d, jax_modules):
    """Under a soft cap of 1.5 (scores bent, as Gemma 2's cap bends them at
    its scale): the simulation within the bf16 limits of the capped plain
    version and of the JAX layers' capped decode (per slot), the lse of the
    capped scores, and the uncapped output outside the limit."""
    jnp, _, jax_layers = jax_modules
    b, kvh, s_len, lens = 3, 2, 200, (0, 77, 200)
    q, kc, vc = _inputs(300 + rep + d, b, rep * kvh, kvh, s_len, d)
    got, lse = sim.simulate(q, kc, vc, lens, softcap=CAP)
    want32 = _hold(got, lse, q, kc, vc, lens, softcap=CAP)
    # the JAX layers' decode per slot with keys (at length 0 it averages
    # every V row, where the kernel and the plain version give zeros)
    for bi in range(1, b):
        def bf(x):
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        jax_out = torch.from_numpy(np.asarray(jax_layers.decode_attention(
            bf(q[bi:bi + 1, None]), bf(kc[bi:bi + 1]), bf(vc[bi:bi + 1]),
            lens[bi], softcap=CAP), np.float32))[:, 0]
        assert parity.within_decode_limits(
            got[bi:bi + 1].to(BF16), jax_out.to(BF16),
            want32[bi:bi + 1])[0], bi
    uncapped = ref.decode_attention_ref(q.float(), kc.float(), vc.float(),
                                        torch.tensor(lens))
    assert parity.row_err(uncapped, want32) > 2 * parity.DECODE_ROW_TOL


@pytest.mark.parametrize("rep,d", [(12, 128), (10, 256), (4, 80)])
def test_hmma_simulation_across_warps_and_splits_matches_pallas(
        rep, d, jax_modules):
    """Splits of 256 keys (every warp takes two or more tiles, so the warp
    merge and the 3-stage rings' wrap take part) over a 700-key cache at
    lengths 1, 257, 600 and 700: the simulation against Pallas."""
    b, kvh, s_len, lens = 4, 1, 700, (1, 257, 600, 700)
    q, kc, vc = _inputs(500 + rep + d, b, rep * kvh, kvh, s_len, d)
    got, lse = sim.simulate(q, kc, vc, lens, chunk=256)
    want32 = _hold(got, lse, q, kc, vc, lens)
    pallas = _pallas(jax_modules, q, kc, vc, lens, block_kv=100)
    assert parity.within_decode_limits(got.to(BF16), pallas.to(BF16),
                                       want32)[0]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_hmma_limits_reject_the_simulated_faults(d):
    """The row limit passes the simulation at a wide group and rejects each
    simulated fault of the kernel (``parity.decode_fault_controls``: a
    split left out, a warp tile dropped, a tile from a stale ring stage, p
    rounded to fp8) by over twice the limit."""
    rep = da.hmma_group(d)
    b, kvh, s_len = 2, 2, 1024
    lens = torch.tensor([s_len, 700], dtype=torch.int32)
    q, kc, vc = _inputs(700 + d, b, rep * kvh, kvh, s_len, d)
    p = da.plan(b, rep * kvh, kvh, s_len, d, BF16)
    assert p.route == "hmma"
    got, _ = sim.simulate(q, kc, vc, lens)
    want32 = parity.decode_want32(q, kc, vc, lens)
    assert parity.within_decode_limits(
        got.to(BF16), ref.decode_attention_ref(q, kc, vc, lens), want32)[0]
    controls = parity.decode_fault_controls(q, kc, vc, lens, p.chunk,
                                            da.warp_tile(d, BF16))
    assert len(controls) == 4
    for fault, bad in controls.items():
        assert parity.row_err(bad, want32) > 2 * parity.DECODE_ROW_TOL, fault


@pytest.mark.gpu
@pytest.mark.parametrize("shape,lens", SERVING_ROWS)
def test_cuda_hmma_route_matches_plain_version(shape, lens):
    """The route on the card at the serving rows: one launch, within the
    bf16 limits of the plain version, its lse within 1e-3, the same bits
    on a second call, and under a cap of 1.5 the capped plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(31)
    b, h, kvh, s_len, d = shape
    q, kc, vc = (torch.randn(sh, generator=gen).to("cuda", BF16)
                 for sh in ((b, h, d), (b, s_len, kvh, d),
                            (b, s_len, kvh, d)))
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    assert da.plan(b, h, kvh, s_len, d, BF16).route == "hmma"
    for cap in (0.0, CAP):
        ops.reset_launch_counts()
        lse = torch.empty((b, h), dtype=torch.float32, device="cuda")
        got = ops.decode_attention(q, kc, vc, ln, lse=lse, softcap=cap)
        torch.cuda.synchronize()
        assert ops.launch_counts()["decode_attention"] == 1
        want32, want_lse = ref.decode_attention_ref(
            q.float(), kc.float(), vc.float(), ln, return_lse=True,
            softcap=cap)
        ok, err, rerr = parity.within_decode_limits(
            got, ref.decode_attention_ref(q, kc, vc, ln, softcap=cap),
            want32)
        assert ok, (err, rerr)
        assert (lse - want_lse).abs().max().item() <= 1e-3
        assert torch.equal(got, ops.decode_attention(q, kc, vc, ln,
                                                     softcap=cap))
