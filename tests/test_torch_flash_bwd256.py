"""The bf16 flash backward at D = 256 on the tensor cores
(``csrc/flash_attention_bwd.cu``, ``bwd_dkdv_wgmma256_kernel`` and
``bwd_dq_wgmma256_kernel``).

On the CPU: ``kernels/flash_attention_bwd.plan(256, bf16)`` and the grids
the kernel lint models at recurrentgemma-2b's training shape and at the
card check's B 1 shape; and a plain simulation of the route's arithmetic
held against ``jax.vjp`` of the reference's attention
(``repro.models.layers.dense_attention``) at the bf16 limits of
``tests/test_torch_flash_bwd.py`` (``parity.bwd_within_limits``), at 10
query heads over 1 KV head, D 256, a window, ragged lengths, rows that
attend no key, a soft cap and a query offset, beside simulated faults that
the limits must reject (the window dropped, the cap dropped, a head of the
group skipped).  The simulation walks the kernels' blocks: a dK/dV block
per 64 keys and share of its group's heads (``heads_per_block``), each
head over the 64-row query tiles that see its keys, the shares' fp32
partials added in split order; a dQ block per 64 rows over the key tiles
the forward walks; S^T and dP^T (S and dP) in fp32, P and dS formed in
fp32 and rounded to bf16 a tile at a time, and each warpgroup's half of
D summed in fp32 on its own.  The ``gpu``-marked cases hold the kernel to the plain
version on the card (they skip without one): ``PYTHONPATH=src python -m
pytest -q -m gpu tests/test_torch_flash_bwd256.py``."""
import math

import numpy as np
import pytest
import torch

from repro_torch.analysis import kernel_lint
from repro_torch.analysis.findings import has_errors
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, parity, ref

D = 256
ROWS = 64              # keys of a dK/dV block, rows of a dQ block, and tiles
HALF = D // 2          # the columns a warpgroup accumulates
LOG2E = 1.0 / math.log(2.0)
NO_WINDOW = 1 << 30    # the general kernels' window when there is none

# (what, H, KV, Sq, Skv, causal, window, softcap, q_offset)
CASES = [
    ("window, ragged", 10, 1, 150, 150, True, 70, 0.0, 0),
    ("cap, offset, rows with no key", 10, 1, 130, 100, True, 40, 2.0, 20),
    ("non-causal, Sq < Skv", 10, 1, 70, 150, False, 0, 0.0, 0),
]
# each fault on the case that has what it drops
FAULTS = [("window dropped", 0), ("cap dropped", 1), ("head skipped", 0)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _inputs(case, seed):
    """q, k, v, do as numpy [1, S, heads, 256], rounded to bf16."""
    _, h, kv, sq, skv = case[:5]
    rng = np.random.default_rng(seed)

    def t(s, n):
        x = torch.from_numpy(rng.standard_normal((1, s, n, D), np.float32))
        return _bf16(x).numpy()
    return t(sq, h), t(skv, kv), t(skv, kv), t(sq, h)


def _heads(x: np.ndarray) -> torch.Tensor:
    """[1, S, heads, D] -> [heads, S, D]."""
    return torch.from_numpy(x[0].transpose(1, 0, 2).copy())


def _p_ds(s, dp, l2, delta, keep, scale, softcap):
    """P and dS of a tile [rows, keys] in fp32 from its raw scores s and
    dP, its rows' L2 and Delta: the kernels' ``prob``, masked entries 0,
    dS times the cap's derivative."""
    if softcap > 0:
        t = torch.tanh(s * (scale / softcap))
        p = torch.exp2(t * (softcap * LOG2E) - l2[:, None])
        dcap = 1.0 - t * t
    else:
        p = torch.exp2(s * (scale * LOG2E) - l2[:, None])
        dcap = 1.0
    p = torch.where(keep, p, 0.0)
    return p, p * (dp - delta[:, None]) * dcap


def simulate(q, k, v, o, do, lse, *, kv_group, causal, window=0,
             softcap=0.0, q_offset=0, skip_head=False, hpb=None):
    """(dq, dk, dv), bf16 values in fp32, as the D = 256 route computes
    them from q, o, do [BH, Sq, 256], k, v [BH / kv_group, Skv, 256] (bf16
    values in fp32) and the forward's L2 [BH, Sq], a dK/dV block walking
    ``hpb`` heads of the group (the wrapper's ``heads_per_block`` when
    None); ``skip_head``: the key tiles' dK and dV miss the group's last
    head (a fault)."""
    bh, sq, _ = q.shape
    n_kv, skv, _ = k.shape
    scale = 1.0 / math.sqrt(D)
    win = window or NO_WINDOW
    general = bool(window or softcap or q_offset)
    off = q_offset
    delta = (do * o).sum(-1)                       # the prep pass, fp32
    keep = ref._attention_mask(sq, skv, causal, window, "cpu", q_offset)
    dk = torch.zeros(n_kv, skv, D)
    dv = torch.zeros(n_kv, skv, D)
    dq = torch.zeros(bh, sq, D)
    halves = [slice(w * HALF, (w + 1) * HALF) for w in range(2)]
    if hpb is None:
        hpb = fab.heads_per_block(D, torch.bfloat16, bh, skv, kv_group)
    for g in range(n_kv):
        for k0 in range(0, skv, ROWS):
            ks = slice(k0, k0 + ROWS)
            qt0 = max(0, k0 - off) // ROWS if causal else 0
            q_end = min(sq, k0 + ROWS - 1 + win - off) if general else sq
            heads = list(range(g * kv_group, (g + 1) * kv_group))
            if skip_head:
                heads = heads[:-1]
            for h_lo in range(0, kv_group, hpb):    # a block each, in order
                part_k = torch.zeros(k[g, ks].shape)
                part_v = torch.zeros(k[g, ks].shape)
                for h in heads[h_lo:h_lo + hpb]:
                    for q0 in range(qt0 * ROWS, q_end, ROWS):
                        qs = slice(q0, q0 + ROWS)
                        st = k[g, ks] @ q[h, qs].T     # S^T: warpgroup 0
                        dpt = v[g, ks] @ do[h, qs].T   # dP^T: warpgroup 1
                        p, ds = _p_ds(st.T, dpt.T, lse[h, qs], delta[h, qs],
                                      keep[qs, ks], scale, softcap)
                        pa, dsa = _bf16(p.T), _bf16(ds.T)  # bf16 operands
                        for cols in halves:
                            part_v[:, cols] += pa @ do[h, qs, cols]
                            part_k[:, cols] += dsa @ q[h, qs, cols]
                dk[g, ks] += part_k
                dv[g, ks] += part_v
    for h in range(bh):
        g = h // kv_group
        for q0 in range(0, sq, ROWS):
            qs = slice(q0, q0 + ROWS)
            kv_end = min(skv, q0 + off + ROWS) if causal else skv
            j0 = max(0, q0 + off - win + 1) // ROWS if general else 0
            for k0 in range(j0 * ROWS, kv_end, ROWS):
                ks = slice(k0, k0 + ROWS)
                _, ds = _p_ds(q[h, qs] @ k[g, ks].T, do[h, qs] @ v[g, ks].T,
                              lse[h, qs], delta[h, qs], keep[qs, ks], scale,
                              softcap)
                dsa = _bf16(ds)
                for cols in halves:
                    dq[h, qs, cols] += dsa @ k[g, ks, cols]
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _jax_grads(q, k, v, do, **kw):
    """dq, dk, dv of ``jax.vjp`` of the reference's dense attention in
    fp32, as [heads, S, D] tensors."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    def grads(q, k, v, do):
        return jax.vjp(lambda q, k, v: jlayers.dense_attention(
            q, k, v, **kw), q, k, v)[1](do)
    return [_heads(np.asarray(g)) for g in jax.jit(grads)(
        *(jnp.asarray(x) for x in (q, k, v, do)))]


@pytest.fixture
def one_thread():
    """torch on one thread: the simulation's many small products run 50
    times slower with JAX's thread pool beside torch's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(case, seed, **fault):
    """(the simulation's gradients, ``jax.vjp``'s) at ``case``; the output
    gradient is 0 on rows that attend no key (the kernels give them P = 0
    where the reference's softmax spreads them over every key).  The
    simulation takes the plain forward's output in fp32, as ``jax.vjp``
    differentiates at it: Delta over a bf16 O would move dq by up to a
    fifth of a row's rms, rounding the card's check shares with its plain
    version (``parity.bwd_want32`` takes the kernel's O)."""
    _, h, kv, sq, skv, causal, window, softcap, q_offset = case
    q, k, v, do = _inputs(case, seed)
    keep = ref._attention_mask(sq, skv, causal, window, "cpu", q_offset)
    do = do * keep.any(-1).numpy()[None, :, None, None]
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    want = _jax_grads(q, k, v, do, **kw)
    tq, tk, tv, tdo = map(_heads, (q, k, v, do))
    o, lse = ref.mha_ref(tq, tk, tv, kv_group=h // kv, return_lse=True, **kw)
    if fault.pop("drop_window", False):
        kw["window"] = 0
    if fault.pop("drop_cap", False):
        kw["softcap"] = 0.0
    got = simulate(tq, tk, tv, o, tdo, lse, kv_group=h // kv, **kw,
                   **fault)
    return got, want


def test_plan():
    p = fab.plan(D, torch.bfloat16)
    assert p.route == "wgmma" and D in fab.WGMMA_HEAD_DIMS
    assert (p.dkdv_keys, p.dkdv_rows, p.dq_rows, p.dq_keys) == (ROWS,) * 4
    assert p.dkdv_rows == fab.STAT_ROWS
    assert p.dkdv_stages == p.dq_stages == 2
    tile = ROWS * D * 2
    # K and V, two stages of Q, dO and their statistics, the exchange
    assert p.dkdv_smem > 2 * tile + 2 * 2 * tile + fab.EXCHANGE_BYTES
    assert p.dq_smem > 2 * tile + 2 * 2 * tile + fab.EXCHANGE_BYTES
    assert max(p.dkdv_smem, p.dq_smem) <= fab.SMEM_LIMIT
    # fp32 keeps the CUDA cores at every head dim
    assert fab.plan(D, torch.float32).route == "cuda-cores"


@pytest.mark.parametrize("b,s,want", [(2, 4096, (128, 1280)),
                                      (1, 4096, (64, 640)),
                                      (4, 2048, (128, 1280))],
                         ids=["training B 2", "card check B 1", "S 2048"])
def test_grids(b, s, want):
    """recurrentgemma-2b's 10 query heads over 1 KV head: 64-key tiles of
    each KV head (128 at the training shape, under one wave of the 132
    SMs, the first half with twice the mean work under the window), each
    split over 5 dK/dV blocks of 2 heads (about 4 waves), merged; a dQ
    block per 64 rows of each head; the kernel lint's model of the three
    launches is clean."""
    assert fab.heads_per_block(D, torch.bfloat16, 10 * b, s, 10) == 2
    assert fab.heads_per_block(D, torch.float32, 10 * b, s, 10) == 10
    assert fab.heads_per_block(64, torch.bfloat16, 10 * b, s, 10) == 10
    models, findings = kernel_lint.flash_attention_bwd_model(
        bh=10 * b, sq=s, skv=s, d=D, dtype="bfloat16", kv_group=10)
    assert not findings
    grids = {m.name.split(".")[1]: m for m in models}
    p = fab.plan(D, torch.bfloat16)
    assert grids["dkdv"].grid[:2] == (want[0], 5)
    assert grids["dkdv"].merge_dims == (1,)
    assert grids["dq"].grid[0] == want[1]
    assert (grids["dkdv"].smem, grids["dq"].smem) == (p.dkdv_smem, p.dq_smem)
    assert all(m.threads == 256 for m in models)
    assert not has_errors(
        [f for m in models for f in kernel_lint.check_model(m)])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_simulation_matches_jax_vjp(case, one_thread):
    """On the split grid these small shapes take: a block a head."""
    assert fab.heads_per_block(D, torch.bfloat16, case[1], case[4],
                               case[1] // case[2]) == 1
    got, want = _run(case, seed=1)
    ok, err, rerr = parity.bwd_within_limits(got, want)
    assert ok, (err, rerr)
    # a row that attends no key gets no dq
    _, _, _, sq, skv, causal, window, _, q_offset = case
    none = ~ref._attention_mask(sq, skv, causal, window, "cpu",
                                q_offset).any(-1)
    assert none.any() == (case[0] == CASES[1][0])
    assert not got[0][:, none].any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_simulation_whole_group_matches_jax_vjp(case, one_thread):
    """With the KV head's whole group in one dK/dV block (the grid at many
    KV rows, as at ``test_unsplit_grid``'s shape): no partials to merge."""
    got, want = _run(case, seed=1, hpb=case[1] // case[2])
    ok, err, rerr = parity.bwd_within_limits(got, want)
    assert ok, (err, rerr)


def test_unsplit_grid():
    """Past about ``SPLIT_WAVES`` waves of key tiles (B 9 x S 4096 at one
    KV head: 576 tiles) a block walks its KV head's whole group: no merge
    and no scratch; a card of fewer SMs reaches it sooner."""
    assert fab.heads_per_block(D, torch.bfloat16, 90, 4096, 10) == 10
    assert fab.heads_per_block(D, torch.bfloat16, 80, 4096, 10) == 5
    assert fab.heads_per_block(D, torch.bfloat16, 80, 4096, 10, sms=66) == 10
    models, findings = kernel_lint.flash_attention_bwd_model(
        bh=90, sq=4096, skv=4096, d=D, dtype="bfloat16", kv_group=10)
    dkdv = next(m for m in models if ".dkdv." in m.name)
    assert not findings and dkdv.grid[:2] == (576, 1)
    assert dkdv.merge_dims == ()


@pytest.mark.parametrize("fault,case", FAULTS, ids=[f[0] for f in FAULTS])
def test_limits_reject_simulated_faults(fault, case, one_thread):
    flag = {"window dropped": "drop_window", "cap dropped": "drop_cap",
            "head skipped": "skip_head"}[fault]
    got, want = _run(CASES[case], seed=1, **{flag: True})
    ok, err, rerr = parity.bwd_within_limits(got, want)
    assert not ok, (fault, err, rerr)


# ---------------------------------------------------------------------------
# on the card: the D = 256 kernels against the plain version
# ---------------------------------------------------------------------------

# (BH, KV rows, Sq, Skv, causal, window, softcap, q_offset): 10 query heads
# a KV head (recurrentgemma-2b), ragged against the 64-row tiles, B 2,
# windows, non-causal Sq != Skv, rows with no key, the cap and the offset
GPU_CASES = [
    (10, 1, 300, 300, True, 0, 0.0, 0),
    (20, 2, 257, 257, True, 100, 0.0, 0),
    (10, 1, 150, 333, False, 0, 0.0, 0),
    (10, 1, 333, 150, False, 0, 0.0, 0),
    (10, 1, 200, 130, True, 40, 2.0, 30),
    (4, 4, 190, 190, True, 0, 2.0, 0),
    # 33 KV rows of 16 key tiles, four waves of an H100's 132 SMs: each
    # block walks its whole group (no merge)
    (330, 33, 1024, 1024, True, 300, 0.0, 0),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_cuda_backward_256_matches_plain_version(case):
    _card()
    bh, n_kv, sq, skv, causal, window, softcap, q_offset = case
    gen = torch.Generator().manual_seed(7)

    def t(n, s):
        return torch.randn(n, s, D, generator=gen).to("cuda", torch.bfloat16)
    q, k, v, do = t(bh, sq), t(n_kv, skv), t(n_kv, skv), t(bh, sq)
    kw = dict(causal=causal, kv_group=bh // n_kv, window=window,
              softcap=softcap, q_offset=q_offset)
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == 2
    for g, a in zip(got, again):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
    ok, err, rerr = parity.bwd_within_limits(
        got, parity.bwd_want32(q, k, v, o, do, **kw))
    assert ok, (err, rerr)
