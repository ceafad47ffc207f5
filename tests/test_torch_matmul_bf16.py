"""The bf16 matmul's host side on the CPU: ``matmul.bf16_plan`` (the route
follows what TMA can map; every output tile is one block's and every K
tile one stage's; the grid fills the card at 512^3 and takes wide tiles
at granite-3-2b's MLP up-projection; every route fits a block's shared
memory), a plain simulation of the kernels' blocked walk (their tiles in
``tile_of``'s order, fp32 sums over 64-deep K tiles, rounded once)
against the Pallas matmul in interpret mode, the card's 2e-2 limit
against the simulated faults of ``parity.matmul_fault_controls``, and
the kernel lint over the plan's launches (and a broken tile order it
must catch).  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul as jax_mm
from repro_torch.analysis import has_errors
from repro_torch.analysis import kernel_lint as kl
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, parity, ref

MAX_SMEM = 232448                   # 227 KB: a block's opt-in shared memory
MLP_UP = (8192, 2048, 8192)         # (M, K, N): granite-3-2b, B 4 x S 2048

SHAPES = [(512, 512, 512), MLP_UP, (2048, 2048, 2048), (513, 1001, 511),
          (64, 3, 64), (64, 528, 64), (200, 136, 264), (1, 8, 8),
          (1000, 64, 1032), (17, 19, 23)]


def _blocks_of(p):
    return [mm.tile_of(p, x) for x in range(p.blocks)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_bf16_plan_covers_each_tile_and_k_tile_once(m, k, n):
    p = mm.bf16_plan(m, n, k)
    t = p.tile
    assert p.grid_m * t.tile_m >= m > (p.grid_m - 1) * t.tile_m
    assert p.grid_n * t.tile_n >= n > (p.grid_n - 1) * t.tile_n
    owners = np.zeros((p.grid_m, p.grid_n), np.int64)
    for tm, tn in _blocks_of(p):
        owners[tm, tn] += 1
    assert (owners == 1).all()
    # the numpy form of the tile order is the integer form
    tm, tn = mm.tile_of(p, np.arange(p.blocks))
    assert list(zip(tm.tolist(), tn.tolist())) == _blocks_of(p)
    # the ring walks K tiles 0, 1, ..., each once; the last one's columns
    # past K are TMA's zeros
    k_seen = np.zeros(-(-k // mm.TMA_K) * mm.TMA_K, np.int64)
    for s in range(-(-k // mm.TMA_K)):
        k_seen[s * mm.TMA_K:(s + 1) * mm.TMA_K] += 1
    assert (k_seen == 1).all() and len(k_seen) - k < mm.TMA_K


def test_bf16_plan_fills_the_card_and_fits_a_block():
    small = mm.bf16_plan(512, 512, 512)
    assert small.route == "small" and small.blocks >= 64
    big = mm.bf16_plan(MLP_UP[0], MLP_UP[2], MLP_UP[1])
    assert big.tile.tile_m >= 128 and big.tile.tile_n >= 128
    assert big.blocks >= mm.WIDE_BLOCKS
    for route, t in mm.BF16_ROUTES.items():
        assert t.smem <= MAX_SMEM and t.threads <= 1024
        # each stage's boxes on 1024-byte (swizzle pattern) boundaries
        assert (2 * mm.TMA_K * t.tile_m) % 1024 == 0
        assert t.smem >= 1024 + t.stages * 2 * mm.TMA_K * (t.tile_m
                                                            + t.tile_n)
        if route == "unaligned":     # one warpgroup, two stages
            assert (t.tile_m, t.tile_n, t.stages, t.threads) == (64, 64, 2,
                                                                 128)
        else:                        # a TMA ring and its producer warp
            assert t.stages >= 3 and t.threads == 2 * t.tile_m + 32


@pytest.mark.parametrize("m,k,n,pa,pb,route", [
    (512, 512, 512, 0, 0, "small"),
    (512, 512, 512, 2, 0, "unaligned"),   # A's base not 16-byte aligned
    (512, 512, 512, 0, 8, "unaligned"),   # B's neither
    (512, 511, 512, 0, 0, "unaligned"),   # A's rows: K % 8 != 0
    (512, 512, 508, 0, 0, "unaligned"),   # B's rows: N % 8 != 0
    (512, 0, 512, 0, 0, "unaligned"),     # no K to map
    (513, 512, 520, 0, 0, "small"),       # ragged M and N: masked, mapped
    (2048, 2048, 2048, 0, 0, "wide"),     # 128 blocks of 128 x 256
    (1024, 1024, 1024, 0, 0, "small"),    # 32 of them: 256 of 64 x 64
    (*MLP_UP, 0, 0, "wide"),
])
def test_bf16_route_follows_alignment(m, k, n, pa, pb, route):
    base = 1 << 20
    ok = mm.bf16_mappable(n, k, base + pa, base + pb)
    assert mm.bf16_plan(m, n, k, ok).route == route
    assert mm.bf16_plan(m, n, k, False).route == "unaligned"


def _simulated_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' walk in plain torch: each block of the plan, in
    ``tile_of``'s order, sums its tile over 64-deep K tiles (zeros past
    the edges, as TMA or the unaligned route's loads fill them) in fp32
    and rounds once to bf16."""
    m, k = a.shape
    n = b.shape[1]
    p = mm.bf16_plan(m, n, k)
    bm, bn, tk = p.tile.tile_m, p.tile.tile_n, mm.TMA_K
    n_k = -(-k // tk)
    ap = torch.zeros(p.grid_m * bm, n_k * tk)
    bp = torch.zeros(n_k * tk, p.grid_n * bn)
    ap[:m, :k], bp[:k, :n] = a.float(), b.float()
    out = torch.empty(p.grid_m * bm, p.grid_n * bn, dtype=torch.bfloat16)
    for tm, tn in _blocks_of(p):
        rows, cols = slice(tm * bm, (tm + 1) * bm), slice(tn * bn,
                                                          (tn + 1) * bn)
        acc = torch.zeros(bm, bn)
        for s in range(n_k):
            ks = slice(s * tk, (s + 1) * tk)
            acc += ap[rows, ks] @ bp[ks, cols]
        out[rows, cols] = acc.to(torch.bfloat16)
    return out[:m, :n]


@pytest.mark.parametrize("m,k,n", [(32, 32, 32), (128, 256, 64),
                                   (100, 72, 136), (200, 136, 264),
                                   (100, 70, 130), (17, 19, 23)])
def test_simulated_kernel_matches_the_pallas_matmul(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k), np.float32)
    b = rng.standard_normal((k, n), np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = np.asarray(jax_mm.matmul(ja, jb, block_m=32, block_n=32,
                                    block_k=32, interpret=True), np.float32)
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).bfloat16()
    tb = torch.tensor(np.asarray(jb.astype(jnp.float32))).bfloat16()
    got = _simulated_kernel(ta, tb)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    assert parity.matmul_within(got, ref.matmul_ref(ta, tb))


@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (128, 2048, 256),
                                   (64, 528, 64), (513, 1001, 511)])
def test_bf16_limit_rejects_simulated_faults(m, k, n):
    gen = torch.Generator().manual_seed(30)
    a = torch.randn(m, k, generator=gen).bfloat16()
    b = torch.randn(k, n, generator=gen).bfloat16()
    want = ref.matmul_ref(a, b)
    assert parity.matmul_within(_simulated_kernel(a, b), want)
    faults = parity.matmul_fault_controls(a, b)
    assert len(faults) == 2
    for what, got in faults.items():
        assert not parity.matmul_within(got, want), what


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_lint_is_clean_on_bf16_launches(m, k, n):
    models, errs = kl.matmul_model(m, n, k, dtype="bfloat16")
    findings = errs + [f for mod in models for f in kl.check_model(mod)]
    assert not has_errors(findings), [f.message for f in findings]
    (model,) = models
    p = mm.bf16_plan(m, n, k)
    assert model.threads == p.tile.threads and model.smem == p.tile.smem
    assert model.grid[0] * model.grid[1] == p.blocks


def test_kernel_lint_catches_a_broken_tile_order(monkeypatch):
    """A tile order without the last group's row clamp: blocks of the
    ragged last group run off the grid and others are never written."""
    def broken(p, block):
        per_group = mm.GROUP_M * p.grid_n
        first = block // per_group * mm.GROUP_M
        i = block % per_group
        return first + i % mm.GROUP_M, i // mm.GROUP_M

    monkeypatch.setattr(mm, "tile_of", broken)
    models, _ = kl.matmul_model(700, 1032, 64, dtype="bfloat16")
    assert mm.bf16_plan(700, 1032, 64).grid_m % mm.GROUP_M != 0
    findings = [f for mod in models for f in kl.check_model(mod)]
    assert {f.rule_id for f in findings if f.severity == "error"} & \
        {"K001", "K002"}
