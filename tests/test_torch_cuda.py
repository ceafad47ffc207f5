"""The CUDA kernels against their plain versions on the card, at the shapes
and tolerances of tests/test_kernels.py plus ragged lengths, grouped heads
and per-slot cache lengths, and the serving path on the card at a small
size.  Imports no jax: run it on the card with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, parity, ref


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(3)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    gen = _card()

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    ops.reset_launch_counts()
    for m, k, n in [(32, 32, 32), (100, 70, 130), (128, 256, 64),
                    (17, 19, 23)]:
        for tdt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a, b = randn(m, k).to(tdt), randn(k, n).to(tdt)
            torch.testing.assert_close(ops.matmul(a, b).float(),
                                       ref.matmul_ref(a, b).float(),
                                       rtol=tol, atol=tol)
    for f, n, k, bn in [(2, 128, 8, 32), (4, 300, 16, 64), (8, 256, 32, 128),
                        (1, 512, 4, 256), (4, 1000, 200, 128)]:
        x, h = randn(f, n), randn(f, k)
        torch.testing.assert_close(ops.tdfir(x, h, block_n=bn),
                                   ref.tdfir_ref(x, h), rtol=3e-4, atol=3e-4)
    xr, xi, hr, hi = randn(2, 128), randn(2, 128), randn(2, 8), randn(2, 8)
    for got, want in zip(ops.tdfir_complex(xr, xi, hr, hi, block_n=64),
                         ref.tdfir_complex_ref(xr, xi, hr, hi)):
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    torch.cuda.synchronize()
    # one launch per tdfir_complex call
    assert ops.launch_counts() == {"matmul": 8, "tdfir": 6,
                                   "flash_attention": 0,
                                   "decode_attention": 0}


@pytest.mark.gpu
def test_cuda_attention_kernels_match_plain_versions():
    gen = _card()

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    ops.reset_launch_counts()
    # fp32 (CUDA cores) at 2e-4 and bf16 (tensor cores) at 5e-2
    for bh, s, d in [(2, 64, 16), (3, 128, 32), (1, 96, 64)]:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 5e-2)):
            q, k, v = (randn(bh, s, d, dtype=dtype) for _ in range(3))
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ref.mha_ref(q, k, v, causal=causal)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                if dtype == torch.bfloat16:
                    assert parity.row_err(got, want) <= parity.BF16_ROW_TOL
    # grouped heads (rep 4), ragged S, as strided [B*H, S, D] views
    for s, dtype, tol in ((77, torch.float32, 2e-4),
                          (200, torch.bfloat16, 5e-2)):
        q = randn(1, s, 8, 64, dtype=dtype).transpose(1, 2).reshape(8, s, 64)
        k, v = (randn(1, s, 2, 64, dtype=dtype).transpose(1, 2)
                .reshape(2, s, 64) for _ in range(2))
        got = ops.flash_attention(q, k, v, kv_group=4)
        want = ref.mha_ref(q, k, v, kv_group=4)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if dtype == torch.bfloat16:
            assert parity.row_err(got, want) <= parity.BF16_ROW_TOL
    for bh, s, d, clen in [(4, 256, 64, 256), (2, 512, 32, 300),
                           (1, 128, 128, 1)]:
        q = randn(bh, 1, d)
        kc, vc = randn(bh, s, 1, d), randn(bh, s, 1, d)
        torch.testing.assert_close(
            ops.decode_attention(q, kc, vc, clen),
            ref.decode_attention_ref(q, kc, vc, clen), rtol=2e-4, atol=2e-4)
    lens = torch.tensor([1, 129, 255, 300], dtype=torch.int32, device="cuda")
    q, kc, vc = randn(4, 8, 32), randn(4, 300, 2, 32), randn(4, 300, 2, 32)
    torch.testing.assert_close(ops.decode_attention(q, kc, vc, lens),
                               ref.decode_attention_ref(q, kc, vc, lens),
                               rtol=2e-4, atol=2e-4)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"matmul": 0, "tdfir": 0,
                                   "flash_attention": 14,
                                   "decode_attention": 4}
    # no keys: the plain version's zeros, without a launch (a tensor map
    # cannot describe an empty dim)
    q = randn(2, 8, 64, dtype=torch.bfloat16)
    kv = randn(2, 0, 64, dtype=torch.bfloat16)
    assert torch.equal(ops.flash_attention(q, kv, kv, causal=False),
                       ref.mha_ref(q, kv, kv, causal=False))
    assert ops.launch_counts()["flash_attention"] == 14
    with pytest.raises(ValueError, match="head dim"):
        x = randn(2, 16, 48)
        ops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(randn(1, 2, 48), randn(1, 8, 2, 48),
                             randn(1, 8, 2, 48), 4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", parity.SWEEP_D)
@pytest.mark.parametrize("s", parity.SWEEP_S)
def test_bf16_tensor_core_flash_matches_plain_version(d, s):
    """The wgmma/TMA kernel against the plain version at 5e-2 and at the
    row-scaled limit: every head dim, lengths around and past the 128-row
    tiles, causal and not, and kv_group 1 and 4 on strided [B*H, S, D]
    views of [B, S, H, D]."""
    gen = _card()
    ops.reset_launch_counts()
    for rep, causal, q, k, v in parity.sweep_cases(gen, d, s):
        got = ops.flash_attention(q, k, v, causal=causal, kv_group=rep)
        want = ref.mha_ref(q, k, v, causal=causal, kv_group=rep)
        assert got.dtype == torch.bfloat16 and got.shape == (8, s, d)
        ok, err, rerr = parity.within_limits(got, want)
        assert ok, (d, s, rep, causal, err, rerr)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 4


@pytest.mark.gpu
def test_bf16_flash_refuses_misaligned_views():
    """TMA needs 16-byte aligned bases and strides: a misaligned bf16 view
    raises and launches nothing (fp32 takes the CUDA-core kernel, which
    has no such rule)."""
    gen = _card()
    x = torch.randn(2, 64, 72, generator=gen).cuda()
    ops.reset_launch_counts()
    rows_136_bytes_apart = x[..., :68].to(torch.bfloat16)[..., :64]
    base_8_bytes_in = x.to(torch.bfloat16)[..., 4:68]
    for bad in (rows_136_bytes_apart, base_8_bytes_in):
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(bad, bad, bad)
    assert ops.launch_counts()["flash_attention"] == 0
    f32 = x[..., 1:65]
    torch.testing.assert_close(ops.flash_attention(f32, f32, f32),
                               ref.mha_ref(f32, f32, f32), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.gpu
def test_serving_on_the_card_matches_generate():
    """Reduced granite in fp32 on the card: the continuous batcher's tokens
    equal batch-1 generate's, through both attention kernels."""
    _card()
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import LM, init_params
    from repro_torch.serve import ContinuousBatcher, Request
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                              n_layers=3)
    lm = LM(cfg, init_params(cfg, torch.Generator("cuda").manual_seed(0)))
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in (9, 40, 17)]
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=64)
    ops.reset_launch_counts()
    out = engine.run([Request(rid=f"r{i}", arch=cfg.name,
                              prompt_len=len(t), max_gen=6, tokens=t,
                              arrival_s=i * engine.tick_s)
                      for i, t in enumerate(toks)])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 3 * 3
    assert counts["decode_attention"] == 3 * engine.calls["decode_step"]
    for i, t in enumerate(toks):
        want = generate(lm, {"tokens": torch.from_numpy(t[None])}, len(t),
                        6, 64)
        assert np.array_equal(out[f"r{i}"], want[0].cpu().numpy()), i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(512, 512, 512), (513, 1001, 511),
                                   (64, 4, 64), (64, 3, 64), (64, 528, 64)])
def test_cuda_matmul_main_and_ragged_shapes(m, k, n, dtype, tol):
    """3mm's 512^3; M, N and K ragged with rows that are not 16-byte
    aligned (4-byte copies); K of one or under one 16-byte vector; K slabs
    shared unequally by a block's warps.  fp32 at 1e-4 (sums of up to 1001
    products), bf16 at 2e-2."""
    gen = _card()
    a = torch.randn(m, k, generator=gen).to("cuda", dtype)
    b = torch.randn(k, n, generator=gen).to("cuda", dtype)
    ops.reset_launch_counts()
    got = ops.matmul(a, b)
    torch.testing.assert_close(got.float(), ref.matmul_ref(a, b).float(),
                               rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul"] == 1


_WRAP_LENS = (1, 17, 300, 640, 1000, 2111, 2112, 2500) * 8


def _decode_case(gen, dtype, b, h, kv, s, d, lens):
    def randn(*shape):
        return torch.randn(shape, generator=gen).to("cuda", dtype)
    return (randn(b, h, d), randn(b, s, kv, d), randn(b, s, kv, d),
            torch.tensor(lens, dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("case", ["around_split", "all_one", "clamped",
                                  "wide_head", "ring_wrap"])
def test_cuda_decode_split_boundaries(case, dtype, tol):
    """The serving pool's [4, 2112, 8, 64] cache at lengths one below, at
    and one above the plan's split size and at S, every slot at length 1,
    a length past S (clamped to S); D=128 with 8 query heads a KV head;
    and a 64-slot pool, one split a row, so each warp's cp.async ring wraps
    many times.  bf16 is also held to the row-scaled limit against the
    plain version in fp32 (``kernels/parity.py``)."""
    from repro_torch.kernels import decode_attention as da
    gen = _card()
    b, h, kv, s, d = 4, 32, 8, 2112, 64
    c = da.plan(b * kv, s, da.KEY_TILE[dtype]).chunk
    shape, lens = {
        "around_split": ((b, h, kv, s, d), (c - 1, c, c + 1, s)),
        "all_one": ((b, h, kv, s, d), (1, 1, 1, 1)),
        "clamped": ((b, h, kv, s, d), (s + 100, 1, 2 * c, 2 * c + 1)),
        "wide_head": ((2, 64, 8, 700, 128), (1, 699)),
        "ring_wrap": ((64, h, kv, s, d), _WRAP_LENS),
    }[case]
    q, kc, vc, ln = _decode_case(gen, dtype, *shape, lens)
    if case == "ring_wrap":
        p = da.plan(64 * kv, s, da.KEY_TILE[dtype])
        # each warp's 3-stage ring wraps at least five times
        assert p.chunk // da.KEY_TILE[dtype] >= 5 * 3 * 8
    ops.reset_launch_counts()
    got = ops.decode_attention(q, kc, vc, ln)
    torch.testing.assert_close(got.float(),
                               ref.decode_attention_ref(q, kc, vc, ln).float(),
                               rtol=tol, atol=tol)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 1
    if dtype == torch.bfloat16:
        want32 = parity.decode_want32(q, kc, vc, ln)
        assert parity.row_err(got, want32) <= parity.DECODE_ROW_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_decode_repeats_bit_for_bit(dtype):
    """The splits merge in a fixed order and the kernel leaves its merge
    counters at zero: the same call gives the same bits, also after a call
    of another shape has used the same scratch; so does a 64-slot pool
    whose warps wrap their rings."""
    gen = _card()
    q, kc, vc, ln = _decode_case(gen, dtype, 4, 32, 8, 2112, 64,
                                 (1, 300, 1000, 2112))
    first = ops.decode_attention(q, kc, vc, ln)
    assert torch.equal(first, ops.decode_attention(q, kc, vc, ln))
    other = _decode_case(gen, dtype, 2, 16, 4, 700, 128, (5, 699))
    ops.decode_attention(*other)
    assert torch.equal(first, ops.decode_attention(q, kc, vc, ln))
    wrap = _decode_case(gen, dtype, 64, 32, 8, 2112, 64, _WRAP_LENS)
    assert torch.equal(ops.decode_attention(*wrap),
                       ops.decode_attention(*wrap))


@pytest.mark.gpu
def test_cuda_decode_refuses_misaligned_caches():
    """The kernel copies 16 bytes at a time: a cache whose base is not
    16-byte aligned raises and launches nothing."""
    gen = _card()
    flat = torch.randn(1 + 64 * 2 * 32, generator=gen).cuda()
    kc = flat[1:].view(1, 64, 2, 32)           # 4 bytes past an alignment
    q = torch.randn(1, 4, 32, generator=gen).cuda()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.decode_attention(q, kc, kc, 10)
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("f,n,k", parity.tdfir_edges())
def test_cuda_tdfir_blocked_loop_edges(f, n, k):
    """tdfir and its one-launch complex form against their plain versions
    at 3e-4, at the edges of the blocked tap loop and at the most taps each
    form takes (taps scaled to unit gain there: sums of thousands of
    unit-scale fp32 products differ between two orders by more than
    3e-4)."""
    from repro_torch.kernels import tdfir as fir
    gen = _card()
    scale = k ** -0.5 if k > 256 else 1.0

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    x, xi = randn(f, n), randn(f, n)
    h, hi = randn(f, k) * scale, randn(f, k) * scale
    ops.reset_launch_counts()
    torch.testing.assert_close(ops.tdfir(x, h), ref.tdfir_ref(x, h),
                               rtol=3e-4, atol=3e-4)
    launched = 1
    if k <= fir.max_taps(2):
        for got, want in zip(ops.tdfir_complex(x, xi, h, hi),
                             ref.tdfir_complex_ref(x, xi, h, hi)):
            torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
        launched = 2
    torch.cuda.synchronize()
    assert ops.launch_counts()["tdfir"] == launched


@pytest.mark.gpu
def test_cuda_tdfir_complex_is_four_real_launches_bitwise():
    """At the planner's F=64, N=4096, K=128 the one complex launch gives the
    bits of four real launches and torch's fp32 combine: each output sums
    its taps in ascending order with fmaf in both kernels."""
    gen = _card()
    xr, xi = (torch.randn(64, 4096, generator=gen).cuda() for _ in range(2))
    hr, hi = (torch.randn(64, 128, generator=gen).cuda() * 0.1
              for _ in range(2))
    ops.reset_launch_counts()
    y_re, y_im = ops.tdfir_complex(xr, xi, hr, hi, block_n=128)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tdfir"] == 1
    assert torch.equal(y_re, ops.tdfir(xr, hr) - ops.tdfir(xi, hi))
    assert torch.equal(y_im, ops.tdfir(xr, hi) + ops.tdfir(xi, hr))


@pytest.mark.gpu
def test_cuda_tdfir_refuses_taps_past_its_limit():
    """Taps and windows past 227 KB of shared memory raise before a
    launch."""
    from repro_torch.kernels import tdfir as fir
    gen = _card()
    x = torch.randn(2, 64, generator=gen).cuda()
    h = torch.randn(2, fir.max_taps(1) + 4, generator=gen).cuda()
    hc = h[:, :fir.max_taps(2) + 4].contiguous()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="taps"):
        ops.tdfir(x, h)
    with pytest.raises(ValueError, match="taps"):
        ops.tdfir_complex(x, x, hc, hc)
    assert ops.launch_counts()["tdfir"] == 0
