"""The CUDA kernels against their plain versions on the card, at the shapes
and tolerances of tests/test_kernels.py plus ragged lengths, grouped heads,
per-slot cache lengths, sliding windows, head dims 80 and 256 (10 query
heads over one KV head), and the serving path on the card at a small
size: the engine's captured decode step against the eager step (the
recurrent and cross-attention families' too), launch counts across
graph replays, and windowed serving against ``generate``; non-causal flash
over a context of another length and decode over whole contexts at 8
query heads a KV head.  Imports no jax: run it on the card with
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
                                   "decode_attention": 0,
                                   "flash_attention_bwd": 0}


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
                                   "decode_attention": 4,
                                   "flash_attention_bwd": 0}
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


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,route", [
    (512, 512, 512, "small"), (8192, 2048, 8192, "wide"),
    (2048, 2048, 2048, "wide"), (513, 1001, 511, "unaligned"),
    (64, 3, 64, "unaligned"), (200, 136, 264, "small")])
def test_cuda_bf16_matmul_routes(m, k, n, route):
    """The bf16 matmul on each route of ``matmul.bf16_plan``: 3mm's 512^3
    (64 x 64 tiles), granite-3-2b's MLP up-projection and 2048^3 (128 x
    256), ragged M and N through TMA, and operands TMA
    cannot map (registers fill the stages): within 2e-2 of the plain
    version, the same bits on a second call, one launch a call, and the
    limit rejects the simulated faults."""
    from repro_torch.kernels import matmul as mm
    gen = _card()
    a = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    b = torch.randn(k, n, generator=gen).to("cuda", torch.bfloat16)
    assert mm.bf16_plan(m, n, k, mm.bf16_mappable(
        n, k, a.data_ptr(), b.data_ptr())).route == route
    ops.reset_launch_counts()
    got, again = ops.matmul(a, b), ops.matmul(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul"] == 2
    want = ref.matmul_ref(a, b)
    assert parity.matmul_within(got, want)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    for what, bad in parity.matmul_fault_controls(a, b).items():
        assert not parity.matmul_within(bad, want), what


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
    c = da.plan(b, h, kv, s, d, dtype).chunk
    shape, lens = {
        "around_split": ((b, h, kv, s, d), (c - 1, c, c + 1, s)),
        "all_one": ((b, h, kv, s, d), (1, 1, 1, 1)),
        "clamped": ((b, h, kv, s, d), (s + 100, 1, 2 * c, 2 * c + 1)),
        "wide_head": ((2, 64, 8, 700, 128), (1, 699)),
        "ring_wrap": ((64, h, kv, s, d), _WRAP_LENS),
    }[case]
    q, kc, vc, ln = _decode_case(gen, dtype, *shape, lens)
    if case == "ring_wrap":
        p = da.plan(64, h, kv, s, d, dtype)
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


# ---- the dense family: sliding windows, D = 80, the captured decode step --

# (D, S, window): h2o-danube's prefill (S=5000 past its 4096 window, and
# the same without one), a window under one 128-key tile, a window past S,
# S off the tile grid with a window that straddles tiles, D=64 and D=128
_WINDOW_CASES = [(80, 5000, 4096), (80, 5000, 0), (80, 300, 50),
                 (80, 300, 1000), (80, 777, 200), (64, 1000, 130),
                 (128, 450, 129), (80, 1, 7)]


def _flash_views(gen, dtype, s, d, h=32, kv=8):
    """q/k/v as ``layers.attention`` hands them over: [B*H, S, D] strided
    views of [1, S, H, D] projections."""
    def heads(n):
        return torch.randn(1, s, n, d, generator=gen).to(
            "cuda", dtype).transpose(1, 2).reshape(n, s, d)
    return heads(h), heads(kv), heads(kv), h // kv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,s,window", _WINDOW_CASES)
def test_cuda_flash_window_and_d80_match_plain_version(d, s, window, dtype):
    """Windowed and D=80 causal flash attention (H=32 over KV=8) against
    the plain version with the same window: bf16 at the absolute and
    row-scaled limits, fp32 at 2e-4; one launch a call."""
    gen = _card()
    q, k, v, rep = _flash_views(gen, dtype, s, d)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, kv_group=rep, window=window)
    want = ref.mha_ref(q, k, v, kv_group=rep, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == (32, s, d) and got.dtype == dtype
    if dtype == torch.bfloat16:
        ok, err, rerr = parity.within_limits(got, want)
        assert ok, (err, rerr)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,s", [(64, 1000), (80, 777), (128, 300)])
def test_cuda_flash_window_past_s_is_no_window_bitwise(d, s, dtype):
    """A window of S or more masks nothing, and the kernel then gives
    window=0's bits: the walk starts at key 0 and the window compare only
    touches padding rows."""
    gen = _card()
    q, k, v, rep = _flash_views(gen, dtype, s, d)
    none = ops.flash_attention(q, k, v, kv_group=rep)
    for w in (s, s + 1, 10 * s):
        assert torch.equal(none, ops.flash_attention(q, k, v, kv_group=rep,
                                                     window=w)), w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("shape,lens", [
    ((4, 32, 8, 4096, 80), (1, 1000, 4096, 4096)),   # h2o-danube's pool
    ((3, 32, 8, 300, 80), (1, 17, 300)),
    ((2, 96, 8, 700, 128), (5, 699)),                 # command-r+'s group
])
def test_cuda_decode_d80_and_wide_groups_match_plain_version(shape, lens,
                                                             dtype, tol):
    """Decode at D=80 (10 or 20 16-byte chunks a row on 16 or 32 lanes, the
    rest zeros) and at 12 query heads a KV head, against the plain version;
    bf16 also at the row-scaled limit; two calls bitwise equal."""
    gen = _card()
    q, kc, vc, ln = _decode_case(gen, dtype, *shape, lens)
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
    assert torch.equal(got, ops.decode_attention(q, kc, vc, ln))


def _small_lm(arch, **over):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, init_params
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    return LM(cfg, init_params(cfg, torch.Generator("cuda").manual_seed(0)))


@pytest.mark.gpu
def test_cuda_graph_step_matches_eager_step():
    """The engine's captured decode step, replayed over its pool, against
    the eager step over a copy of the same pool (fp32): logits within
    1e-5, the same cache writes."""
    _card()
    from repro_torch.serve import ContinuousBatcher
    lm = _small_lm("granite-3-2b", n_layers=3)
    engine = ContinuousBatcher(lm, n_slots=3, cache_len=64)
    assert engine.graph is not None
    gen = torch.Generator("cuda").manual_seed(5)
    for buf in engine.pool["attn"].values():
        buf.copy_(torch.randn(buf.shape, generator=gen, device="cuda"))
    eager_pool = {"attn": {k: v.clone() for k, v in
                           engine.pool["attn"].items()}}
    engine._last_tok[:] = [3, 17, 250]
    engine._pos[:] = [5, 40, 63]
    logits = engine._step().clone()
    want, _ = lm.decode_step(eager_pool, torch.tensor([[3], [17], [250]],
                                                      device="cuda"),
                             torch.tensor([5, 40, 63], device="cuda"))
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(engine.pool["attn"][name],
                                   eager_pool["attn"][name], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.gpu
def test_cuda_graph_replays_count_launches():
    """A capture takes back the launches it recorded and every replay adds
    them: decode once per layer and step across replays, as eager steps
    count."""
    _card()
    from repro_torch.serve import ContinuousBatcher
    lm = _small_lm("granite-3-2b", n_layers=3)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=32)
    assert engine.graph.launches == {"matmul": 0, "tdfir": 0,
                                     "flash_attention": 0,
                                     "decode_attention": 3,
                                     "flash_attention_bwd": 0}
    ops.reset_launch_counts()
    engine._active[:] = True
    for _ in range(5):
        engine._step()
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == 3 * 5
    assert engine.calls["decode_step"] == 5


@pytest.mark.gpu
def test_cuda_graphs_hold_their_own_decode_scratch():
    """Two engines' graphs each hold decode scratch of their own, so
    replays of one between replays of the other give the eager step's
    logits; a capture of decode attention outside ``CountedGraph`` raises
    before it launches."""
    _card()
    from repro_torch.serve import ContinuousBatcher
    lm = _small_lm("granite-3-2b", n_layers=2)
    engines = [ContinuousBatcher(lm, n_slots=2, cache_len=48)
               for _ in range(2)]
    (part_a, _), = engines[0].graph.scratch.values()
    (part_b, _), = engines[1].graph.scratch.values()
    assert part_a.data_ptr() != part_b.data_ptr()
    gen = torch.Generator("cuda").manual_seed(6)
    for engine, pos in zip(engines, ([9, 40], [47, 2])):
        for buf in engine.pool["attn"].values():
            buf.copy_(torch.randn(buf.shape, generator=gen, device="cuda"))
        engine._last_tok[:] = [7, 11]
        engine._pos[:] = pos
    wants = []
    for engine in engines:
        pool = {"attn": {k: v.clone() for k, v in
                         engine.pool["attn"].items()}}
        wants.append(lm.decode_step(
            pool, torch.tensor([[7], [11]], device="cuda"),
            torch.from_numpy(engine._pos.copy()).cuda())[0])
    got_a = engines[0]._step().clone()
    got_b = engines[1]._step().clone()
    torch.testing.assert_close(got_a, wants[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_b, wants[1], rtol=1e-5, atol=1e-5)

    q = torch.randn(2, 4, 64, device="cuda")
    kc = torch.randn(2, 32, 2, 64, device="cuda")
    lens = torch.full((2,), 32, dtype=torch.int32, device="cuda")
    ops.decode_attention(q, kc, kc, lens)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="graph_scratch"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            ops.decode_attention(q, kc, kc, lens)
    assert ops.launch_counts()["decode_attention"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_windowed_d80_serving_matches_generate(quant):
    """Reduced h2o-danube at D=80 (window 64) in fp32 on the card: prompts
    past the window, decodes that wrap the ring, mid-flight joins; the
    captured engine's tokens equal batch-1 generate's (also with the int8
    cache)."""
    _card()
    from repro_torch.dist.plan import Plan
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousBatcher, Request
    base = _small_lm("h2o-danube-1.8b", d_head=80)
    lm = LM(base.cfg, dict(base.state_dict()), Plan(kv_cache_quant=quant))
    assert lm.cfg.window == 64
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, lm.cfg.vocab_size, n).astype(np.int32)
            for n in (90, 30, 70)]
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=128)
    ops.reset_launch_counts()
    out = engine.run([Request(rid=f"r{i}", arch=lm.cfg.name,
                              prompt_len=len(t), max_gen=40, tokens=t,
                              arrival_s=i * engine.tick_s)
                      for i, t in enumerate(toks)])
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * 3
    # the int8 cache's decode attention is plain torch (jnp in JAX)
    assert counts["decode_attention"] == \
        (0 if quant else 2 * engine.calls["decode_step"])
    for i, t in enumerate(toks):
        want = generate(lm, {"tokens": torch.from_numpy(t[None])}, len(t),
                        40, 128)
        assert np.array_equal(out[f"r{i}"], want[0].cpu().numpy()), i


# ---- the MoE family's head layouts and its captured engine ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,kv", [(56, 8), (16, 16)])
def test_cuda_attention_at_the_moe_head_layouts(h, kv, dtype):
    """D=128 at arctic's 7 query heads a KV head and moonshot's 16 over 16:
    causal flash at S=1000 (bf16 at both limits, fp32 at 2e-4) and decode
    over a [4,2112,KV,128] pool (bf16 at 5e-2 and the row limit, fp32 at
    2e-4), each decode call made twice for the same bits."""
    gen = _card()
    q, k, v, rep = _flash_views(gen, dtype, 1000, 128, h=h, kv=kv)
    got = ops.flash_attention(q, k, v, kv_group=rep)
    want = ref.mha_ref(q, k, v, kv_group=rep)
    if dtype == torch.bfloat16:
        ok, err, rerr = parity.within_limits(got, want)
        assert ok, (err, rerr)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-4
    q, kc, vc, ln = _decode_case(gen, dtype, 4, h, kv, 2112, 128,
                                 (1, 300, 1000, 2112))
    got = ops.decode_attention(q, kc, vc, ln)
    torch.testing.assert_close(got.float(),
                               ref.decode_attention_ref(q, kc, vc, ln).float(),
                               rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        want32 = parity.decode_want32(q, kc, vc, ln)
        assert parity.row_err(got, want32) <= parity.DECODE_ROW_TOL
    assert torch.equal(got, ops.decode_attention(q, kc, vc, ln))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_cuda_moe_graph_step_equals_eager_step_bitwise(arch):
    """Reduced fp32 MoE at a capacity where routing the 4 slots jointly
    drops: the engine's captured step, replayed over its pool, gives the
    eager per-row step's logits and cache bit for bit, with no drop, and a
    second replay from the same state gives the same bits again."""
    _card()
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM
    from repro_torch.serve import ContinuousBatcher
    base = _small_lm(arch, n_layers=3)
    lm = LM(base.cfg, dict(base.state_dict()), Plan(moe_capacity_factor=1.0))
    drops = lm.count_moe_drops()      # before the capture, which keeps it
    engine = ContinuousBatcher(lm, n_slots=4, cache_len=64)
    gen = torch.Generator("cuda").manual_seed(5)
    for buf in engine.pool["attn"].values():
        buf.copy_(torch.randn(buf.shape, generator=gen, device="cuda"))
    start = {k: v.clone() for k, v in engine.pool["attn"].items()}
    engine._last_tok[:] = [3, 17, 250, 9]
    engine._pos[:] = [5, 40, 63, 1]
    drops.zero_()                     # the capture's warm-up step counted
    first = engine._step().clone()
    after = {k: v.clone() for k, v in engine.pool["attn"].items()}
    for k, v in start.items():
        engine.pool["attn"][k].copy_(v)
    again = engine._step().clone()
    torch.cuda.synchronize()
    assert int(drops[1, 1]) == 0 and int(drops[1, 0]) == 2 * 3 * 4 * 2
    assert torch.equal(first, again)
    eager_pool = {"attn": {k: v.clone() for k, v in start.items()}}
    toks = torch.tensor([[3], [17], [250], [9]], device="cuda")
    pos = torch.tensor([5, 40, 63, 1], device="cuda")
    want, _ = lm.decode_step(eager_pool, toks, pos, route_per_row=True)
    assert torch.equal(first, want)
    for k in after:
        assert torch.equal(after[k], eager_pool["attn"][k])
    drops.zero_()
    lm.decode_step({"attn": {k: v.clone() for k, v in start.items()}},
                   toks, pos)
    assert int(drops[1, 1]) > 0


# ---- the recurrent families: head dim 256, the captured recurrent step ----

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,window", [(4096, 2048), (1000, 2048), (65, 0),
                                      (300, 129)])
def test_cuda_flash_d256_matches_plain_version(s, window, dtype):
    """recurrentgemma's local attention: D=256, 10 query heads over one KV
    head, under its 2048 window past S (4096) and within it (1000), and
    around the 64-key tile (65 keys, a window of 129): bf16 at both limits
    beside the simulated faults, fp32 at 2e-4; one launch a call."""
    gen = _card()
    q, k, v, rep = _flash_views(gen, dtype, s, 256, h=10, kv=1)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, kv_group=rep, window=window)
    want = ref.mha_ref(q, k, v, kv_group=rep, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        return
    ok, err, rerr = parity.within_limits(got, want)
    assert ok, (err, rerr)
    if s >= 1000:
        for fault, bad in parity.fault_controls(q, k, v, rep,
                                                window).items():
            assert not parity.within_limits(bad, want)[0], fault


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("lens", [(1, 1000, 2048, 2048), (1, 1, 33, 2000)])
def test_cuda_decode_d256_group10_matches_plain_version(lens, dtype, tol):
    """recurrentgemma's decode over a [4, 2048, 1, 256] ring at 10 query
    heads a KV head (10 row passes; fp32 two chunks a lane), against the
    plain version; bf16 also at the row limit; two calls bitwise equal."""
    gen = _card()
    q, kc, vc, ln = _decode_case(gen, dtype, 4, 10, 1, 2048, 256, lens)
    got = ops.decode_attention(q, kc, vc, ln)
    torch.testing.assert_close(got.float(),
                               ref.decode_attention_ref(q, kc, vc, ln).float(),
                               rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        want32 = parity.decode_want32(q, kc, vc, ln)
        assert parity.row_err(got, want32) <= parity.DECODE_ROW_TOL
    assert torch.equal(got, ops.decode_attention(q, kc, vc, ln))


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over,prompt", [
    ("mamba2-1.3b", {}, 16), ("recurrentgemma-2b", {"n_layers": 5}, 70)])
def test_cuda_recurrent_graph_step_matches_eager_step(arch, over, prompt):
    """Reduced fp32 SSM and hybrid (one group and a tail, prompts past the
    64-token window): the engine's captured step replayed over its pool
    gives the eager step's logits and every state leaf within 1e-5, and
    the engine's tokens equal batch-1 ``generate``'s."""
    gen = _card()
    from repro_torch.launch.serve import generate
    from repro_torch.models.lm import slot_leaves
    from repro_torch.serve import ContinuousBatcher, Request
    lm = _small_lm(arch, **over)
    engine = ContinuousBatcher(lm, n_slots=4, cache_len=80)
    assert engine.graph is not None
    for _, buf, _ in slot_leaves(engine.pool):
        buf.copy_(torch.randn(buf.shape, generator=gen).to(buf))
    start = [buf.clone() for _, buf, _ in slot_leaves(engine.pool)]
    engine._last_tok[:] = [3, 17, 250, 9]
    engine._pos[:] = [prompt, prompt + 5, prompt + 9, 79]
    got = engine._step().clone()
    after = [buf.clone() for _, buf, _ in slot_leaves(engine.pool)]
    for (_, buf, _), s in zip(slot_leaves(engine.pool), start):
        buf.copy_(s)
    want, _ = lm.decode_step(engine.pool, torch.tensor(
        [[3], [17], [250], [9]], device="cuda"), torch.tensor(
        [prompt, prompt + 5, prompt + 9, 79], device="cuda"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, (_, b, _) in zip(after, slot_leaves(engine.pool)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    toks = torch.randint(0, lm.cfg.vocab_size, (3, prompt), generator=gen)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=80)
    out = engine.run([Request(rid=f"r{i}", arch=lm.cfg.name,
                              prompt_len=prompt, max_gen=g,
                              tokens=toks[i].numpy(), arrival_s=i * 0.01)
                      for i, g in enumerate((5, 3, 7))])
    for i, g in enumerate((5, 3, 7)):
        ref_toks = generate(lm, {"tokens": toks[i:i + 1]}, prompt, g, 80)
        assert np.array_equal(out[f"r{i}"], ref_toks[0].cpu().numpy()), i


# ---- the cross-attention families: non-causal flash over another length,
# ---- decode over a whole context, the captured cross step ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,skv", parity.CROSS_LENGTHS)
def test_cuda_noncausal_flash_over_another_length(sq, skv, d, dtype):
    """Cross-attention: Sq queries over Skv keys of another length, no
    causal mask (Sq below and above Skv, both ragged against the 128-row
    and 128- or 64-key tiles), kv_group 1 and 8, against the plain
    version: bf16 at both limits (beside the simulated faults at the
    serving lengths), fp32 at 2e-4; one launch a call."""
    gen = _card()
    for rep, q, k, v in parity.cross_cases(gen, d, sq, skv, dtype):
        ops.reset_launch_counts()
        got = ops.flash_attention(q, k, v, causal=False, kv_group=rep)
        want = ref.mha_ref(q, k, v, causal=False, kv_group=rep)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        assert got.shape == (8, sq, d)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
            continue
        ok, err, rerr = parity.within_limits(got, want)
        assert ok, (rep, err, rerr)
        if sq >= 1000 and skv >= 1024:
            for fault, bad in parity.fault_controls(q, k, v, rep,
                                                    causal=False).items():
                assert not parity.within_limits(bad, want)[0], fault


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 5e-2),
                                       (torch.float32, 2e-4)])
@pytest.mark.parametrize("shape,lens", [
    ((4, 64, 8, 2112, 128), (1, 300, 1000, 2112)),   # the VLM's self pool
    ((4, 64, 8, 1024, 128), (1024,) * 4),            # its image context
    ((4, 16, 16, 3072, 64), (3072,) * 4),            # the audio frames
])
def test_cuda_decode_cross_layouts_match_plain_version(shape, lens, dtype,
                                                       tol):
    """Decode at 8 query heads a KV head at D=128 and over whole contexts
    (every row full), against the plain version; bf16 also at the row
    limit; two calls bitwise equal; one launch a call."""
    gen = _card()
    q, kc, vc, ln = _decode_case(gen, dtype, *shape, lens)
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
    assert torch.equal(got, ops.decode_attention(q, kc, vc, ln))


@pytest.mark.gpu
def test_cuda_decode_refuses_host_lengths_in_a_capture():
    """Captured into a CUDA graph, decode attention takes its lengths as a
    device tensor (the cross layers' context length is a device fill); an
    int raises instead of becoming a host copy, and a device tensor
    captures and replays to the eager result."""
    gen = _card()
    q, kc, vc, ln = _decode_case(gen, torch.bfloat16, 2, 16, 2, 300, 128,
                                 (300, 300))
    want = ops.decode_attention(q, kc, vc, ln)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with pytest.raises(RuntimeError, match="captured into a CUDA graph"):
        with ops.CountedGraph().capture(stream):
            ops.decode_attention(q, kc, vc, 300)
    graph = ops.CountedGraph()
    with graph.capture(stream):
        full = torch.full((2,), 300, dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, kc, vc, full)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_cuda_crossattn_graph_step_matches_eager_step(arch):
    """Reduced fp32 VLM and audio models: the engine's captured step
    replayed over a random pool gives the eager step's logits and cache
    within 1e-5 (the cross K/V read, never written); one decode launch a
    self and a cross layer and step across replays; and the engine's
    tokens, each request with its own context, equal batch-1
    ``generate``'s."""
    _card()
    from repro_torch.launch.serve import generate, request_extras
    from repro_torch.models.lm import CrossBlock, slot_leaves
    from repro_torch.serve import ContinuousBatcher, Request
    lm = _small_lm(arch)
    engine = ContinuousBatcher(lm, n_slots=4, cache_len=40)
    assert engine.graph.launches["decode_attention"] == len(lm.layers)
    gen = torch.Generator().manual_seed(7)
    for _, buf, _ in slot_leaves(engine.pool):
        buf.copy_(torch.randn(buf.shape, generator=gen).to(buf))
    start = [buf.clone() for _, buf, _ in slot_leaves(engine.pool)]
    engine._last_tok[:] = [3, 17, 250, 9]
    engine._pos[:] = [10, 15, 20, 39]
    ops.reset_launch_counts()
    got = engine._step().clone()
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == len(lm.layers)
    after = [buf.clone() for _, buf, _ in slot_leaves(engine.pool)]
    for (_, buf, _), s in zip(slot_leaves(engine.pool), start):
        buf.copy_(s)
    want, _ = lm.decode_step(engine.pool, torch.tensor(
        [[3], [17], [250], [9]], device="cuda"), torch.tensor(
        [10, 15, 20, 39], device="cuda"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, (name, b, _) in zip(after, slot_leaves(engine.pool)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert torch.equal(engine.pool["cross"]["k"], start[2])
    n_cross = sum(isinstance(blk, CrossBlock) for blk in lm.layers)
    assert 0 < n_cross < len(lm.layers)
    prompt, gens = 12, (5, 3, 7)
    toks = torch.randint(0, lm.cfg.vocab_size, (3, prompt), generator=gen)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=40)
    out = engine.run([Request(rid=f"r{i}", arch=lm.cfg.name,
                              prompt_len=prompt, max_gen=g,
                              tokens=toks[i].numpy(), arrival_s=i * 0.01,
                              extras=request_extras(lm.cfg, 1, i))
                      for i, g in enumerate(gens)])
    for i, g in enumerate(gens):
        ref_toks = generate(lm, {"tokens": toks[i:i + 1],
                                 **request_extras(lm.cfg, 1, i)},
                            prompt, g, 40)
        assert np.array_equal(out[f"r{i}"], ref_toks[0].cpu().numpy()), i


@pytest.mark.gpu
def test_cuda_mesh_bridge_traces_fake_tensors_on_the_card():
    """The mesh bridge on the card: the tdFIR dp winner with the FPGA
    analogue's bank pinned in (the residual rule) traces on fake CUDA
    tensors — no launch, no device memory — and its analysis holds the
    complex kernel's work formula; the FPGA analogue has no mesh role."""
    from repro_torch.apps import APPS
    from repro_torch.backends import FPGA, MANY_CORE
    from repro_torch.core.measure import CompiledCostRunner
    from repro_torch.dist import bridge
    from repro_torch.kernels import tdfir as fir

    _card()
    app = APPS["tdFIR"]()
    state = app.make_inputs(0, device="cuda")
    fn = app.build({"tdfir_filter_bank": "pallas", "scale_output": "dp",
                    "energy_check": "dp"})
    runner = CompiledCostRunner(mesh=bridge.LocalMesh())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    before = torch.cuda.memory_allocated()
    ev = bridge.mesh_verify(runner, MANY_CORE, fn, state)
    assert torch.cuda.memory_allocated() == before
    assert set(ops.launch_counts().values()) == {0}
    assert ev is not None and ev.correct and ev.time_s > 0
    rl = ev.info["roofline"]
    f, n = state["x_re"].shape
    k = state["h_re"].shape[1]
    assert rl["flops_per_device"] >= fir.complex_work(f, n, k)[0]
    assert rl["flops_by_dtype"]["fp32"] == rl["flops_per_device"]
    assert bridge.mesh_verify(runner, FPGA, fn, state) is None
    # the same pattern launched for real still runs its kernel once
    fn(state)
    torch.cuda.synchronize()
    assert ops.launch_counts()["tdfir"] == 1
