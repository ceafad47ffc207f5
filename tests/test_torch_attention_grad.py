"""The gradient of the port's attention against ``jax.vjp`` of the
reference's ``layers.attention`` under a dense and a blockwise plan:
``ref.mha_backward_ref`` (the plain backward) and the
``ops.FlashAttention`` autograd function on the CPU, causal, windowed,
grouped (GQA) and non-causal with ``Sq != Skv``, fp32 at 1e-5.  The
``gpu``-marked cases hold the CUDA backward kernel to its plain version on
the card (they skip without one).  JAX is imported by the CPU cases
alone, so the card's machine, which has none, runs the ``gpu`` cases:
``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_attention_grad.py``."""
import numpy as np
import pytest
import torch

from repro_torch.dist.plan import Plan
from repro_torch.kernels import ops, parity, ref
from repro_torch.models import layers

TOL = 1e-5
# (B, Sq, Skv, H, KV, D, causal, window)
CASES = [
    (2, 24, 24, 4, 2, 16, True, 0),       # causal GQA
    (1, 40, 40, 4, 4, 32, True, 8),       # sliding window
    (2, 20, 20, 6, 1, 16, True, 5),       # 6 query heads a KV head, window
    (2, 12, 28, 4, 2, 16, False, 0),      # cross attention, Sq < Skv
    (1, 33, 9, 2, 1, 32, False, 0),       # cross attention, Sq > Skv
]
# the reference's plans: dense, and blockwise in tiles of 8
PLANS = {"dense": dict(blockwise_attn_threshold=1 << 30),
         "blockwise": dict(blockwise_attn_threshold=1, attn_block_q=8,
                           attn_block_kv=8)}


def _inputs(case, seed):
    b, sq, skv, h, kv, d, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, kv, d), np.float32),
            rng.standard_normal((b, skv, kv, d), np.float32),
            rng.standard_normal((b, sq, h, d), np.float32))


def _jax_vjp(case, plan, q, k, v, g):
    import jax
    import jax.numpy as jnp
    from repro.dist.plan import Plan as JaxPlan
    from repro.models import layers as jlayers
    causal, window = case[6], case[7]

    def f(q, k, v):
        return jlayers.attention(q, k, v, causal=causal, window=window,
                                 plan=JaxPlan(**PLANS[plan]))

    out, pull = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in (out, *pull(jnp.asarray(g)))]


def _heads(x):
    """[B, S, H, D] -> [B*H, S, D], as ``layers.attention`` hands it on."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_port_attention_grad_matches_jax_vjp(case, plan):
    """The port's ``layers.attention`` under autograd (FlashAttention, its
    plain forward and backward on the CPU) and ``ref.mha_backward_ref``
    directly, against the reference's vjp."""
    q, k, v, g = _inputs(case, seed=len(plan) + case[1])
    want = _jax_vjp(case, plan, q, k, v, g)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.attention(tq, tk, tv, causal=case[6], window=case[7],
                           plan=Plan())
    out.backward(torch.from_numpy(g))
    for got, w in zip((out.detach(), tq.grad, tk.grad, tv.grad), want):
        _close(got, w)

    b, _, h, kvh = case[0], case[1], case[3], case[4]
    hq, hk, hv = (_heads(torch.from_numpy(x)) for x in (q, k, v))
    o, lse = ref.mha_ref(hq, hk, hv, causal=case[6], kv_group=h // kvh,
                         window=case[7], return_lse=True)
    dq, dk, dv = ref.mha_backward_ref(hq, hk, hv, o,
                                      _heads(torch.from_numpy(g)), lse,
                                      causal=case[6], kv_group=h // kvh,
                                      window=case[7])
    for got, w in zip((dq, dk, dv), want[1:]):
        bb, s, n, d = w.shape
        _close(got.reshape(bb, n, s, d).transpose(1, 2), w)


def test_flash_attention_function_is_used_only_under_grad():
    """Serving (no grad) takes the forward call alone; under grad the
    function's backward equals autograd through the plain forward."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 17, 16, generator=gen)
    k, v = torch.randn(2, 17, 16, generator=gen), \
        torch.randn(2, 17, 16, generator=gen)
    plain = ops.flash_attention(q, k, v, kv_group=2, window=6)
    assert plain.grad_fn is None
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(qs, ks, vs, kv_group=2, window=6)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    g = torch.randn(out.shape, generator=gen)
    out.backward(g)
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    ref.mha_ref(qa, ka, va, kv_group=2, window=6).backward(g)
    for got, want in ((qs.grad, qa.grad), (ks.grad, ka.grad),
                      (vs.grad, va.grad)):
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    with torch.no_grad():
        assert ops.flash_attention(qs, ks, vs, kv_group=2).grad_fn is None


def test_backward_bf16_returns_bf16():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 9, 16, generator=gen).bfloat16()
    lse = ref.mha_ref(x, x[:1], x[:1], kv_group=2, return_lse=True)[1]
    grads = ref.mha_backward_ref(x, x[:1], x[:1], x, x, lse, kv_group=2)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert [t.shape for t in grads] == [x.shape, x[:1].shape, x[:1].shape]


@pytest.mark.parametrize("causal, window, s", [
    (True, 0, 200), (True, 90, 200), (False, 0, 200), (True, 0, 50)])
def test_bwd_limits_pass_rounding_and_reject_simulated_faults(causal,
                                                               window, s):
    """``parity.bwd_within_limits``: the plain backward on bf16 inputs
    (fp32 sums, bf16 outputs: what the kernel does) passes against its fp32
    run, and every simulated fault of ``parity.bwd_fault_controls`` is
    rejected."""
    gen = torch.Generator().manual_seed(2)
    q, do = (torch.randn(8, s, 64, generator=gen).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(2, s, 64, generator=gen).bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, kv_group=4, window=window)
    o, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    want32 = parity.bwd_want32(q, k, v, o, do, **kw)
    ok, err, rerr = parity.bwd_within_limits(
        ref.mha_backward_ref(q, k, v, o, do, lse, **kw), want32)
    assert ok, (err, rerr)
    controls = parity.bwd_fault_controls(q, k, v, o, do, 4, causal, window)
    assert len(controls) == 4
    for fault, bad in controls.items():
        assert not parity.bwd_within_limits(bad, want32)[0], fault


# ---------------------------------------------------------------------------
# on the card: the CUDA backward kernel against the plain version
# ---------------------------------------------------------------------------

# (BH, KV rows, Sq, Skv, D, causal, window)
GPU_CASES = [
    (8, 2, 200, 200, 64, True, 0),
    (8, 8, 65, 65, 16, True, 0),
    (4, 1, 130, 130, 256, True, 40),
    (6, 6, 100, 100, 80, True, 33),
    (8, 1, 77, 200, 128, False, 0),
    (4, 4, 300, 65, 32, False, 0),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(5)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_cuda_backward_kernel_matches_plain_version(case):
    gen = _card()
    bh, n_kv, sq, skv, d, causal, window = case
    rep = bh // n_kv

    def randn(*shape):
        return torch.randn(shape, generator=gen).cuda()

    q, do = randn(bh, sq, d), randn(bh, sq, d)
    k, v = randn(n_kv, skv, d), randn(n_kv, skv, d)
    kw = dict(causal=causal, kv_group=rep, window=window)
    o, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    want = ref.mha_backward_ref(q, k, v, o, do, lse, **kw)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == 2
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)
        assert torch.equal(g, a)
    b16 = [t.bfloat16() for t in (q, k, v, o, do)]
    want32 = parity.bwd_want32(*b16, **kw)
    lse16 = ops.flash_attention_lse(*b16[:3], **kw)[1]
    for g, w in zip(ops.flash_attention_bwd(*b16, lse16, **kw), want32):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_cuda_flash_attention_function_trains():
    """Autograd through ``ops.flash_attention`` on the card: the forward
    and backward kernels, one launch each, equal to the plain versions."""
    gen = _card()
    q = torch.randn(8, 150, 64, generator=gen).cuda().requires_grad_()
    k = torch.randn(2, 150, 64, generator=gen).cuda().requires_grad_()
    v = torch.randn(2, 150, 64, generator=gen).cuda().requires_grad_()
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, kv_group=4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
    o, lse = ref.mha_ref(q.detach(), k.detach(), v.detach(), kv_group=4,
                         return_lse=True)
    want = ref.mha_backward_ref(q.detach(), k.detach(), v.detach(), o, 2 * o,
                                lse, kv_group=4)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.randn(2, 16, 48, device="cuda")
        ops.flash_attention_bwd(x, x, x, x, x, x[..., 0])
