"""The flash backward's saved log-sum-exp and its launch plan.

On the CPU: the plain forward's L (``ref.mha_ref(..., return_lse=True)``,
base 2) against ``torch.logsumexp`` of the masked, scaled scores in float64
(1e-5: the plain version sums in fp32); ``ref.mha_backward_ref`` given that
L against the recomputing formula the backward used before it took L (a
softmax over the masked scores), 1e-6 in fp32; ``ops.FlashAttention``
saving L and its gradients against ``jax.vjp`` of the reference's attention
(1e-5, as ``tests/test_torch_attention_grad.py``); and
``kernels/flash_attention_bwd.plan`` for every head dim and dtype.  The
``gpu``-marked cases hold the tensor-core backward kernels to the plain
version on the card (they skip without one; JAX is imported only inside
the CPU cases): ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_flash_bwd.py``."""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, parity, ref

# (BH, KV rows, Sq, Skv, D, causal, window)
CASES = [
    (8, 2, 70, 70, 16, True, 0),       # causal GQA, ragged against 64
    (4, 4, 90, 90, 32, True, 17),      # sliding window
    (4, 1, 33, 77, 16, False, 0),      # non-causal, Sq < Skv
    (4, 2, 77, 33, 16, False, 0),      # non-causal, Sq > Skv
    (2, 1, 65, 65, 80, True, 0),       # ragged at D = 80
    (4, 2, 20, 8, 16, True, 4),        # rows 11.. attend no key
]


def _inputs(case, seed, dtype=torch.float32, device="cpu"):
    bh, n_kv, sq, skv, d = case[:5]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, dtype)
    return t(bh, sq, d), t(n_kv, skv, d), t(n_kv, skv, d), t(bh, sq, d)


def _kw(case):
    bh, n_kv = case[:2]
    return dict(causal=case[5], kv_group=bh // n_kv, window=case[6])


def _mask(case):
    sq, skv, causal, window = case[2], case[3], case[5], case[6]
    diff = torch.arange(sq)[:, None] - torch.arange(skv)[None, :]
    keep = diff >= 0 if causal else torch.ones(sq, skv, dtype=torch.bool)
    return keep & (diff < window) if window else keep


def _recomputing_backward(q, k, v, o, do, *, causal, kv_group, window):
    """The plain backward as it was before it took L: P by a softmax over
    the masked scores (a row with no key gets the uniform softmax of its
    NEG_INF scores, where the kernels give it P = 0)."""
    n_kv, sk, d = k.shape
    scale = 1.0 / math.sqrt(d)
    kf = k.repeat_interleave(kv_group, 0)
    vf = v.repeat_interleave(kv_group, 0)
    mask = ref._attention_mask(q.shape[1], sk, causal, window, q.device)
    s = torch.where(mask[None], torch.einsum("bqd,bkd->bqk", q, kf) * scale,
                    ref.NEG_INF)
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    dp = torch.einsum("bqd,bkd->bqk", do, vf)
    ds = torch.where(mask[None], p * (dp - (do * o).sum(-1, keepdim=True)),
                     0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q) * scale
    return (dq, dk.reshape(n_kv, kv_group, sk, d).sum(1),
            dv.reshape(n_kv, kv_group, sk, d).sum(1))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_lse_is_logsumexp_of_masked_scaled_scores(case):
    q, k, v, _ = _inputs(case, seed=1)
    kw = _kw(case)
    _, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    kf = k.double().repeat_interleave(kw["kv_group"], 0)
    s = torch.einsum("bqd,bkd->bqk", q.double(), kf) / math.sqrt(q.shape[-1])
    mask = _mask(case)
    want = torch.logsumexp(torch.where(mask[None], s, -math.inf), -1) \
        / math.log(2.0)
    none = ~mask.any(-1)
    assert none.any() == (case[2] > case[3] + case[6] - 1 and case[6] > 0)
    want[:, none] = 0.0           # the sentinel of a row with no key
    torch.testing.assert_close(lse.double(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_with_lse_equals_recomputing_formula(case):
    q, k, v, do = _inputs(case, seed=2)
    kw = _kw(case)
    o, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    got = ref.mha_backward_ref(q, k, v, o, do, lse, **kw)
    # rows that attend no key add nothing to dV with L (P = 0), where the
    # softmax formula spreads their dO over every key
    none = ~_mask(case).any(-1)
    want = _recomputing_backward(q, k, v, o, do * ~none[None, :, None], **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    if none.any():
        dv_softmax = _recomputing_backward(q, k, v, o, do, **kw)[2]
        assert not torch.allclose(got[2], dv_softmax, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_lse_limit_rejects_l_summed_from_bf16_p(case):
    """``parity.LSE_TOL``, the card's limit on the saved L, breaks on L
    whose row sums were taken over P rounded to bf16."""
    q, k, v, _ = _inputs(case, seed=4)
    kw = _kw(case)
    want = ref.mha_ref(q, k, v, return_lse=True, **kw)[1]
    bad = parity.lse_fault(q, k, v, **kw)
    assert bad.shape == want.shape
    none = ~_mask(case).any(-1)
    assert torch.equal(bad[:, none], want[:, none])
    assert (bad - want).abs().max().item() > parity.LSE_TOL


def test_flash_attention_function_saves_lse_on_cpu():
    """``ops.FlashAttention`` saves q, k, v, its output and the plain L;
    its gradients match ``jax.vjp`` of the reference's attention."""
    import jax
    import jax.numpy as jnp
    from repro.dist.plan import Plan as JaxPlan
    from repro.models import layers as jlayers
    from repro_torch.dist.plan import Plan
    from repro_torch.models import layers
    b, s, h, kvh, d, window = 2, 40, 4, 2, 16, 9
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal(shape, np.float32) for shape in
                  ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                   (b, s, h, d)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.attention(tq, tk, tv, causal=True, window=window,
                           plan=Plan())
    saved = out.grad_fn
    while type(saved).__name__ != "FlashAttentionBackward":
        saved = saved.next_functions[0][0]
    heads = [x.detach().transpose(1, 2).reshape(-1, s, d)
             for x in (tq, tk, tv)]
    want_o, want_lse = ref.mha_ref(*heads, kv_group=h // kvh, window=window,
                                   return_lse=True)
    assert len(saved.saved_tensors) == 5
    assert torch.equal(saved.saved_tensors[3], want_o)
    assert torch.equal(saved.saved_tensors[4], want_lse)
    out.backward(torch.from_numpy(g))

    def f(q, k, v):
        return jlayers.attention(q, k, v, causal=True, window=window,
                                 plan=JaxPlan())

    jout, pull = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    for got, w in zip((out.detach(), tq.grad, tk.grad, tv.grad),
                      (jout, *pull(jnp.asarray(g)))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", fab.HEAD_DIMS)
def test_plan(d, dtype):
    p = fab.plan(d, dtype)
    wgmma = dtype == torch.bfloat16
    assert p.route == ("wgmma" if wgmma else "cuda-cores")
    assert max(p.dkdv_smem, p.dq_smem) <= fab.SMEM_LIMIT
    if wgmma:
        # wgmma takes 64-row tiles: two warpgroups of 64 keys (dK/dV) or
        # rows (dQ) a block, 64-row Q/dO tiles (whose statistics are one
        # tile of the scratch), key tiles of 64 or 128; at D = 256 both
        # warpgroups on 64 keys or rows, each with half of D
        for rows in (p.dkdv_keys, p.dkdv_rows, p.dq_rows, p.dq_keys):
            assert rows % 64 == 0
        assert p.dkdv_rows == fab.STAT_ROWS == 64
        assert (p.dkdv_keys, p.dq_rows) == ((64, 64) if d == 256
                                            else (128, 128))
        assert p.dq_keys == (64 if d in (80, 128, 256) else 128)
        assert (p.dkdv_stages, p.dq_stages) == ((2, 2) if d == 256
                                                else (p.dkdv_stages, 3))
        assert p.dkdv_stages >= (2 if d == 256 else 3)
        assert fab.plan(80, dtype) == fab.plan(128, dtype) or d != 80
    else:
        assert p.dkdv_stages == p.dq_stages == 0
        assert p.dq_rows == (32 if d == 256 else 64)
    with pytest.raises(ValueError, match="head dim|D in"):
        fab.plan(48, dtype)


# ---------------------------------------------------------------------------
# on the card: the tensor-core kernels against the plain version
# ---------------------------------------------------------------------------

# (BH, KV rows, Sq, Skv, D, causal, window): every tensor-core head dim,
# ragged against the 64- and 128-row tiles, windows, GQA, non-causal
# Sq != Skv, rows with no key
GPU_CASES = [
    (8, 2, 300, 300, 64, True, 0),
    (4, 4, 130, 130, 16, True, 0),
    (4, 1, 200, 200, 32, True, 70),
    (6, 6, 257, 257, 80, True, 100),
    (8, 1, 150, 333, 128, False, 0),
    (4, 2, 333, 150, 64, False, 0),
    (8, 2, 190, 64, 128, True, 40),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_cuda_wgmma_backward_matches_plain_version(case):
    _card()
    assert fab.plan(case[4], torch.bfloat16).route == "wgmma"
    q, k, v, do = _inputs(case, 5, torch.bfloat16, "cuda")
    kw = _kw(case)
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    want_lse = ref.mha_ref(q.float(), k.float(), v.float(), return_lse=True,
                           **kw)[1]
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=parity.LSE_TOL)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == 2
    for g, a in zip(got, again):
        assert g.dtype == torch.bfloat16 and torch.equal(g, a)
    want32 = parity.bwd_want32(q, k, v, o, do, **kw)
    ok, err, rerr = parity.bwd_within_limits(got, want32)
    assert ok, (err, rerr)


@pytest.mark.gpu
def test_cuda_backward_refuses_what_tma_cannot_load():
    _card()
    wide = torch.randn(8, 100, 66, device="cuda").bfloat16()
    q = wide[..., :64]          # rows 132 bytes apart: not 16-byte aligned
    k = torch.randn(2, 100, 64, device="cuda").bfloat16()
    o, lse = ops.flash_attention_lse(q.contiguous(), k, k, kv_group=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.flash_attention_bwd(q, k, k, o, o, lse, kv_group=4)
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_bwd(q.contiguous(), k, k, o, o, lse.double(),
                                kv_group=4)
    from repro_torch.kernels import flash_attention as fa
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention(q.contiguous(), k, k, kv_group=4, lse=lse[:, :50])


@pytest.mark.gpu
def test_cuda_autograd_takes_a_broadcast_output_gradient():
    """A gradient whose rows are one broadcast row (stride 0, which TMA
    cannot load) reaches the backward as a contiguous copy, with the
    gradients of the same gradient given dense."""
    _card()
    case = GPU_CASES[0]
    q, k, v, _ = _inputs(case, 6, torch.bfloat16, "cuda")
    kw = _kw(case)
    g = torch.randn(1, 1, q.shape[-1], device="cuda").bfloat16()
    grads = []
    for do in (g.expand_as(q), g.expand_as(q).contiguous()):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ops.flash_attention(*leaves, **kw).backward(do)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
