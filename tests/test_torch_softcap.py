"""Logit soft caps and the query offset against the JAX package, fp32 on
the CPU: ``layers.attention(softcap=, q_offset=)`` against the JAX
``dense_attention``, ``decode_attention`` and ``decode_attention_quant``
against theirs, the attention's gradients against ``jax.grad``, and a
capped dense and a capped MoE config through both ``Model``s (weights
carried across by ``repro_torch.models.convert``): prefill logits, greedy
tokens over the exact and the int8 cache, a train step's loss and
gradients.  The audio encoder and every cross attention stay uncapped, as
in the JAX package.  Caps of 1 to 2 bend unit-scale scores (at Gemma 2's
50 random scores barely move).  Tolerances: 1e-5 per layer, 1e-4 for
whole-model logits and gradients (of each leaf's largest), the loss at
1e-5 relative, as the reference's own tests and the port's uncapped
parity tests hold them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.data.pipeline import data_config_for as jax_data_config
from repro.dist.plan import Plan as JaxPlan
from repro.models import layers as jax_layers
from repro.models.lm import Model
from repro_torch.configs import get_config
from repro_torch.dist.plan import Plan
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, parity, ref
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, DenseBlock, check_supported

TOL, LM_TOL = 1e-5, 1e-4
CAP = 1.5

# (Sq, Skv, H, KV, causal, window, q_offset, softcap)
ATTN_CASES = [
    (12, 12, 4, 4, True, 0, 0, CAP),
    (12, 12, 8, 2, True, 0, 0, 1.0),        # GQA
    (16, 16, 4, 2, True, 5, 0, 2.0),        # window
    (9, 14, 4, 1, False, 0, 0, CAP),        # non-causal, Sq != Skv
    (5, 13, 4, 2, True, 0, 8, CAP),         # a chunk after 8 queries
    (6, 20, 8, 2, True, 7, 14, 1.0),        # offset under a window
    (5, 13, 4, 2, True, 0, 8, 0.0),         # the offset alone
]


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(seed, b, sq, skv, h, kv, d=16):
    return (_normal(seed, b, sq, h, d), _normal(seed + 1, b, skv, kv, d),
            _normal(seed + 2, b, skv, kv, d))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_dense_attention(case):
    sq, skv, h, kv, causal, window, off, cap = case
    q, k, v = _qkv(0, 2, sq, skv, h, kv)
    want = jax_layers.dense_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=off, softcap=cap)
    got = layers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           window=window, q_offset=off, softcap=cap)
    _close(got, want)
    if cap:     # the cap bends these scores far past the tolerance
        plain = layers.attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window, q_offset=off)
        assert (plain - got).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_grads_match_jax_grad(case):
    """The gradient of the capped, offset attention (the plain backward
    on the CPU, ``ref.mha_backward_ref`` with the cap's 1 - t^2) against
    ``jax.grad`` of ``dense_attention``, for a seeded output gradient."""
    sq, skv, h, kv, causal, window, off, cap = case
    q, k, v = _qkv(3, 2, sq, skv, h, kv)
    do = _normal(9, 2, sq, h, 16)
    kw = dict(causal=causal, window=window, q_offset=off, softcap=cap)

    def loss(q, k, v):
        return jnp.sum(jax_layers.dense_attention(q, k, v, **kw) * do)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = layers.attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g, w, 1e-4 * max(1.0, float(jnp.abs(w).max())))


@pytest.mark.parametrize("cap", [1.0, 2.0])
def test_decode_attention_matches_jax(cap):
    q = _normal(0, 3, 1, 8, 16)
    kc, vc = _normal(1, 3, 20, 2, 16), _normal(2, 3, 20, 2, 16)
    for clen in (1, 13, 20):
        want = jax_layers.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), clen,
            softcap=cap)
        got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                      clen, softcap=cap)
        _close(got, want)
    # per-row lengths: each row as the reference decodes it alone
    lens = torch.tensor([4, 20, 9])
    got = layers.decode_attention(*map(torch.from_numpy, (q, kc, vc)), lens,
                                  softcap=cap)
    for i, n in enumerate(lens.tolist()):
        _close(got[i:i + 1], jax_layers.decode_attention(
            jnp.asarray(q[i:i + 1]), jnp.asarray(kc[i:i + 1]),
            jnp.asarray(vc[i:i + 1]), n, softcap=cap))


@pytest.mark.parametrize("cap", [1.0, 2.0])
def test_decode_attention_quant_matches_jax(cap):
    """The int8 cache: the K scales fold into the scores before the cap,
    in the reference's order."""
    q = _normal(4, 2, 1, 4, 16)
    kq, ks = jax_layers.quantize_kv(jnp.asarray(_normal(5, 2, 12, 2, 16)))
    vq, vs = jax_layers.quantize_kv(jnp.asarray(_normal(6, 2, 12, 2, 16)))
    want = jax_layers.decode_attention_quant(jnp.asarray(q), kq, ks, vq, vs,
                                             9, softcap=cap)
    t = [torch.from_numpy(np.array(x)) for x in (q, kq, ks, vq, vs)]
    _close(layers.decode_attention_quant(*t, 9, softcap=cap), want)
    assert (layers.decode_attention_quant(*t, 9) - layers
            .decode_attention_quant(*t, 9, softcap=cap)).abs().max() > 1e-3


def test_capped_lse_and_backward_are_the_capped_functions():
    """The plain forward's saved lse is the log-sum-exp (base 2) of the
    capped scores, and the plain backward given it is autograd of the
    plain forward."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 7, 16, generator=g, dtype=torch.float64)
    k, v = (torch.randn(2, 11, 16, generator=g, dtype=torch.float64)
            for _ in range(2))
    kw = dict(causal=True, kv_group=2, window=6, softcap=CAP, q_offset=4)
    out, lse = ref.mha_ref(q, k, v, return_lse=True, **kw)
    s = ref.softcap_scores(torch.einsum(
        "bqd,bkd->bqk", q, k.repeat_interleave(2, 0)) / 4.0, CAP)
    keep = ref._attention_mask(7, 11, True, 6, "cpu", 4)
    want = torch.logsumexp(torch.where(keep, s, ref.NEG_INF), -1) * ref.LOG2E
    torch.testing.assert_close(lse, want.float())
    do = torch.randn(out.shape, generator=g, dtype=torch.float64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.mha_ref(*leaves, **kw), leaves, do)
    got = ref.mha_backward_ref(q, k, v, out, do, lse.double(), **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fake_calls_report_the_offsets_pairs():
    """A fake flash forward and backward report ``work`` with the pairs
    the offset leaves (a causal chunk of 4 queries after 6 over 10 keys:
    7 + 8 + 9 + 10 pairs a head), and refuse what the kernels refuse."""
    assert fab.attended_pairs(4, 10, True, 0, 6) == 34
    assert fab.attended_pairs(4, 10, True, 3, 6) == 12
    assert fab.attended_pairs(4, 10, False, 0, 6) == 40
    got = []

    def sink(name, flops, nbytes, dtype):
        got.append((name, flops, nbytes))
    with FakeTensorMode() as mode, ops.recording_work(sink):
        q = mode.from_tensor(torch.empty(8, 4, 64))
        k = mode.from_tensor(torch.empty(2, 10, 64))
        ops.flash_attention(q, k, k, kv_group=4, softcap=2.0, q_offset=6)
        o, lse = ops.flash_attention_lse(q, k, k, kv_group=4, q_offset=6)
        ops.flash_attention_bwd(q, k, k, o, o, lse, kv_group=4, q_offset=6,
                                softcap=2.0)
        with pytest.raises(ValueError, match="query offset"):
            ops.flash_attention(q, k, k, kv_group=4, q_offset=-1)
        with pytest.raises(ValueError, match="soft cap"):
            ops.flash_attention(q, k, k, kv_group=4, softcap=-1.0)
    assert got == [
        ("flash_attention",) + fa.work(8, 4, 10, 64, 4, True, 0, 4,
                                       q_offset=6),
        ("flash_attention",) + fa.work(8, 4, 10, 64, 4, True, 0, 4,
                                       lse=True, q_offset=6),
        ("flash_attention_bwd",) + fab.work(8, 4, 10, 64, 4, True, 0, 4,
                                            q_offset=6)]
    assert got[0][1:] == (4.0 * 8 * 34 * 64,
                          4.0 * (2 * 8 * 4 + 2 * 2 * 10) * 64)
    assert got[2][1] == 10.0 * 8 * 34 * 64


def test_cuda_tensors_never_take_the_plain_version():
    """A capped call on CPU tensors is the plain version; the kernels'
    wrappers refuse anything but CUDA tensors, so a capped call on the
    card launches or raises (``ops`` dispatches by device alone)."""
    x = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(x, x, x, softcap=2.0)
    with pytest.raises(ValueError, match="CUDA"):
        fab.flash_attention_bwd(x, x, x, x, x, torch.zeros(2, 4),
                                softcap=2.0)
    from repro_torch.kernels import decode_attention as da
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(x[:, :1], x[:, :, None], x[:, :, None], 3,
                            softcap=2.0)


# ---- whole models -----------------------------------------------------------

def _model_pair(arch, cap, quant=False, layers_kept=None):
    """(port cfg, JAX model, JAX params, port LM) of ``arch`` at
    ``reduced()`` with ``logit_softcap = cap`` on both sides."""
    over = {"logit_softcap": cap}
    if layers_kept:
        over["n_layers"] = layers_kept
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = Model(jcfg, JaxPlan(kv_cache_quant=quant))
    params = model.init(jax.random.PRNGKey(0))
    lm = LM(cfg, params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu"), Plan(kv_cache_quant=quant))
    return cfg, model, params, lm


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_capped_model_prefill_and_greedy_tokens_match_jax(arch):
    """Prefill logits at 1e-4 and four greedy decode steps: the same
    tokens, logits at 1e-4; the cap moves the logits far past that."""
    cfg, model, params, lm = _model_pair(arch, 1.0)
    check_supported(cfg)
    toks = _tokens(cfg, 2, 10, 3)
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl, LM_TOL)
    plain = LM(dataclasses.replace(cfg, logit_softcap=0.0),
               dict(lm.state_dict()))
    pl, _ = plain.prefill({"tokens": torch.from_numpy(toks)}, 16)
    assert (pl - tl).abs().max().item() > 100 * LM_TOL
    step = jax.jit(model.decode_step)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(10 + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), 10 + i)
        _close(tl, jl, LM_TOL)


def test_capped_model_over_the_int8_cache_matches_jax():
    """The int8 cache under a cap: prefill logits at 1e-4, then three
    greedy steps each from JAX's cache (a value rounded to the other side
    of a half moves later logits; tests/test_torch_dense_family.py does
    the same): the same tokens, logits at 1e-4."""
    cfg, model, params, lm = _model_pair("granite-3-2b", 1.0, quant=True)
    toks = _tokens(cfg, 2, 12, 9)
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    assert tc["attn"]["k"].dtype == torch.int8
    _close(tl, jl, LM_TOL)
    step = jax.jit(model.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], tl.argmax(-1).numpy())
        tc = {"attn": {name: torch.from_numpy(np.array(buf))
                       for name, buf in jc["attn"].items()}}
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(12 + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), 12 + i)
        _close(tl, jl, LM_TOL)


@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_capped_train_loss_and_grads_match_jax(arch):
    """``LM.train_loss`` and every gradient against
    ``jax.value_and_grad(Model.train_loss)`` under a cap: the loss at 1e-5
    relative, each gradient at 1e-4 of its leaf's largest (floored at 1e-4
    of the largest of any leaf, as tests/test_torch_train.py does)."""
    _, model, params, lm = _model_pair(arch, CAP)
    batch = JaxTokens(jax_data_config(
        model.cfg, JaxShape("t", 16, 2, "train"), seed=0)).batch(0)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    (total, _), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(params, batch)
    lm.requires_grad_(True)
    ptotal, _ = lm.train_loss(batch)
    names = list(lm.params())
    got = torch.autograd.grad(ptotal, list(lm.params().values()),
                              allow_unused=True)
    assert ptotal.item() == pytest.approx(float(total), rel=1e-5)
    want = params_from_numpy(jax.tree.map(np.asarray, grads), lm.cfg,
                             device="cpu")
    top = max(w.abs().max().item() for w in want.values())
    for name, g in zip(names, got):
        w = want[name]
        g = torch.zeros_like(w) if g is None else g
        scale = max(w.abs().max().item(), 1e-4 * top)
        assert (g - w).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_encoder_and_cross_attention_stay_uncapped(arch):
    """A capped audio or VLM config: the decoder's self attention is
    capped, the audio encoder and the cross attention are not (the JAX
    encoder and cross blocks call dense_attention without a cap): prefill
    logits match JAX's at 1e-4."""
    cfg, model, params, lm = _model_pair(arch, 1.0)
    key = "frames" if cfg.family == "audio" else "img_embed"
    n = cfg.n_frames if cfg.family == "audio" else cfg.n_img_tokens
    toks = _tokens(cfg, 2, 8, 5)
    ctx = _normal(7, 2, n, cfg.d_model)
    jl, _ = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks), key: jnp.asarray(ctx)})
    tl, _ = lm.prefill({"tokens": torch.from_numpy(toks),
                        key: torch.from_numpy(ctx)}, 16)
    _close(tl, jl, LM_TOL)
    blocks = [m for m in lm.modules() if isinstance(m, DenseBlock)]
    assert {b.softcap for b in blocks if not b.causal} <= {0.0}
    assert any(b.softcap == 1.0 for b in blocks if b.causal)


def test_cap_and_offset_fault_controls_fail_the_limits():
    """The faults the card's checks simulate for a capped or offset call
    (the cap dropped, its derivative dropped, the offset dropped) fall far
    outside the limits the kernels are held to, at the checked cap of 2
    on unit-scale scores (plain versions, bf16 inputs, on the CPU): flash
    at ``parity.within_limits``, the backward at ``bwd_within_limits``,
    decode at the row limit."""
    g = torch.Generator().manual_seed(0)

    def heads(n, s):
        return torch.randn(1, s, n, 64, generator=g).bfloat16().transpose(
            1, 2).reshape(n, s, 64)
    q, k, v = heads(8, 96), heads(2, 256), heads(2, 256)
    kw = dict(kv_group=4, softcap=2.0, q_offset=160)
    want = ref.mha_ref(q, k, v, **kw)
    controls = parity.cap_fault_controls(q, k, v, 4, softcap=2.0,
                                         q_offset=160)
    assert set(controls) == {"cap dropped", "offset dropped"}
    for bad in controls.values():
        assert not parity.within_limits(bad, want)[0]
    do = heads(8, 96)
    o = ref.mha_ref(q.float(), k.float(), v.float(), **kw).bfloat16()
    want32 = parity.bwd_want32(q, k, v, o, do, **kw)
    bwd = parity.bwd_cap_fault_controls(q, k, v, o, do, 4, softcap=2.0,
                                        q_offset=160)
    assert set(bwd) == {"cap dropped", "cap's derivative dropped",
                        "offset dropped"}
    for bad in bwd.values():
        assert not parity.bwd_within_limits(bad, want32)[0]
    qd = torch.randn(2, 16, 64, generator=g).bfloat16()
    kc, vc = (torch.randn(2, 300, 4, 64, generator=g).bfloat16()
              for _ in range(2))
    lens = torch.tensor([100, 300])
    want32 = parity.decode_want32(qd, kc, vc, lens, softcap=2.0)
    for bad in parity.decode_cap_fault_controls(qd, kc, vc, lens).values():
        assert parity.row_err(bad, want32) > parity.DECODE_ROW_TOL
