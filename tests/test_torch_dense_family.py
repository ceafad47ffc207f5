"""The rest of the dense family against the JAX ``Model``, with the JAX
``Model.init`` weights carried across by ``repro_torch.models.convert`` and
inputs drawn from seeds: nemotron-4-15b (layernorm, relu²),
command-r-plus-104b (also at 12 query heads a KV head) and h2o-danube-1.8b
(a 64-token window at ``reduced()``, also at head dim 80) under the dense
and the blockwise plan; the windowed ring at a cache length that pads and
at one that wraps, decoded past the wrap; the window's mask
(tests/test_lm_consistency.py:98); the int8 KV cache
(tests/test_lm_consistency.py:112, :160); and the continuous batcher over a
wrapped ring, token-identical to the JAX ``generate``.  fp32 throughout,
logits at 1e-4."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.plan import Plan as JaxPlan
from repro.launch.serve import generate as jax_generate
from repro.models import layers as jax_layers
from repro.models.lm import Model
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.plan import Plan
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, check_supported, init_cache, init_params
from repro_torch.serve import ContinuousBatcher, Request

TOL = 1e-4

# name -> (arch, config fields replaced on both sides)
VARIANTS = {
    "nemotron": ("nemotron-4-15b", {}),
    "command-r+": ("command-r-plus-104b", {}),
    "command-r+/rep12": ("command-r-plus-104b",
                         {"n_heads": 24, "n_kv_heads": 2}),
    "h2o": ("h2o-danube-1.8b", {}),
    "h2o/d80": ("h2o-danube-1.8b", {"d_head": 80}),
}
PLANS = {"dense": {},
         "blockwise": {"blockwise_attn_threshold": 16, "attn_block_q": 8,
                       "attn_block_kv": 8}}


@functools.lru_cache(maxsize=None)
def _weights(variant):
    """(port cfg, JAX cfg, JAX params, port state dict) of one variant."""
    arch, over = VARIANTS[variant]
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
    params = Model(jcfg).init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    state = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, state


def _pair(variant, plan="dense", quant=False):
    """(port cfg, JAX model, JAX params, port LM) on one set of weights."""
    cfg, jcfg, params, state = _weights(variant)
    kw = dict(PLANS[plan], kv_cache_quant=quant)
    return (cfg, Model(jcfg, JaxPlan(**kw)), params,
            LM(cfg, dict(state), Plan(**kw)))


def _tokens(cfg, b, s, seed):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                       cfg.vocab_size), np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _decode_along(model, params, lm, toks, cache_len, steps):
    """Prefill both sides, then ``steps`` greedy decode steps (JAX's tokens
    fed to both), holding logits at 1e-4 after each and the caches after
    the prefill and the last step."""
    s = toks.shape[1]
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, cache_len)
    _close(tl, jl)
    _same_cache(tc, jc)
    step = jax.jit(model.decode_step)
    for i in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(s + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), s + i)
        _close(tl, jl)
    _same_cache(tc, jc)


def _same_cache(tc, jc):
    assert set(tc["attn"]) == set(jc["attn"])
    for name, want in jc["attn"].items():
        got = tc["attn"][name]
        assert tuple(got.shape) == want.shape, name
        if want.dtype == jnp.int8:
            assert got.dtype == torch.int8
            diff = np.abs(got.numpy().astype(np.int32)
                          - np.asarray(want).astype(np.int32))
            assert diff.max() <= 1, name
        else:
            _close(got, want, 1e-6 if "scale" in name else TOL)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_three_decode_steps_match_jax(variant, plan):
    """20-token prompts (past the blockwise plan's threshold of 16, in
    8-wide blocks), a 24-slot cache: prefill logits and cache, then three
    decode steps."""
    cfg, model, params, lm = _pair(variant, plan)
    toks = _tokens(cfg, 2, 20, 7)
    _decode_along(model, params, lm, toks, 24, 3)


@pytest.mark.parametrize("s,cache_len,plan,steps", [
    (80, 128, "dense", 6),       # S past the window: the ring wraps
    (80, 128, "blockwise", 3),
    (40, 128, "dense", 30),      # the ring pads, then wraps while decoding
    (80, 48, "dense", 4),        # a cache shorter than the window
])
def test_windowed_ring_matches_jax(s, cache_len, plan, steps):
    """h2o-danube at head dim 80 (window 64 at reduced()): the prefill
    masks by the window, the cache is a ring of min(cache_len, 64) slots
    (token t at slot t % W), and decode writes slot pos % W past the
    wrap."""
    cfg, model, params, lm = _pair("h2o/d80", plan)
    assert cfg.window == 64 and cfg.attn_kind == "swa"
    toks = _tokens(cfg, 2, s, 5)
    _decode_along(model, params, lm, toks, cache_len, steps)
    w = min(cache_len, cfg.window)
    assert lm.init_cache(1, cache_len)["attn"]["k"].shape[2] == w


def test_swa_window_actually_masks():
    """Port mirror of tests/test_lm_consistency.py:98 on prefill logits:
    at S=32 a window of 8 changes them against full attention on the same
    weights, and equals the JAX window."""
    cfg, jcfg, params, state = _weights("h2o")
    full = dataclasses.replace(cfg, attn_kind="full", window=0)
    swa = dataclasses.replace(cfg, attn_kind="swa", window=8)
    toks = torch.from_numpy(_tokens(cfg, 1, 32, 3))
    l_full, _ = LM(full, dict(state)).prefill({"tokens": toks}, 32)
    l_swa, _ = LM(swa, dict(state)).prefill({"tokens": toks}, 32)
    assert (l_full - l_swa).abs().max().item() > 1e-6
    jswa = Model(dataclasses.replace(jcfg, attn_kind="swa", window=8))
    want, _ = jax.jit(lambda p, b: jswa.prefill(p, b, 32))(
        params, {"tokens": jnp.asarray(toks.numpy())})
    _close(l_swa, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 5, 16, 40])
def test_mha_ref_window_matches_jax_dense_attention(window, causal):
    """The plain version's window against the JAX layer's rule, on
    grouped heads (H=6 over KV=2) at a ragged S=37."""
    rng = np.random.default_rng(window)
    b, s, h, kvh, d = 2, 37, 6, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    want = jax_layers.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window)

    def heads(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(-1, s, d)

    got = ref.mha_ref(heads(q), heads(k), heads(v), causal=causal,
                      kv_group=h // kvh, window=window)
    got = got.reshape(b, h, s, d).transpose(1, 2)
    _close(got, want, 2e-5)
    via_layer = layers.attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal,
                                 window=window)
    assert torch.equal(via_layer, got)


# ---- the int8 KV cache ----------------------------------------------------

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 0.1), (2, 40.0)])
def test_quantize_kv_matches_jax(seed, scale):
    """int8 values within 1 of JAX's (a tie may round the other way after
    a last-bit difference in the scale), scales at 1e-6 relative."""
    x = (np.random.default_rng(seed).standard_normal((3, 9, 2, 80))
         * scale).astype(np.float32)
    jq, js = jax_layers.quantize_kv(jnp.asarray(x))
    q, s = layers.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (3, 9, 2, 80) and s.shape == (3, 9, 2, 1)
    assert np.abs(q.numpy().astype(np.int32)
                  - np.asarray(jq).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    err = (q.float() * s - torch.from_numpy(x)).abs()
    assert bool((err <= s * 0.51).all())


@pytest.mark.parametrize("variant,s,cache_len", [("h2o", 12, 16),
                                                 ("h2o/d80", 80, 128),
                                                 ("nemotron", 12, 16)])
def test_int8_cache_prefill_and_decode_match_jax(variant, s, cache_len):
    """plan.kv_cache_quant on both sides: int8 K/V with fp32 per-(token,
    head) scales, placed in the (windowed) ring after quantizing.  Prefill
    logits at 1e-4, cache values within 1 and scales at 1e-6.  A value one
    below or above JAX's (K/V a last bit apart, rounded on either side of a
    half) moves later logits by up to a few 1e-4, so each of three decode
    steps starts both sides from JAX's cache: logits at 1e-4, the written
    cache values within 1."""
    cfg, model, params, lm = _pair(variant, quant=True)
    toks = _tokens(cfg, 2, s, 9)
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, cache_len)
    _close(tl, jl)
    _same_cache(tc, jc)
    step = jax.jit(model.decode_step)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        tc = {"attn": {name: torch.from_numpy(np.array(buf))
                       for name, buf in jc["attn"].items()}}
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(s + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), s + i)
        _close(tl, jl)
        _same_cache(tc, jc)


def test_int8_cache_close_to_exact():
    """Port mirror of tests/test_lm_consistency.py:112: the int8 cache's
    probabilities lie within 0.05 of the exact cache's, after the prefill
    and after a decode step."""
    cfg, _, _, exact = _pair("h2o/d80")
    quant = _pair("h2o/d80", quant=True)[3]
    toks = torch.from_numpy(_tokens(cfg, 2, 12, 9))
    la, ca = exact.prefill({"tokens": toks}, 16)
    lq, cq = quant.prefill({"tokens": toks}, 16)
    assert cq["attn"]["k"].dtype == torch.int8
    assert (la.softmax(-1) - lq.softmax(-1)).abs().max().item() < 0.05
    tok = la.argmax(-1)[:, None]
    la2, _ = exact.decode_step(ca, tok, 12)
    lq2, _ = quant.decode_step(cq, tok, 12)
    assert (la2.softmax(-1) - lq2.softmax(-1)).abs().max().item() < 0.05


def test_init_cache_ring_and_int8_layout():
    cfg = get_config("h2o-danube-1.8b").reduced()
    exact = init_cache(cfg, 3, 200, device="cpu")
    assert exact["attn"]["k"].shape == (cfg.n_layers, 3, 64, cfg.n_kv_heads,
                                        cfg.head_dim)
    q = init_cache(cfg, 3, 20, device="cpu", quant=True)
    assert q["attn"]["k"].dtype == q["attn"]["v"].dtype == torch.int8
    assert q["attn"]["k_scale"].shape == (cfg.n_layers, 3, 20,
                                          cfg.n_kv_heads, 1)
    assert q["attn"]["v_scale"].dtype == torch.float32
    assert not any(t.any() for t in q["attn"].values())


def test_every_dense_config_is_supported():
    """check_supported takes every dense and MoE config in configs/ and the
    int8 cache, and since the cross-attention slice every config of every
    family (the VLM and audio ones build and prefill); since the soft-cap
    slice a logit soft cap too, whose capped prefill matches the JAX
    model's at 1e-4 (a window and a cap together: h2o-danube)."""
    dense = [c for c in ARCHS.values() if c.family == "dense"]
    assert {c.name for c in dense} >= {"granite-3-2b", "h2o-danube-1.8b",
                                       "nemotron-4-15b",
                                       "command-r-plus-104b"}
    served = dense + [c for c in ARCHS.values() if c.family == "moe"]
    assert len(served) == len(dense) + 2
    for c in served:
        check_supported(c, Plan(kv_cache_quant=True))
    capped = dataclasses.replace(dense[0], logit_softcap=30.0)
    check_supported(capped, Plan(kv_cache_quant=True))
    cfg, jcfg, params, state = _weights("h2o")
    over = {"logit_softcap": 1.0}
    model = Model(dataclasses.replace(jcfg, **over))
    lm = LM(dataclasses.replace(cfg, **over), dict(state))
    toks = _tokens(cfg, 2, 12, 4)
    want, _ = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    got, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    _close(got, want)
    for c in ARCHS.values():
        check_supported(c)
    cross = [c for c in ARCHS.values() if c.family in ("vlm", "audio")]
    assert {c.name for c in cross} == {"llama-3.2-vision-90b",
                                       "seamless-m4t-medium"}
    for c in cross:
        r = c.reduced()
        key, n = (("img_embed", r.n_img_tokens) if r.family == "vlm"
                  else ("frames", r.n_frames))
        logits, _ = LM(r, init_params(r, device="cpu")).prefill(
            {"tokens": torch.zeros(1, 3, dtype=torch.long),
             key: torch.randn(1, n, r.d_model)}, 4)
        assert logits.shape == (1, r.padded_vocab)


# ---- the continuous batcher over a wrapped ring ---------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_batcher_wraps_the_ring_and_matches_jax_generate(quant):
    """Reduced h2o-danube at head dim 80: 70-token prompts past the
    64-token window (the ring wraps at admission and again while
    decoding), staggered arrivals, more requests than slots and mixed
    max_gen; the port's engine gives the JAX generate's tokens, with the
    exact cache and with the int8 one."""
    cfg, model, params, lm = _pair("h2o/d80", quant=quant)
    prompt_len, cache_len, gens = 70, 128, [12, 5, 20, 8]
    toks = _tokens(cfg, len(gens), prompt_len, 1)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=cache_len)
    assert engine.pool["attn"]["k"].shape[2] == cfg.window
    reqs = [Request(rid=f"r{i}", arch=cfg.name, prompt_len=prompt_len,
                    max_gen=g, tokens=toks[i],
                    arrival_s=i * 1.5 * engine.tick_s)
            for i, g in enumerate(gens)]
    out = engine.run(reqs)
    for i, g in enumerate(gens):
        want = np.asarray(jax_generate(
            model, params, {"tokens": toks[i:i + 1]},
            prompt_len=prompt_len, gen=g, cache_len=cache_len))[0]
        assert np.array_equal(out[f"r{i}"], want), f"r{i}"
    assert engine.metrics.summary()["completed"] == len(gens)
