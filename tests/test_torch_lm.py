"""The port's dense LM against the JAX ``Model`` on reduced granite-3-2b in
fp32, with the JAX ``Model.init`` weights carried across by
``repro_torch.models.convert``: prefill logits and cache, decode steps,
prefill == incremental decode (tests/test_lm_consistency.py:34), the
blockwise plan (tests/test_lm_consistency.py:85), and what the slice
refuses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.plan import Plan as JaxPlan
from repro.models.lm import Model
from repro_torch.configs import get_config
from repro_torch.dist.plan import Plan
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import LM, init_cache, init_params

ARCH = "granite-3-2b"
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, numpy tree, port LM) on one set of
    weights."""
    jcfg = jax_config(ARCH).reduced()
    model = Model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config(ARCH).reduced()
    lm = LM(cfg, params_from_numpy(tree, cfg, device="cpu"))
    return cfg, model, params, tree, lm


def _tokens(cfg, b, s, seed):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                       cfg.vocab_size), np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_converter_round_trip_and_init_layout(pair):
    cfg, _, _, tree, lm = pair
    back = params_to_numpy(dict(lm.state_dict()), cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_j, flat_b):
        assert np.array_equal(a, b), path
    fresh = init_params(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in lm.state_dict().items()}


def test_init_params_uses_the_jax_distributions():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=256)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    assert abs(p["blocks.0.attn.wq"].std().item() - 256 ** -0.5) < 0.005
    assert abs(p["blocks.0.ffn.w_out"].std().item()
               - cfg.d_ff ** -0.5) < 0.005
    assert torch.equal(p["final_norm.scale"], torch.ones(256))


@pytest.mark.parametrize("cache_len", [16, 8])
def test_prefill_logits_and_cache_match_jax(pair, cache_len):
    """cache_len 16 pads the 12-token prompt; 8 keeps its last 8 tokens in
    ring order (lm.py:_ring_place)."""
    cfg, model, params, _, lm = pair
    toks = _tokens(cfg, 2, 12, 7)
    want_logits, want_cache = jax.jit(
        lambda p, b: model.prefill(p, b, cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    logits, cache = lm.prefill({"tokens": torch.from_numpy(toks)},
                               cache_len)
    assert logits.shape == (2, cfg.padded_vocab)
    _close(logits, want_logits)
    for name in ("k", "v"):
        assert cache["attn"][name].shape == want_cache["attn"][name].shape
        _close(cache["attn"][name], want_cache["attn"][name])


def test_five_decode_steps_match_jax(pair):
    cfg, model, params, _, lm = pair
    toks = _tokens(cfg, 2, 10, 3)
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    step = jax.jit(model.decode_step)
    for i in range(5):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(10 + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), 10 + i)
        _close(tl, jl)
    _close(tc["attn"]["k"], jc["attn"]["k"])


def test_prefill_matches_incremental_decode(pair):
    """Port-only mirror of tests/test_lm_consistency.py:34 (same
    tolerance)."""
    cfg, _, _, _, lm = pair
    b, s, cache_len = 2, 12, 16
    toks = torch.from_numpy(_tokens(cfg, b, s, 7))
    last_a, cache_a = lm.prefill({"tokens": toks}, cache_len)
    cache_b = lm.init_cache(b, cache_len)
    for pos in range(s):
        last_b, cache_b = lm.decode_step(cache_b, toks[:, pos:pos + 1], pos)
    torch.testing.assert_close(last_a, last_b, rtol=2e-3, atol=2e-3)
    tok = last_a.argmax(-1)[:, None]
    la, _ = lm.decode_step(cache_a, tok, s)
    lb, _ = lm.decode_step(cache_b, tok, s)
    torch.testing.assert_close(la, lb, rtol=2e-3, atol=2e-3)


def test_per_row_positions_match_one_row_at_a_time(pair):
    """decode_step with one position per row (the batcher's slots) equals
    each row decoded alone at its scalar position."""
    cfg, _, _, _, lm = pair
    toks = torch.from_numpy(_tokens(cfg, 3, 9, 11))
    caches = [lm.prefill({"tokens": toks[i:i + 1, :n]}, 16)[1]
              for i, n in enumerate((3, 6, 9))]
    pool = {"attn": {k: torch.cat([c["attn"][k] for c in caches], dim=1)
                     for k in ("k", "v")}}
    nxt = torch.tensor([[5], [6], [7]])
    got, _ = lm.decode_step(pool, nxt, torch.tensor([3, 6, 9]))
    for i, n in enumerate((3, 6, 9)):
        want, _ = lm.decode_step(caches[i], nxt[i:i + 1], n)
        torch.testing.assert_close(got[i:i + 1], want, rtol=TOL, atol=TOL)


def test_blockwise_plan_matches_port(pair):
    """JAX with the blockwise attention path (Plan threshold 16, 16-wide
    blocks) against the port, whose flash kernel is the blockwise
    algorithm."""
    cfg, _, params, _, lm = pair
    block = Model(jax_config(ARCH).reduced(),
                  JaxPlan(blockwise_attn_threshold=16, attn_block_q=16,
                          attn_block_kv=16))
    toks = _tokens(cfg, 2, 32, 2)
    want, _ = jax.jit(lambda p, b: block.prefill(p, b, 40))(
        params, {"tokens": jnp.asarray(toks)})
    got, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 40)
    _close(got, want)


def test_refuses_what_the_slice_does_not_port(pair):
    """Nothing of the dense LM is refused any more: a logit soft cap
    (ROADMAP item 8, once refused) builds, inits and prefills with the
    JAX model's logits at 1e-4, and so does every dense config
    (h2o-danube's window too), the MoE, SSM, hybrid, VLM and audio
    families and the int8 KV cache; the VLM and audio LMs build and run a
    prefill and a decode step, and ``train_loss`` (ROADMAP item 9, now
    ported) returns a finite loss.  Weights that do not fit the config
    are still refused."""
    cfg, _, params, _, lm = pair
    state = dict(lm.state_dict())
    capped = dataclasses.replace(cfg, logit_softcap=1.0)
    assert init_params(capped, device="cpu").keys() == state.keys()
    toks = _tokens(cfg, 2, 12, 5)
    want, _ = jax.jit(lambda p, b: Model(dataclasses.replace(
        jax_config(ARCH).reduced(), logit_softcap=1.0)).prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    got, _ = LM(capped, state).prefill({"tokens": torch.from_numpy(toks)}, 16)
    _close(got, want)
    for ok in ("h2o-danube-1.8b", "moonshot-v1-16b-a3b", "arctic-480b",
               "mamba2-1.3b", "recurrentgemma-2b", "llama-3.2-vision-90b",
               "seamless-m4t-medium"):
        c = get_config(ok).reduced()
        model = LM(c, init_params(c, device="cpu"))
        if c.family in ("vlm", "audio"):
            n = c.n_img_tokens if c.family == "vlm" else c.n_frames
            key = "img_embed" if c.family == "vlm" else "frames"
            logits, cache = model.prefill(
                {"tokens": torch.zeros(1, 4, dtype=torch.long),
                 key: torch.randn(1, n, c.d_model)}, 8)
            logits, _ = model.decode_step(cache, logits.argmax(-1)[:, None],
                                          4)
            assert torch.isfinite(logits).all()
    assert LM(cfg, state, Plan(kv_cache_quant=True)).plan.kv_cache_quant
    total, metrics = lm.train_loss(
        {"tokens": torch.zeros(1, 4, dtype=torch.long),
         "labels": torch.ones(1, 4, dtype=torch.long)})
    assert torch.isfinite(total) and float(metrics["loss"]) > 0
    with pytest.raises(ValueError, match="do not fit"):
        LM(cfg, {**state, "extra.w": torch.zeros(1)})


def test_init_cache_layout():
    cfg = get_config(ARCH).reduced()
    c = init_cache(cfg, 3, 20, device="cpu")
    assert c["attn"]["k"].shape == (cfg.n_layers, 3, 20, cfg.n_kv_heads,
                                    cfg.head_dim)
    assert c["attn"]["v"].dtype == torch.float32
    assert not c["attn"]["k"].any()
