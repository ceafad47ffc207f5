"""The recurrent families against the JAX package: the SSD block
(``repro_torch.models.ssm``: mamba2-1.3b), the RG-LRU block
(``repro_torch.models.rglru``) and the hybrid LM (recurrentgemma-2b: groups
of (recurrent, recurrent, local attention) and a tail).  Inputs come from
numpy seeds and the JAX ``Model.init`` weights are carried across by
``repro_torch.models.convert``.  Tolerances: 1e-5 per module in fp32,
2e-2 under ``Plan(ssd_bf16=True)`` (its [B, nc, q, q, nh] intermediates are
bfloat16, 8 significant bits), 1e-4 for whole-model logits, 2e-3 between
prefill and token-by-token decode (tests/test_lm_consistency.py:34); the
batchers' greedy tokens exactly."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.plan import Plan as JaxPlan
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models.lm import Model
from repro.serve.batching import ContinuousBatcher as JaxBatcher
from repro.serve.request import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.dist.plan import Plan
from repro_torch.launch.serve import generate, main
from repro_torch.models import rglru, ssm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import LM, init_cache, init_params, slot_leaves
from repro_torch.serve import ContinuousBatcher, Request

MAMBA, GRIFFIN = "mamba2-1.3b", "recurrentgemma-2b"
TOL, BF16_TOL, LM_TOL = 1e-5, 2e-2, 1e-4
# name -> (arch, config fields replaced on both sides); reduced() keeps 2 of
# recurrentgemma's layers, both recurrent (no group, a tail of 2), so
# "griffin" is cut to 5: one group and the tail of two, the whole model's
# 8 x 3 + 2 in small
VARIANTS = {"mamba": (MAMBA, {}), "griffin": (GRIFFIN, {"n_layers": 5}),
            "griffin/tail": (GRIFFIN, {})}


def _cfgs(arch, **over):
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(jax_config(arch).reduced(), **over))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _slow_dt_bias(shape):
    return _normal(4, *shape, scale=0.5) - 3.0


@functools.lru_cache(maxsize=None)
def _ssm_weights():
    cfg, jcfg = _cfgs(MAMBA)
    p = jax_ssm.init_ssm(jax.random.PRNGKey(3), jcfg, jnp.float32)
    # a spread of skips, and steps dt ~ softplus(-3) small enough that a
    # chunk's state outlives the chunk (at the init's dt_bias 0 it decays
    # to nothing within 8 tokens, and the inter-chunk carry goes unseen)
    p = dict(p, dt_bias=jnp.asarray(_slow_dt_bias(p["dt_bias"].shape)),
             D=jnp.asarray(_normal(5, p["D"].shape[0])))
    return cfg, jcfg, p, {k: _t(v) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _lru_weights():
    cfg, jcfg = _cfgs(GRIFFIN)
    p = jax_rglru.init_rglru(jax.random.PRNGKey(6), jcfg, jnp.float32)
    return cfg, jcfg, p, {k: _t(v) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _weights(variant):
    """(port cfg, JAX cfg, JAX params, port state dict) of one variant."""
    arch, over = VARIANTS[variant]
    cfg, jcfg = _cfgs(arch, **over)
    params = Model(jcfg).init(jax.random.PRNGKey(0))
    if cfg.family == "ssm":     # slow decays: the chunk carry matters
        blocks = dict(params["blocks"])
        blocks["ssm"] = dict(blocks["ssm"], dt_bias=jnp.asarray(
            _slow_dt_bias(blocks["ssm"]["dt_bias"].shape)))
        params = dict(params, blocks=blocks)
    state = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, jcfg, params, state


def _pair(variant, **plan):
    cfg, jcfg, params, state = _weights(variant)
    return (cfg, Model(jcfg, JaxPlan(**plan)), params,
            LM(cfg, dict(state), Plan(**plan)))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---- the SSD block ---------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """The depthwise causal conv + SiLU and its new state (the last K-1
    inputs), from zeros and from a decode state."""
    x, w = _normal(1, 2, 9, 24), _normal(2, 4, 24, scale=0.1)
    state = _normal(3, 2, 3, 24) if with_state else None
    want, want_st = jax_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if state is None else jnp.asarray(state))
    got, got_st = ssm._causal_conv(_t(x), _t(w),
                                   None if state is None else _t(state))
    _close(got, want)
    _close(got_st, want_st)


@pytest.mark.parametrize("seq,chunk", [(32, 8), (32, 16), (12, 0)])
@pytest.mark.parametrize("bf16", [False, True])
def test_apply_ssm_matches_jax(seq, chunk, bf16):
    """The chunked SSD and its final (conv, state) at two chunk sizes (4 and
    2 chunks) and at a sequence shorter than the config's chunk (one chunk
    of 12), in fp32 and under ``ssd_bf16``."""
    cfg, jcfg, jp, p = _ssm_weights()
    h = _normal(7, 2, seq, cfg.d_model, scale=0.5)
    want, want_st = jax_ssm.apply_ssm(jp, jcfg, jnp.asarray(h), None,
                                      return_state=True, chunk=chunk,
                                      bf16=bf16)
    got, got_st = ssm.apply_ssm(p, cfg, _t(h), return_state=True,
                                chunk=chunk, bf16=bf16)
    tol = BF16_TOL if bf16 else TOL
    _close(got, want, tol)
    _close(got_st["conv"], want_st["conv"])
    _close(got_st["state"], want_st["state"], tol)
    assert got_st["state"].dtype == torch.float32


def test_apply_ssm_refuses_a_chunk_that_does_not_divide():
    """The JAX block asserts S % chunk == 0; the port raises, and pads
    nothing."""
    cfg, jcfg, jp, p = _ssm_weights()
    h = _normal(8, 1, 24, cfg.d_model)
    with pytest.raises(AssertionError):
        jax_ssm.apply_ssm(jp, jcfg, jnp.asarray(h), None, chunk=16)
    with pytest.raises(ValueError, match="divide chunk 16"):
        ssm.apply_ssm(p, cfg, _t(h), chunk=16)


def test_decode_ssm_matches_jax():
    """Three decode steps from a random (conv, state), each written into
    the port's cache in place."""
    cfg, jcfg, jp, p = _ssm_weights()
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    cache["conv"].copy_(_t(_normal(9, *cache["conv"].shape)))
    cache["state"].copy_(_t(_normal(10, *cache["state"].shape, scale=0.3)))
    # copies: a JAX array made from a CPU tensor's numpy view shares its
    # memory, and the port writes ``cache`` in place while JAX may still
    # be reading it
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}
    conv_ptr = cache["conv"].data_ptr()
    for step in range(3):
        h = _normal(11 + step, 2, 1, cfg.d_model)
        want, jcache = jax_ssm.decode_ssm(jp, jcfg, jnp.asarray(h), jcache,
                                          None)
        got = ssm.decode_ssm(p, cfg, _t(h), cache)
        _close(got, want)
        _close(cache["conv"], jcache["conv"])
        _close(cache["state"], jcache["state"])
    assert cache["conv"].data_ptr() == conv_ptr


# ---- the RG-LRU block ------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 16, 37])
def test_apply_rglru_matches_the_associative_scan(seq):
    """The log-depth doubling scan against ``jax.lax.associative_scan`` at
    S = 1, a power of two and a length that is not one, through the whole
    block and its final (conv, h)."""
    cfg, jcfg, jp, p = _lru_weights()
    h = _normal(20 + seq, 2, seq, cfg.d_model)
    want, want_st = jax_rglru.apply_rglru(jp, jcfg, jnp.asarray(h), None,
                                          return_state=True)
    got, got_st = rglru.apply_rglru(p, cfg, _t(h), return_state=True)
    _close(got, want)
    _close(got_st["conv"], want_st["conv"])
    _close(got_st["h"], want_st["h"])


@pytest.mark.parametrize("seq", [1, 2, 64, 100])
def test_linear_scan_matches_the_sequential_recurrence(seq):
    """h_t = a_t h_{t-1} + b_t, step by step in float64, against the
    doubling scan in float32."""
    a = np.random.default_rng(seq).uniform(0.5, 1.0, (2, seq, 5))
    b = _normal(seq + 1, 2, seq, 5).astype(np.float64)
    want = np.zeros_like(b)
    h = np.zeros((2, 5))
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = rglru.linear_scan(_t(a), _t(b))
    _close(got, want)


def test_decode_rglru_matches_jax():
    cfg, jcfg, jp, p = _lru_weights()
    cache = rglru.init_rglru_cache(cfg, 2, torch.float32, "cpu")
    cache["conv"].copy_(_t(_normal(30, *cache["conv"].shape)))
    cache["h"].copy_(_t(_normal(31, *cache["h"].shape)))
    # copies: a JAX array made from a CPU tensor's numpy view shares its
    # memory, and the port writes ``cache`` in place while JAX may still
    # be reading it
    jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}
    for step in range(3):
        h = _normal(32 + step, 2, 1, cfg.d_model)
        want, jcache = jax_rglru.decode_rglru(jp, jcfg, jnp.asarray(h),
                                              jcache, None)
        got = rglru.decode_rglru(p, cfg, _t(h), cache)
        _close(got, want)
        _close(cache["h"], jcache["h"])
        _close(cache["conv"], jcache["conv"])


# ---- the whole LM ----------------------------------------------------------

# (variant, prompt length, cache_len): the hybrid past its 64-token window
LM_CASES = [("mamba", 32, 40), ("griffin", 80, 96), ("griffin", 20, 96),
            ("griffin/tail", 20, 28)]


@pytest.mark.parametrize("variant,seq,cache_len", LM_CASES)
def test_prefill_and_decode_match_jax(variant, seq, cache_len):
    """Last-position logits of the prefill, then 6 greedy decode steps
    (the JAX tokens fed to both) at 1e-4; the hybrid's ring wraps when the
    prompt is past its window."""
    cfg, model, params, lm = _pair(variant)
    toks = _tokens(cfg, 2, seq, 1)
    want, jcache = jax.jit(lambda p, b: model.prefill(p, b, cache_len))(
        params, {"tokens": jnp.asarray(toks)})
    got, cache = lm.prefill({"tokens": torch.from_numpy(toks)}, cache_len)
    _close(got, want, LM_TOL)
    step = jax.jit(model.decode_step)
    for i in range(6):
        tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
        want, jcache = step(params, jcache, jnp.asarray(tok),
                            jnp.int32(seq + i))
        got, cache = lm.decode_step(cache, torch.from_numpy(tok), seq + i)
        _close(got, want, LM_TOL)
    if cfg.family == "hybrid" and "k" in cache["groups"]["b2"]:
        ring = cache["groups"]["b2"]["k"].shape[2]
        assert ring == min(cache_len, cfg.window)
        _close(cache["groups"]["b2"]["k"], jcache["groups"]["b2"]["k"],
               LM_TOL)


def test_ssd_bf16_plan_runs_the_lm_like_jax():
    """``Plan(ssd_bf16=True, ssd_chunk=8)``: the LM's prefill logits
    against the JAX model under the same plan."""
    cfg, model, params, lm = _pair("mamba", ssd_bf16=True, ssd_chunk=8)
    toks = _tokens(cfg, 1, 32, 2)
    want, _ = model.prefill(params, {"tokens": jnp.asarray(toks)}, 40)
    got, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 40)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("variant", ["mamba", "griffin"])
def test_prefill_matches_incremental_decode(variant):
    """The port's vectorized prefill cache against the cache built token by
    token from zeros (tests/test_lm_consistency.py:34), and one more step
    from each."""
    cfg, _, _, lm = _pair(variant)
    b, s, cache_len = 2, 12, 16
    toks = _tokens(cfg, b, s, 3)
    last_a, cache_a = lm.prefill({"tokens": torch.from_numpy(toks)},
                                 cache_len)
    cache_b = lm.init_cache(b, cache_len)
    for pos in range(s):
        last_b, cache_b = lm.decode_step(
            cache_b, torch.from_numpy(toks[:, pos:pos + 1]), pos)
    _close(last_a, last_b.numpy(), 2e-3)
    tok = last_a.argmax(-1)[:, None]
    _close(lm.decode_step(cache_a, tok, s)[0],
           lm.decode_step(cache_b, tok, s)[0].numpy(), 2e-3)


def test_cache_layout_and_weights_round_trip():
    """The caches keep the JAX layout and dtypes, the hybrid's state dict
    goes back to the JAX tree's nesting and stacking unchanged, and a
    bfloat16 model keeps the SSD and RG-LRU float32 leaves in float32."""
    cfg, jcfg, params, state = _weights("griffin")
    c = init_cache(cfg, 3, 100, device="cpu")
    groups = c["groups"]
    assert groups["b0"]["h"].shape == (1, 3, 1, cfg.hybrid.lru_width)
    assert groups["b0"]["h"].dtype == torch.float32
    assert groups["b2"]["k"].shape == (1, 3, cfg.window, cfg.n_kv_heads,
                                       cfg.head_dim)
    assert [sorted(t) for t in c["tail"]] == [["conv", "h"]] * 2
    leaves = [(name, ax) for name, _, ax in slot_leaves(c)]
    assert leaves == ([(f"groups.b{j}.{n}", 1) for j in (0, 1)
                       for n in ("conv", "h")]
                      + [("groups.b2.k", 1), ("groups.b2.v", 1)]
                      + [(f"tail.{i}.{n}", 0) for i in (0, 1)
                         for n in ("conv", "h")])
    back = params_to_numpy(state, cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    s = init_cache(get_config(MAMBA).reduced(), 2, 9, device="cpu")
    assert s["blocks"]["state"].dtype == torch.float32
    for arch in (MAMBA, GRIFFIN):
        bf = dataclasses.replace(get_config(arch).reduced(),
                                 dtype="bfloat16", param_dtype="bfloat16")
        jbf = dataclasses.replace(jax_config(arch).reduced(),
                                  dtype="bfloat16", param_dtype="bfloat16")
        tree = jax.tree.map(np.asarray,
                            Model(jbf).init(jax.random.PRNGKey(1)))
        for p in (params_from_numpy(tree, bf, device="cpu"),
                  init_params(bf, torch.Generator().manual_seed(0), "cpu")):
            for name, t in p.items():
                leaf = name.rsplit(".", 1)[-1]
                want = (torch.float32 if leaf in ("A_log", "D", "dt_bias",
                                                  "lam")
                        else torch.bfloat16)
                assert t.dtype == want, name
            LM(bf, p)


def test_init_uses_the_jax_constants():
    """``A_log = log(linspace(1, nh))``, ``D`` ones, ``dt_bias`` zeros, the
    RG-LRU's ``lam`` and the N(0, 1/fan_in) projections."""
    cfg = get_config(MAMBA).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    nh = cfg.ssm.n_heads(cfg.d_model)
    _close(p["blocks.0.ssm.A_log"],
           np.log(np.linspace(1.0, nh, nh, dtype=np.float32)))
    assert (p["blocks.1.ssm.D"] == 1).all()
    assert not p["blocks.1.ssm.dt_bias"].any()
    std = p["blocks.0.ssm.w_in"].std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    g = dataclasses.replace(get_config(GRIFFIN).reduced(), n_layers=5)
    p = init_params(g, torch.Generator().manual_seed(1), "cpu")
    w = g.hybrid.lru_width
    _close(p["tail.1.lru.lam"], np.log(np.expm1(
        np.linspace(0.3, 1.4, w, dtype=np.float32))))
    assert "blocks.0.b2.attn.wq" in p and "blocks.0.b1.lru.w_rg" in p


# ---- the continuous batcher ------------------------------------------------

def _requests(cls, cfg, toks, gens, tick_s):
    return [cls(rid=f"r{i}", arch=cfg.name, prompt_len=toks.shape[1],
                max_gen=g, tokens=toks[i], arrival_s=i * 1.5 * tick_s)
            for i, g in enumerate(gens)]


@pytest.mark.parametrize("variant,prompt_len,cache_len",
                         [("mamba", 8, 16), ("griffin", 70, 80)])
def test_batcher_matches_the_jax_engine(variant, prompt_len, cache_len):
    """tests/test_serve_batching.py:70 for the port: staggered arrivals
    (requests join while others decode), mixed max_gen (early finishes
    free slots), more requests than slots (recycled slots, whose
    recurrent state and ring must not leak), the hybrid's prompts past its
    window; the port's engine gives the JAX engine's tokens and batch-1
    ``generate``'s."""
    cfg, model, params, lm = _pair(variant)
    gens = [6, 3, 9, 4, 7]
    toks = _tokens(cfg, len(gens), prompt_len, 4)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=cache_len)
    out = engine.run(_requests(Request, cfg, toks, gens, engine.tick_s))
    assert engine.calls["insert"] == len(gens)
    jax_engine = JaxBatcher(model, params, n_slots=2, cache_len=cache_len)
    want = jax_engine.run(_requests(JaxRequest, cfg, toks, gens,
                                    jax_engine.tick_s))
    for i, g in enumerate(gens):
        assert np.array_equal(out[f"r{i}"], np.asarray(want[f"r{i}"])), i
        mine = generate(lm, {"tokens": torch.from_numpy(toks[i:i + 1])},
                        prompt_len, g, cache_len)
        assert np.array_equal(mine[0].numpy(), out[f"r{i}"]), f"gen r{i}"


def test_insert_replaces_every_leaf_of_a_slot():
    """Admission copies all of a slot's state: a pool filled with garbage
    holds, after one insert, exactly the prefilled cache in that slot and
    the garbage in the others."""
    cfg, _, _, lm = _pair("griffin")
    engine = ContinuousBatcher(lm, n_slots=3, cache_len=80)
    for _, buf, _ in slot_leaves(engine.pool):
        buf.fill_(7.0)
    _, cache = lm.prefill({"tokens": torch.from_numpy(
        _tokens(cfg, 1, 70, 5))}, 80)
    engine._insert(cache, 1)
    src = {name: t for name, t, _ in slot_leaves(cache)}
    for name, buf, ax in slot_leaves(engine.pool):
        assert torch.equal(buf.select(ax, 1), src[name].select(ax, 0))
        assert (buf.select(ax, 0) == 7).all() and (buf.select(ax, 2) == 7
                                                   ).all()


@pytest.mark.parametrize("fault", ["swapped", "missing"])
def test_insert_refuses_a_cache_that_does_not_fit_the_pool(fault):
    """Leaves are paired by name and must match in shape: a prefill cache
    whose tail block holds its conv state under ``h`` (and ``h`` under
    ``conv``), or that lacks a leaf, raises and leaves the pool as it
    was."""
    cfg, _, _, lm = _pair("griffin")
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=80)
    for _, buf, _ in slot_leaves(engine.pool):
        buf.fill_(7.0)
    _, cache = lm.prefill({"tokens": torch.from_numpy(
        _tokens(cfg, 1, 70, 5))}, 80)
    tail = cache["tail"][0]
    if fault == "swapped":
        tail["conv"], tail["h"] = tail["h"], tail["conv"]
    else:
        del tail["h"]
    with pytest.raises(ValueError, match="conv" if fault == "swapped"
                       else "does not fit"):
        engine._insert(cache, 1)
    assert all((buf == 7).all() for _, buf, _ in slot_leaves(engine.pool))


@pytest.mark.parametrize("arch,prompt_len", [(MAMBA, 16), (GRIFFIN, 70)])
def test_cli_serves_the_recurrent_families_on_the_cpu(arch, prompt_len):
    out = main(["--device", "cpu", "--arch", arch, "--trace", "3",
                "--prompt-len", str(prompt_len), "--gen", "3"])
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 3 for t in out.values())
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--arch", MAMBA, "--prompt-len", "20"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-3-2b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("n_layers", [2, 3, 5, 7])
def test_n_attention_layers_counts_the_attention_blocks(arch, n_layers):
    """``ModelConfig.n_attention_layers`` (the training steps' flash
    launch counts, the plan lint's cache size, the parameter count) is the
    number of blocks with attention weights the LM lays out: the hybrid's
    pattern repeated and cut, none in the SSM; the parameter count it
    feeds equals the reference's."""
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers)
    names = init_params(cfg, device="cpu")
    assert cfg.n_attention_layers == sum(n.endswith(".attn.wq")
                                         for n in names)
    jcfg = dataclasses.replace(jax_config(arch), n_layers=n_layers)
    assert dataclasses.replace(get_config(arch), n_layers=n_layers
                               ).n_params() == jcfg.n_params()
