"""The cross-attention families against the JAX package: the VLM
(llama-3.2-vision-90b: groups of self-attention blocks and a cross block
over the image embeddings) and the audio encoder-decoder
(seamless-m4t-medium: a non-causal encoder over the frames, then decoder
layers of self and cross attention; layernorm, gelu and biases).  Inputs
come from numpy seeds, the JAX ``Model.init`` weights are carried across by
``repro_torch.models.convert``, with every norm scale and bias drawn at
random on both sides so that those paths carry weight.  Tolerances: 1e-5
per block in fp32, 1e-4 for whole-model logits, 2e-3 between prefill and
token-by-token decode from the context cache
(tests/test_lm_consistency.py:34), 2e-4 for the plain attention against
the Pallas kernel (interpret mode); the batchers' greedy tokens
exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.plan import Plan as JaxPlan
from repro.dist.sharding import NullRules
from repro.kernels import flash_attention as jax_fa
from repro.launch.serve import generate as jax_generate
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models.lm import Model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.dist.plan import Plan
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import generate, main, request_extras
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import (LM, CrossBlock, DenseBlock, init_cache,
                                   init_params, layer_caches, slot_leaves)
from repro_torch.serve import ContinuousBatcher, Request

VLM, AUDIO = "llama-3.2-vision-90b", "seamless-m4t-medium"
ARCHS = (VLM, AUDIO)
TOL, LM_TOL = 1e-5, 1e-4
CTX_KEY = {VLM: "img_embed", AUDIO: "frames"}
# leaves drawn at random on both sides (the init's are ones and zeros)
_RANDOM_LEAVES = ("scale", "bias", "bq", "bk", "bv", "bo", "b_in", "b_out")


def _cfgs(arch):
    return get_config(arch).reduced(), jax_config(arch).reduced()


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _randomize(params):
    """The JAX tree with every norm scale around 1 and every bias around 0
    drawn from a seed, so that the layernorm and bias paths are held."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for i, (path, leaf) in enumerate(leaves):
        name = getattr(path[-1], "key", None)
        if name in _RANDOM_LEAVES:
            noise = _normal(100 + i, *leaf.shape, scale=0.2)
            leaf = jnp.asarray(noise + (1.0 if name == "scale" else 0.0))
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(port cfg, JAX model, JAX params, port LM) on one set of weights."""
    cfg, jcfg = _cfgs(arch)
    model = Model(jcfg)
    params = _randomize(model.init(jax.random.PRNGKey(0)))
    state = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return cfg, model, params, LM(cfg, state)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _ctx_len(cfg):
    return cfg.n_img_tokens if cfg.family == "vlm" else cfg.n_frames


def _context(cfg, b, seed):
    return {CTX_KEY[cfg.name]: _normal(seed, b, _ctx_len(cfg), cfg.d_model)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- the blocks ------------------------------------------------------------

def _cross_params(arch, params):
    """The JAX params of the first cross block, and its port prefix."""
    if arch == VLM:
        return (jax.tree.map(lambda x: x[0], params["cross_blocks"]),
                "cross_blocks.0")
    return (jax.tree.map(lambda x: x[0], params["dec_blocks"]["cross"]),
            "dec_blocks.0.cross")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [1, 12, 40])
def test_cross_block_matches_jax(arch, seq):
    """``_apply_cross_block`` (prefill over a context longer or shorter than
    the prompt, with its K/V) and ``_apply_cross_block_cached`` (one decode
    step over the whole context)."""
    cfg, model, params, lm = _pair(arch)
    jp, prefix = _cross_params(arch, params)
    blk = CrossBlock(cfg, dict(lm.state_dict()), prefix, Plan())
    h = _normal(1, 2, seq, cfg.d_model)
    ctx = _normal(2, 2, _ctx_len(cfg), cfg.d_model)
    want, (wk, wv) = jax_lm._apply_cross_block(
        jp, model.cfg, JaxPlan(), NullRules(), jnp.asarray(h),
        jnp.asarray(ctx), collect=True)
    got, (k, v) = blk.prefill(_t(h), _t(ctx))
    _close(got, want)
    _close(k, wk)
    _close(v, wv)
    h1 = _normal(3, 2, 1, cfg.d_model)
    want = jax_lm._apply_cross_block_cached(jp, model.cfg, NullRules(),
                                            jnp.asarray(h1), wk, wv)
    lens = torch.full((2,), k.shape[1], dtype=torch.int32)
    _close(blk.decode(_t(h1), {"k": k, "v": v}, lens), want)


@pytest.mark.parametrize("n_frames", [32, 45])
def test_audio_encoder_matches_jax(n_frames):
    """``encode_audio``: RoPE'd non-causal layers with layernorm, gelu and
    biases, then ``enc_norm``, at the config's frame count and a ragged
    one."""
    cfg, model, params, lm = _pair(AUDIO)
    frames = _normal(4, 2, n_frames, cfg.d_model)
    want = jax_lm.encode_audio(model.cfg, JaxPlan(), NullRules(), params,
                               {"frames": jnp.asarray(frames)})
    _close(lm.encode(_t(frames)), want)
    assert all(not blk.causal for blk in lm.enc_blocks)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norms_match_jax(kind):
    d = 48
    x = _normal(5, 3, 7, d, scale=2.0) + 0.5
    p = {"scale": _normal(6, d, scale=0.2) + 1.0, "bias": _normal(7, d)}
    if kind == "rmsnorm":
        del p["bias"]
    want = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind)
    _close(layers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), kind),
           want)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_ffn_matches_jax(act, use_bias):
    d, f = 32, 64
    p = {"w_in": _normal(8, d, f, scale=d ** -0.5),
         "w_out": _normal(9, f, d, scale=f ** -0.5)}
    if act == "swiglu":
        p["w_gate"] = _normal(10, d, f, scale=d ** -0.5)
    if use_bias:
        p["b_in"], p["b_out"] = _normal(11, f), _normal(12, d)
    x = _normal(13, 2, 5, d)
    want = jax_layers.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act, use_bias)
    _close(layers.apply_ffn({k: _t(v) for k, v in p.items()}, _t(x), act,
                            use_bias), want)


# ---- non-causal attention over a context of another length ----------------

@pytest.mark.parametrize("sq,skv,bq,bkv", [(64, 96, 32, 32),
                                           (96, 32, 32, 32),
                                           (128, 64, 64, 64)])
def test_noncausal_plain_attention_matches_pallas(sq, skv, bq, bkv):
    """The plain version the card holds the flash kernel against, with
    ``Sq != Skv`` and no causal mask, against the Pallas flash kernel
    (interpret mode) where its blocks divide both lengths."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((3, sq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((3, skv, 32)).astype(np.float32)
            for _ in range(2))
    want = jax_fa.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  causal=False, block_q=bq, block_kv=bkv,
                                  interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    _close(got, want, 2e-4)


@pytest.mark.parametrize("sq,skv", [(37, 50), (50, 16), (1, 33)])
@pytest.mark.parametrize("h,kv", [(4, 2), (8, 1), (4, 4)])
def test_noncausal_grouped_attention_matches_jax(sq, skv, h, kv):
    """``layers.attention(causal=False)`` from Sq ragged queries over Skv
    keys of grouped heads (the [B*H, S, D] reshapes of each length) against
    ``dense_attention(causal=False)``."""
    b, d = 2, 32
    q = _normal(14, b, sq, h, d)
    k, v = _normal(15, b, skv, kv, d), _normal(16, b, skv, kv, d)
    want = jax_layers.dense_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=False)
    got = layers.attention(_t(q), _t(k), _t(v), causal=False)
    assert got.shape == (b, sq, h, d)
    _close(got, want)


# ---- the whole LM ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq", [12, 40])
def test_prefill_and_decode_match_jax(arch, seq):
    """Last-position logits of the prefill over a prompt shorter and longer
    than the context, then 6 greedy decode steps (the JAX tokens fed to
    both), at 1e-4; the caches agree, cross K/V included."""
    cfg, model, params, lm = _pair(arch)
    cache_len = seq + 8
    batch = {"tokens": _tokens(cfg, 2, seq, 1), **_context(cfg, 2, 2)}
    want, jcache = jax.jit(lambda p, b: model.prefill(p, b, cache_len))(
        params, _jax_batch(batch))
    got, cache = lm.prefill(_torch_batch(batch), cache_len)
    _close(got, want, LM_TOL)
    _close(cache["cross"]["k"], jcache["cross"]["k"], LM_TOL)
    step = jax.jit(model.decode_step)
    for i in range(6):
        tok = np.array(jnp.argmax(want, -1), np.int32)[:, None]
        want, jcache = step(params, jcache, jnp.asarray(tok),
                            jnp.int32(seq + i))
        got, cache = lm.decode_step(cache, torch.from_numpy(tok), seq + i)
        _close(got, want, LM_TOL)
    _close(cache["attn"]["k"], jcache["attn"]["k"], LM_TOL)
    _close(cache["cross"]["v"], jcache["cross"]["v"], LM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_incremental_decode(arch):
    """The port's vectorized prefill cache against the cache built token by
    token from ``init_context_cache`` (tests/test_lm_consistency.py:34), and
    one more step from each; the context cache equals JAX's."""
    cfg, model, params, lm = _pair(arch)
    b, s, cache_len = 2, 12, 16
    batch = {"tokens": _tokens(cfg, b, s, 3), **_context(cfg, b, 4)}
    last_a, cache_a = lm.prefill(_torch_batch(batch), cache_len)
    cache_b = lm.init_context_cache(_torch_batch(batch), b, cache_len)
    jcache = model.init_context_cache(params, _jax_batch(batch), b,
                                      cache_len)
    _close(cache_b["cross"]["k"], jcache["cross"]["k"], LM_TOL)
    _close(cache_b["cross"]["v"], jcache["cross"]["v"], LM_TOL)
    assert not cache_b["attn"]["k"].any()
    toks = batch["tokens"]
    for pos in range(s):
        last_b, cache_b = lm.decode_step(
            cache_b, torch.from_numpy(toks[:, pos:pos + 1]), pos)
    _close(last_a, last_b.numpy(), 2e-3)
    tok = last_a.argmax(-1)[:, None]
    _close(lm.decode_step(cache_a, tok, s)[0],
           lm.decode_step(cache_b, tok, s)[0].numpy(), 2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_context_is_taken_in_any_dtype_and_raises_when_missing(arch):
    """A context in float64 numpy or a float32 tensor gives the same
    logits (it is cast to the activation type); a batch without its
    context raises, in prefill, in ``init_context_cache`` and at the
    engine's admission, and one of another batch or width raises too."""
    cfg, _, _, lm = _pair(arch)
    key = CTX_KEY[arch]
    toks = _tokens(cfg, 1, 8, 5)
    ctx = _context(cfg, 1, 6)[key]
    a, _ = lm.prefill({"tokens": toks, key: ctx.astype(np.float64)}, 12)
    b, _ = lm.prefill({"tokens": toks, key: torch.from_numpy(ctx)}, 12)
    assert torch.equal(a, b)
    for bad in ({"tokens": toks}, {"tokens": toks, key: None}):
        with pytest.raises(ValueError, match=key):
            lm.prefill(bad, 12)
        with pytest.raises(ValueError, match=key):
            lm.init_context_cache(bad, 1, 12)
    with pytest.raises(ValueError, match="does not fit"):
        lm.prefill({"tokens": toks, key: np.concatenate([ctx, ctx])}, 12)
    with pytest.raises(ValueError, match="does not fit"):
        lm.prefill({"tokens": toks, key: ctx[..., :-1]}, 12)
    engine = ContinuousBatcher(lm, n_slots=1, cache_len=12)
    with pytest.raises(ValueError, match=key):
        engine.run([Request(rid="r0", arch=cfg.name, prompt_len=8,
                            max_gen=2, tokens=toks[0])])


# ---- weights and caches ----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip_and_init(arch):
    """The state dict goes back to the JAX tree's nesting and stacking
    unchanged; ``init_params`` gives the same names and shapes as the
    converted JAX init (norm scales ones, biases zeros) and builds an LM."""
    cfg, _, params, lm = _pair(arch)
    state = dict(lm.state_dict())
    back = params_to_numpy(state, cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf))
    mine = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in state.items()}
    names = {"vlm": ["self_blocks.0.1.attn.wq", "cross_blocks.0.ffn.w_in"],
             "audio": ["enc_blocks.1.attn.bq", "enc_norm.bias",
                       "dec_blocks.1.self.ffn.b_out",
                       "dec_blocks.0.cross.attn.wk"]}[cfg.family]
    assert all(n in mine for n in names)
    assert all((t == 1).all() for n, t in mine.items()
               if n.endswith("norm.scale"))
    LM(cfg, mine)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_and_slot_axes(arch):
    """The JAX cache layout (the VLM's self-attention [groups, per, B, W,
    KV, Dh], the cross K/V [groups or L, B, S_ctx, KV, Dh]), each leaf's
    true slot axis, and the per-layer views in execution order."""
    cfg, model, _, lm = _pair(arch)
    b, w = 3, 20
    c = init_cache(cfg, b, w, device="cpu")
    jc = jax_lm.init_cache(model.cfg, b, w)
    assert {k: tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(jc)} == \
        {k: tuple(v.shape) for k, v in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda t: t.numpy(), c))}
    lead = 2 if cfg.family == "vlm" else 1
    assert [(name, ax) for name, _, ax in slot_leaves(c)] == \
        [("attn.k", lead), ("attn.v", lead), ("cross.k", 1), ("cross.v", 1)]
    for _, leaf, ax in slot_leaves(c):
        assert leaf.shape[ax] == b
    q = init_cache(cfg, b, w, device="cpu", quant=True)
    assert {name: ax for name, _, ax in slot_leaves(q)} == {
        "attn.k": lead, "attn.v": lead, "attn.k_scale": lead,
        "attn.v_scale": lead, "cross.k": 1, "cross.v": 1}
    assert q["cross"]["k"].dtype == torch.float32
    per_layer = layer_caches(cfg, c)
    assert len(per_layer) == len(lm.layers)
    for blk, lc in zip(lm.layers, per_layer):
        want = _ctx_len(cfg) if isinstance(blk, CrossBlock) else w
        assert isinstance(blk, (CrossBlock, DenseBlock))
        assert lc["k"].shape == (b, want, cfg.n_kv_heads, cfg.head_dim)


# ---- the continuous batcher ------------------------------------------------

def _requests(cls, cfg, toks, gens, tick_s, seed):
    return [cls(rid=f"r{i}", arch=cfg.name, prompt_len=toks.shape[1],
                max_gen=g, tokens=toks[i], arrival_s=i * 1.5 * tick_s,
                extras=request_extras(cfg, seed, i))
            for i, g in enumerate(gens)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_slots", [1, 2])
def test_batcher_matches_the_jax_engine(arch, n_slots):
    """tests/test_serve_batching.py:70 for the port, each request with its
    own context: staggered arrivals, mixed max_gen, more requests than
    slots (a slot re-admitted with another context, whose cross K/V must
    replace the last one's); the port's engine gives the JAX engine's
    tokens and batch-1 ``generate``'s."""
    cfg, model, params, lm = _pair(arch)
    gens, prompt_len, cache_len = [6, 3, 7, 4], 10, 20
    toks = _tokens(cfg, len(gens), prompt_len, 7)
    engine = ContinuousBatcher(lm, n_slots=n_slots, cache_len=cache_len)
    out = engine.run(_requests(Request, cfg, toks, gens, engine.tick_s, 3))
    assert engine.calls["insert"] == len(gens)
    jax_engine = JaxBatcher(model, params, n_slots=n_slots,
                            cache_len=cache_len)
    want = jax_engine.run(_requests(JaxRequest, cfg, toks, gens,
                                    jax_engine.tick_s, 3))
    for i, g in enumerate(gens):
        assert np.array_equal(out[f"r{i}"], np.asarray(want[f"r{i}"])), i
        batch = {"tokens": torch.from_numpy(toks[i:i + 1]),
                 **request_extras(cfg, 3, i)}
        mine = generate(lm, batch, prompt_len, g, cache_len)
        assert np.array_equal(mine[0].numpy(), out[f"r{i}"]), f"gen r{i}"
        theirs = jax_generate(model, params, _jax_batch(
            {"tokens": toks[i:i + 1], **request_extras(cfg, 3, i)}),
            prompt_len, g, cache_len)
        assert np.array_equal(np.asarray(theirs)[0], out[f"r{i}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_readmitted_slot_holds_only_the_new_context(arch):
    """Admission copies every leaf of a slot, the cross K/V too: a pool
    filled with garbage holds, after one insert, exactly the prefilled
    cache in that slot and the garbage in the others; a second insert
    with another context replaces the first's in full."""
    cfg, _, _, lm = _pair(arch)
    engine = ContinuousBatcher(lm, n_slots=3, cache_len=16)
    for _, buf, _ in slot_leaves(engine.pool):
        buf.fill_(7.0)
    toks = torch.from_numpy(_tokens(cfg, 1, 10, 8))
    caches = [lm.prefill({"tokens": toks, **_torch_batch(
        _context(cfg, 1, seed))}, 16)[1] for seed in (9, 10)]
    for cache in caches:
        engine._insert(cache, 1)
        src = {name: t for name, t, _ in slot_leaves(cache)}
        for name, buf, ax in slot_leaves(engine.pool):
            assert torch.equal(buf.select(ax, 1), src[name].select(ax, 0))
            assert (buf.select(ax, 0) == 7).all()
            assert (buf.select(ax, 2) == 7).all()
    assert not torch.equal(caches[0]["cross"]["k"], caches[1]["cross"]["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_slots_give_finite_logits(arch):
    """An engine's zeroed pool (every slot empty, the cross K/V zero):
    the decode step's logits are finite, the cross attention uniform over
    zero values."""
    cfg, _, _, lm = _pair(arch)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=16)
    logits, _ = lm.decode_step(engine.pool, torch.zeros((2, 1),
                                                        dtype=torch.long),
                               torch.tensor([0, 3]))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_cross_attention_families_on_the_cpu(arch):
    """The CLI attaches each request's seeded context (``synthetic_trace``
    and the gang batch)."""
    for extra in (["--trace", "3"], ["--batch", "2"]):
        out = main(["--device", "cpu", "--arch", arch, "--prompt-len", "6",
                    "--gen", "3", *extra])
        assert all(len(t) == 3 for t in out.values())
    a, b = request_extras(get_config(arch), 1, 0), \
        request_extras(get_config(arch), 1, 1)
    (key, ctx), = a.items()
    assert ctx.shape == (1, _ctx_len(get_config(arch)),
                         get_config(arch).d_model)
    assert ctx.dtype == np.float32 and not np.array_equal(ctx, b[key])
    assert request_extras(get_config("granite-3-2b"), 1, 0) == {}


def test_plain_attention_is_the_kernels_oracle_for_cross_lengths():
    """``ops.flash_attention`` on the CPU is ``ref.mha_ref`` at a cross
    shape (H=8 over KV=2 as strided views, Sq 20 over Skv 33), and its
    causal=False rows each sum the whole context: uniform keys give the
    mean of V."""
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((8, 20, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 33, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 33, 16), np.float32))
    got = ops.flash_attention(q, k, v, causal=False, kv_group=4)
    assert torch.equal(got, ref.mha_ref(q, k, v, causal=False, kv_group=4))
    flat = ops.flash_attention(q, torch.zeros_like(k), v, causal=False,
                               kv_group=4)
    torch.testing.assert_close(
        flat, v.mean(1, keepdim=True).repeat_interleave(4, 0).expand(
            -1, 20, -1), rtol=1e-6, atol=1e-6)
