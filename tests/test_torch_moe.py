"""The port's MoE (``repro_torch.models.moe`` and the MoE branches of the
LM) against the JAX package on reduced moonshot-v1-16b-a3b and arctic-480b
in fp32, with the same numpy inputs and the JAX ``Model.init`` weights
carried across by ``repro_torch.models.convert``: ``apply_moe`` with and
without drops, every activation, shared experts, the dense residual, the
aux term and tied router logits; LM prefill and decode logits, also at the
head layouts H = KV (moonshot's MHA) and 7 query heads a KV head (arctic's
group); prefill against incremental decode; the converter round trip; and
the continuous batcher token-identical to the JAX engine at a capacity
where routing the slots jointly would drop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.plan import Plan as JaxPlan
from repro.dist.sharding import NullRules
from repro.launch.serve import generate as jax_generate
from repro.models import moe as jax_moe
from repro.models.lm import Model
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.dist.plan import Plan
from repro_torch.launch.serve import generate, main
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.lm import LM, check_supported, init_params
from repro_torch.serve import ContinuousBatcher, Request

MOONSHOT, ARCTIC = "moonshot-v1-16b-a3b", "arctic-480b"
TOL = 1e-4        # LM logits, as tests/test_torch_lm.py
MOE_TOL = 1e-5    # apply_moe alone
# (arch, overrides of reduced()): the reduced configs, and the head layouts
# the full configs give the attention kernels
VARIANTS = {"moonshot": (MOONSHOT, {}),
            "moonshot/mha": (MOONSHOT, {"n_heads": 4, "n_kv_heads": 4}),
            "arctic": (ARCTIC, {}),
            "arctic/g7": (ARCTIC, {"n_heads": 7, "n_kv_heads": 1})}
_PAIRS = {}


def _pair(variant, plan=None):
    """(cfg, JAX model, JAX params, numpy tree, port LM) on one set of
    weights; ``plan`` a dict of Plan fields given to both packages."""
    key = (variant, tuple(sorted((plan or {}).items())))
    if key not in _PAIRS:
        arch, over = VARIANTS[variant]
        jcfg = dataclasses.replace(jax_config(arch).reduced(), **over)
        model = Model(jcfg, JaxPlan(**(plan or {})))
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, params)
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        lm = LM(cfg, params_from_numpy(tree, cfg, device="cpu"),
                Plan(**(plan or {})))
        _PAIRS[key] = (cfg, model, params, tree, lm)
    return _PAIRS[key]


def _tokens(cfg, b, s, seed):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                       cfg.vocab_size), np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _as_torch(tree):
    return {k: _as_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---- apply_moe against repro.models.moe.apply_moe --------------------------

def _moe_case(arch, act="swiglu", seed=0, **moe_over):
    jcfg = jax_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, ffn_act=act,
                               moe=dataclasses.replace(jcfg.moe, **moe_over))
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, ffn_act=act,
                              moe=dataclasses.replace(cfg.moe, **moe_over))
    p = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def _both(jcfg, cfg, p, x, cf, groups):
    want, want_aux = jax_moe.apply_moe(p, jcfg, jnp.asarray(x), NullRules(),
                                       cf, groups=groups)
    drops = torch.zeros(3, dtype=torch.long)
    got, aux = moe.apply_moe(_as_torch(jax.tree.map(np.asarray, p)), cfg,
                             torch.from_numpy(x), cf, groups, drops=drops)
    return got, aux, want, want_aux, drops


@pytest.mark.parametrize("arch", [MOONSHOT, ARCTIC])
@pytest.mark.parametrize("cf,groups", [(None, 1), (None, 2), (1.0, 1),
                                       (1.0, 2), (0.5, 1), (0.5, 2)])
def test_apply_moe_matches_jax(arch, cf, groups):
    """reduced()'s capacity factor 8 is drop-free; 1.0 and 0.5 drop, in one
    group and in two.  Moonshot has 2 shared experts, arctic its dense
    residual FFN."""
    jcfg, cfg, p, x = _moe_case(arch)
    got, aux, want, want_aux, drops = _both(jcfg, cfg, p, x, cf, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MOE_TOL)
    assert int(drops[0]) == x.shape[0] * x.shape[1] * cfg.moe.top_k
    assert (int(drops[1]) > 0) == (cf is not None), drops
    # the experts routed to: those among the tokens' top-k of the logits
    logits = x.reshape(-1, cfg.d_model) @ np.asarray(p["router"])
    picks = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.moe.top_k]
    assert int(drops[2]) == len(np.unique(picks)), drops


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_apply_moe_activations_match_jax(act):
    """Every activation the reference's expert FFN takes (geglu and gelu
    with tanh gelu), with drops."""
    jcfg, cfg, p, x = _moe_case(MOONSHOT, act, seed=1)
    assert ("w_gate" in p["experts"]) == (act in ("swiglu", "geglu"))
    got, _, want, _, drops = _both(jcfg, cfg, p, x, 1.0, 1)
    assert int(drops[1]) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)


@pytest.mark.parametrize("shared,dense", [(0, False), (2, False),
                                          (0, True), (1, True)])
def test_apply_moe_shared_and_dense_residual_match_jax(shared, dense):
    jcfg, cfg, p, x = _moe_case(ARCTIC, shared_experts=shared,
                                dense_residual=dense, dense_d_ff=48)
    assert ("shared" in p, "dense" in p) == (bool(shared), dense)
    got, aux, want, want_aux, _ = _both(jcfg, cfg, p, x, 0.5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=MOE_TOL)


def test_top_k_breaks_ties_toward_the_lower_index():
    """jax.lax.top_k on logits drawn from 3 values among 64 experts (ties
    everywhere): the same picks, in the same order."""
    rng = np.random.default_rng(2)
    logits = rng.integers(0, 3, (50, 64)).astype(np.float32)
    for k in (1, 2, 6):
        want_v, want_i = jax.lax.top_k(jnp.asarray(logits), k)
        got_v, got_i = moe.top_k(torch.from_numpy(logits), k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i)), k
        assert np.array_equal(got_v.numpy(), np.asarray(want_v)), k


@pytest.mark.parametrize("cf", [None, 0.5])
def test_apply_moe_with_tied_router_logits_matches_jax(cf):
    """A router whose columns repeat (experts 0, 1 and 2 score alike for
    every token): the picks are JAX's, so the outputs are too."""
    jcfg, cfg, p, x = _moe_case(MOONSHOT)
    p = dict(p, router=p["router"][:, jnp.array([0, 0, 0, 3])])
    logits = torch.from_numpy(x).reshape(1, -1, cfg.d_model) @ \
        torch.from_numpy(np.array(p["router"]))
    _, picks = moe.top_k(logits, cfg.moe.top_k)
    assert set(picks.reshape(-1).tolist()) <= {0, 1, 3}
    got, _, want, _, _ = _both(jcfg, cfg, p, x, cf, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_TOL,
                               atol=MOE_TOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_stacked_ffn_is_the_jax_expert_ffns(act):
    """``layers.apply_ffn`` on stacked expert weights over [E, C, D] and
    [G, E, C, D] against the reference's ``_expert_ffn`` and
    ``_expert_ffn_grouped`` einsums."""
    _, cfg, p, _ = _moe_case(MOONSHOT, act)
    rng = np.random.default_rng(4)
    x3 = rng.standard_normal((4, 5, cfg.d_model)).astype(np.float32)
    x4 = rng.standard_normal((3, 4, 5, cfg.d_model)).astype(np.float32)
    pt = _as_torch(jax.tree.map(np.asarray, p["experts"]))
    for x, want in ((x3, jax_moe._expert_ffn(p["experts"], x3, act)),
                    (x4, jax_moe._expert_ffn_grouped(p["experts"], x4,
                                                     act))):
        np.testing.assert_allclose(
            layers.apply_ffn(pt, torch.from_numpy(x), act).numpy(),
            np.asarray(want), rtol=MOE_TOL, atol=MOE_TOL)


# ---- the LM ---------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_logits_match_jax(variant):
    """Prefill logits and cache, then four decode steps with the batch
    routed jointly (as both packages' ``generate``), at 1e-4."""
    cfg, model, params, _, lm = _pair(variant)
    toks = _tokens(cfg, 2, 10, 3)
    jl, jc = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    _close(tl, jl)
    _close(tc["attn"]["k"], jc["attn"]["k"])
    step = jax.jit(model.decode_step)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.int32(10 + i))
        tl, tc = lm.decode_step(tc, torch.from_numpy(tok), 10 + i)
        _close(tl, jl)
    _close(tc["attn"]["v"], jc["attn"]["v"])


@pytest.mark.parametrize("plan", [
    {"moe_capacity_factor": 0.5, "moe_groups": 2},
    {"moe_capacity_factor": 0.5, "moe_groups": 2,
     "moe_impl": "shardmap_ep"}])
def test_capacity_plans_match_jax(plan):
    """Prefill under a dropping capacity in two groups, and the
    expert-parallel plan (one group on one device, whatever moe_groups
    says), against the JAX model with the same plan."""
    cfg, model, params, _, lm = _pair("moonshot", plan)
    toks = _tokens(cfg, 2, 12, 5)
    want, _ = jax.jit(lambda p, b: model.prefill(p, b, 16))(
        params, {"tokens": jnp.asarray(toks)})
    drops = lm.count_moe_drops()
    got, _ = lm.prefill({"tokens": torch.from_numpy(toks)}, 16)
    _close(got, want)
    assert int(drops[0, 1]) > 0 and int(drops[0, 0]) == \
        cfg.n_layers * 2 * 12 * cfg.moe.top_k
    other = dict(plan, moe_impl="gspmd" if "moe_impl" in plan
                 else "shardmap_ep")
    moved, _ = LM(cfg, dict(lm.state_dict()), Plan(**other)).prefill(
        {"tokens": torch.from_numpy(toks)}, 16)
    assert not torch.allclose(moved, got, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", ["moonshot", "arctic"])
def test_prefill_matches_incremental_decode(variant):
    """Port-only mirror of tests/test_lm_consistency.py:34 (same tolerance,
    reduced()'s drop-free capacity)."""
    cfg, _, _, _, lm = _pair(variant)
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


def test_per_row_routing_equals_each_row_alone():
    """``route_per_row``: four rows at a dropping capacity give each row's
    batch-1 logits; routed jointly the same rows drop pairs."""
    cfg, _, _, _, lm = _pair("arctic", {"moe_capacity_factor": 1.0})
    toks = torch.from_numpy(_tokens(cfg, 4, 9, 11))
    caches = [lm.prefill({"tokens": toks[i:i + 1, :n]}, 16)[1]
              for i, n in enumerate((3, 6, 9, 5))]
    pool = {"attn": {k: torch.cat([c["attn"][k] for c in caches], dim=1)
                     for k in ("k", "v")}}
    nxt, pos = torch.tensor([[5], [6], [7], [8]]), torch.tensor([3, 6, 9, 5])
    drops = lm.count_moe_drops()
    joint = {"attn": {k: v.clone() for k, v in pool["attn"].items()}}
    lm.decode_step(joint, nxt, pos)
    assert int(drops[1, 1]) > 0
    drops.zero_()
    got, _ = lm.decode_step(pool, nxt, pos, route_per_row=True)
    assert int(drops[1, 1]) == 0
    for i, n in enumerate((3, 6, 9, 5)):
        want, _ = lm.decode_step(caches[i], nxt[i:i + 1], n)
        torch.testing.assert_close(got[i:i + 1], want, rtol=TOL, atol=TOL)


def test_converter_round_trip_and_init_layout():
    """The MoE tree (``blocks.ffn.experts.w_in`` [L, E, d, f] in JAX,
    ``blocks.{i}.ffn.experts.w_in`` [E, d, f] in the port) both ways, and
    the port's own init with the same names and shapes."""
    for variant in ("moonshot", "arctic"):
        cfg, _, _, tree, lm = _pair(variant)
        state = dict(lm.state_dict())
        m = cfg.moe
        assert state["blocks.1.ffn.experts.w_out"].shape == \
            (m.n_experts, m.d_expert, cfg.d_model)
        assert state["blocks.0.ffn.router"].shape == (cfg.d_model,
                                                      m.n_experts)
        back = params_to_numpy(state, cfg)
        flat_j = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
        for (path, a), (_, b) in zip(flat_j, flat_b):
            assert np.array_equal(a, b), path
        fresh = init_params(cfg, device="cpu")
        assert {k: tuple(v.shape) for k, v in fresh.items()} == \
            {k: tuple(v.shape) for k, v in state.items()}


def test_init_moe_uses_the_jax_distributions():
    cfg = dataclasses.replace(get_config(ARCTIC).reduced(), d_model=256)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    m = cfg.moe
    for name, fan_in in (("experts.w_in", 256), ("experts.w_out",
                                                 m.d_expert),
                         ("router", 256), ("dense.w_gate", 256),
                         ("dense.w_out", m.dense_d_ff)):
        std = p[f"blocks.0.ffn.{name}"].std().item()
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name
    experts = p["blocks.0.ffn.experts.w_in"]
    assert not torch.equal(experts[0], experts[1])


def test_check_supported_takes_the_moe_family():
    """Both MoE configs and the expert-parallel plan run, and so do the
    SSM, hybrid, VLM and audio families (each builds an LM); since the
    soft-cap slice a capped MoE config too, which builds and prefills
    finite logits that the cap moves (its parity with the JAX model is in
    tests/test_torch_softcap.py)."""
    for arch in (MOONSHOT, ARCTIC):
        check_supported(get_config(arch))
        check_supported(get_config(arch), Plan(moe_impl="shardmap_ep"))
    for arch in ("recurrentgemma-2b", "mamba2-1.3b", "llama-3.2-vision-90b",
                 "seamless-m4t-medium"):
        check_supported(get_config(arch))
        cfg = get_config(arch).reduced()
        LM(cfg, init_params(cfg, device="cpu"))
    check_supported(dataclasses.replace(get_config(MOONSHOT),
                                        logit_softcap=30.0))
    cfg = get_config(MOONSHOT).reduced()
    state = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.arange(12).reshape(2, 6) % cfg.vocab_size}
    plain, _ = LM(cfg, state).prefill(toks, 8)
    capped, _ = LM(dataclasses.replace(cfg, logit_softcap=1.0),
                   state).prefill(toks, 8)
    assert torch.isfinite(capped).all()
    assert (capped - plain).abs().max().item() > 1e-3


# ---- the continuous batcher ------------------------------------------------

def _requests(cls, cfg, toks, gens, tick_s):
    return [cls(rid=f"r{i}", arch=cfg.name, prompt_len=toks.shape[1],
                max_gen=g, tokens=toks[i], arrival_s=i * 1.5 * tick_s)
            for i, g in enumerate(gens)]


class _JointProbe(ContinuousBatcher):
    """The port's engine, also routing each step's rows jointly on a copy
    of the pool to count the pairs that joint routing would drop."""

    def _step(self):
        drops = self.model.count_moe_drops()
        dev = self.model.device
        pool = {"attn": {k: v.clone() for k, v in self.pool["attn"].items()}}
        self.model.decode_step(
            pool, torch.from_numpy(self._last_tok).to(dev)[:, None],
            torch.from_numpy(self._pos).to(dev))
        self.joint_drops += int(drops[1, 1])
        drops.zero_()
        out = super()._step()
        self.per_row_drops += int(drops[1, 1])
        return out


class _JointEngine(ContinuousBatcher):
    """The port's engine with its slots routed jointly: the fault that the
    test below must catch."""

    def _step(self):
        self.calls["decode_step"] += 1
        return self.model.decode_step(
            self.pool, torch.from_numpy(self._last_tok)[:, None],
            torch.from_numpy(self._pos))[0]


def test_batcher_matches_the_jax_engine_where_joint_routing_drops():
    """Reduced moonshot at capacity factor 1.0 (a 4-slot step routed jointly
    has 2 slots an expert for 8 pairs): staggered arrivals, more requests
    than slots and mixed max_gen; the port's engine gives the JAX engine's
    tokens, the same steps routed jointly would have dropped pairs, and an
    engine that routes them jointly gives other tokens."""
    cfg, model, params, _, lm = _pair("moonshot", {"moe_capacity_factor": 1.0})
    gens = [9, 4, 12, 6, 8, 5]
    toks = _tokens(cfg, len(gens), 8, 1)
    engine = _JointProbe(lm, n_slots=4, cache_len=32)
    engine.joint_drops = engine.per_row_drops = 0
    out = engine.run(_requests(Request, cfg, toks, gens, engine.tick_s))
    jax_engine = JaxBatcher(model, params, n_slots=4, cache_len=32)
    want = jax_engine.run(_requests(JaxRequest, cfg, toks, gens,
                                    jax_engine.tick_s))
    for i in range(len(gens)):
        assert np.array_equal(out[f"r{i}"], np.asarray(want[f"r{i}"])), i
    assert engine.joint_drops > 0 and engine.per_row_drops == 0
    joint = _JointEngine(lm, n_slots=4, cache_len=32).run(
        _requests(Request, cfg, toks, gens, engine.tick_s))
    assert any(not np.array_equal(joint[f"r{i}"], np.asarray(want[f"r{i}"]))
               for i in range(len(gens)))


def test_batcher_matches_jax_generate_drop_free():
    """reduced()'s drop-free capacity, arctic at 7 query heads a KV head:
    the engine's tokens equal the JAX batch-1 generate's, and the port's
    generate gives them too."""
    cfg, model, params, _, lm = _pair("arctic/g7")
    gens = [6, 3, 9, 4, 7]
    toks = _tokens(cfg, len(gens), 8, 2)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=32)
    out = engine.run(_requests(Request, cfg, toks, gens, engine.tick_s))
    for i, g in enumerate(gens):
        want = np.asarray(jax_generate(
            model, params, {"tokens": toks[i:i + 1]}, prompt_len=8, gen=g,
            cache_len=32))[0]
        assert np.array_equal(out[f"r{i}"], want), f"r{i}"
        mine = generate(lm, {"tokens": torch.from_numpy(toks[i:i + 1])}, 8,
                        g, 32)
        assert np.array_equal(mine[0].numpy(), want), f"generate r{i}"


@pytest.mark.parametrize("arch", [MOONSHOT, ARCTIC])
def test_cli_serves_the_moe_family_on_the_cpu(arch):
    out = main(["--device", "cpu", "--arch", arch, "--trace", "3",
                "--prompt-len", "6", "--gen", "3"])
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 3 for t in out.values())
