"""The port's continuous batcher against the JAX engine on reduced
granite-3-2b with the same (converted) weights: token parity on the
mid-flight-joins trace of tests/test_serve_batching.py:44-67, the tick
clock's TTFT/energy/trace records, eos, rejection, the fixed pool, and the
entry points' device rule."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import generate as jax_generate
from repro.models.lm import Model
from repro.obs import Tracer as JaxTracer
from repro.obs import use_tracer as jax_use_tracer
from repro.power import GENERIC as JAX_GENERIC
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import Request as JaxRequest
from repro.serve.batching import synth_tokens as jax_synth_tokens
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate, main, synthetic_trace
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM, init_cache, init_params
from repro_torch.obs import Tracer, use_tracer
from repro_torch.power import GENERIC
from repro_torch.serve import ContinuousBatcher, Request, synth_tokens

ARCH = "granite-3-2b"


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX model, JAX params, port LM) on one set of weights."""
    model = Model(jax_config(ARCH).reduced())
    params = model.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    lm = LM(cfg, params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu"))
    return cfg, model, params, lm


def prompts(cfg, n, prompt_len, seed=1):
    return np.array(jax.random.randint(
        jax.random.PRNGKey(seed), (n, prompt_len), 0, cfg.vocab_size),
        dtype=np.int32)


def test_parity_with_midflight_joins_and_early_finishes(pair):
    """Staggered arrivals, heterogeneous max_gen and more requests than
    slots: the port's engine gives the JAX generate's tokens."""
    cfg, model, params, lm = pair
    prompt_len, cache_len = 8, 32
    gens = [6, 3, 9, 4, 7]
    toks = prompts(cfg, len(gens), prompt_len)
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=cache_len)
    reqs = [Request(rid=f"r{i}", arch=cfg.name, prompt_len=prompt_len,
                    max_gen=gens[i], tokens=toks[i],
                    arrival_s=i * 1.5 * engine.tick_s)
            for i in range(len(gens))]
    out = engine.run(reqs)
    for i, g in enumerate(gens):
        want = np.asarray(jax_generate(
            model, params, {"tokens": toks[i:i + 1]},
            prompt_len=prompt_len, gen=g, cache_len=cache_len))[0]
        assert np.array_equal(out[f"r{i}"], want), f"r{i}"
        mine = generate(lm, {"tokens": torch.from_numpy(toks[i:i + 1])},
                        prompt_len, g, cache_len)
        assert np.array_equal(mine[0].numpy(), want), f"generate r{i}"
    assert engine.metrics.summary()["completed"] == len(gens)
    assert engine.calls == {"prefill": 5, "insert": 5,
                            "decode_step": engine.calls["decode_step"]}


def test_tick_clock_metrics_and_trace_equal_the_jax_engine(pair):
    """TTFT, TPOT, ticks, energy and the engine/tick spans on the virtual
    clock are the JAX engine's, request for request."""
    cfg, model, params, lm = pair
    toks = prompts(cfg, 3, 8)
    arrivals = [0.0, 0.0, 0.2]

    def reqs(cls):
        return [cls(rid=f"r{i}", arch=cfg.name, prompt_len=8, max_gen=4,
                    tokens=toks[i], arrival_s=arrivals[i])
                for i in range(3)]

    jax_tracer, tracer = JaxTracer(), Tracer()
    jax_engine = JaxBatcher(model, params, n_slots=2, cache_len=32,
                            envelope=JAX_GENERIC)
    with jax_use_tracer(jax_tracer):
        jax_engine.run(reqs(JaxRequest))
    engine = ContinuousBatcher(lm, n_slots=2, cache_len=32,
                               envelope=GENERIC)
    with use_tracer(tracer):
        engine.run(reqs(Request))
    got, want = engine.metrics.summary(), jax_engine.metrics.summary()
    assert got["completed"] == 3 and got["tokens"] == 12
    assert got["ttft_p50_s"] > 0 and got["total_energy_j"] > 0
    for key in ("completed", "ticks", "tokens", "span_s", "ttft_p50_s",
                "ttft_p95_s", "tpot_mean_s", "total_energy_j",
                "joules_per_request"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    for rid, m in jax_engine.metrics.requests.items():
        mine = engine.metrics.requests[rid]
        assert (mine.admit_s, mine.first_token_s, mine.finish_s) == \
            pytest.approx((m.admit_s, m.first_token_s, m.finish_s)), rid
        assert mine.energy_j == pytest.approx(m.energy_j), rid
    strip = [{k: r[k] for k in ("name", "cat", "track", "t0", "t1",
                                "attrs")} for r in tracer.records]
    assert strip == [{k: r[k] for k in strip[0]}
                     for r in jax_tracer.records]
    assert len(strip) == got["ticks"]


def test_eos_stops_a_request_early(pair):
    cfg, _, _, lm = pair
    toks = prompts(cfg, 1, 8)
    base = ContinuousBatcher(lm, n_slots=1, cache_len=32)
    full = base.run([Request(rid="r0", arch=cfg.name, prompt_len=8,
                             max_gen=8, tokens=toks[0])])["r0"]
    k = next((i for i in range(1, len(full))
              if int(full[i]) not in [int(t) for t in full[:i]]), None)
    if k is None:               # greedy decode repeated one token throughout
        k = 0
    eos = int(full[k])
    engine = ContinuousBatcher(lm, n_slots=1, cache_len=32, eos_id=eos)
    out = engine.run([Request(rid="r0", arch=cfg.name, prompt_len=8,
                              max_gen=8, tokens=toks[0])])["r0"]
    assert len(out) == k + 1 and out[-1] == eos
    assert np.array_equal(out, full[:k + 1])


def test_engine_rejects_wrong_arch_and_bad_tokens(pair):
    cfg, _, _, lm = pair
    engine = ContinuousBatcher(lm, n_slots=1, cache_len=32)
    with pytest.raises(ValueError, match="arch"):
        engine.submit(Request(rid="x", arch="other-arch", prompt_len=8,
                              max_gen=2))
    with pytest.raises(ValueError, match="prompt_len"):
        engine.run([Request(rid="y", arch=cfg.name, prompt_len=8,
                            max_gen=2, tokens=np.zeros(4, np.int32))])
    with pytest.raises(ValueError):
        Request(rid="z", arch=cfg.name, prompt_len=0, max_gen=2)
    with pytest.raises(ValueError, match="n_slots"):
        ContinuousBatcher(lm, n_slots=0, cache_len=32)


def test_pool_is_allocated_once_and_cpu_launches_no_kernel(pair):
    cfg, _, _, lm = pair
    engine = ContinuousBatcher(lm, n_slots=3, cache_len=24)
    k, v = engine.pool["attn"]["k"], engine.pool["attn"]["v"]
    assert k.shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads, cfg.head_dim)
    ptrs = (k.data_ptr(), v.data_ptr())
    ops.reset_launch_counts()
    out = engine.run(synthetic_trace(cfg, 5, 6, 4, gap_s=engine.tick_s))
    assert sorted(out) == [f"r{i}" for i in range(5)]
    assert all(len(t) == 4 for t in out.values())
    assert (engine.pool["attn"]["k"].data_ptr(),
            engine.pool["attn"]["v"].data_ptr()) == ptrs
    assert engine.pool["attn"]["k"] is k
    assert set(ops.launch_counts().values()) == {0}


def test_synth_tokens_equal_the_jax_engine():
    for rid, n in (("r0", 8), ("abc", 33)):
        assert np.array_equal(synth_tokens(rid, n, 512),
                              jax_synth_tokens(rid, n, 512))


def test_cli_serves_on_the_cpu():
    out = main(["--device", "cpu", "--trace", "3", "--prompt-len", "6",
                "--gen", "3"])
    assert sorted(out) == ["r0", "r1", "r2"]
    assert all(len(t) == 3 for t in out.values())


def test_entry_points_default_to_the_card():
    cfg = get_config(ARCH).reduced()
    if torch.cuda.is_available():
        assert init_params(cfg)["embed"].device.type == "cuda"
        return
    for call in (lambda: init_params(cfg), lambda: init_cache(cfg, 1, 8),
                 lambda: params_from_numpy({}, cfg),
                 lambda: main(["--gen", "2"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
