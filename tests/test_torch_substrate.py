"""The port's training substrate: optimizer, data pipeline, checkpointer,
fault-tolerant loop and int8 gradient compression, held to the properties
of tests/test_substrate.py and tests/test_runtime_fault_tolerance.py:105-151,
and to the reference's ``optimizer.update``, ``quantize_int8`` and
``compressed_psum`` (on a one-process gloo group against a one-device
``shard_map``) on the same numbers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.dist.compat import shard_map
from repro.train import grad_compression as jax_gc
from repro.train import optimizer as jax_opt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.runtime.fault_tolerance import (StragglerWatchdog,
                                                 run_resilient)
from repro_torch.train import grad_compression as gc
from repro_torch.train import optimizer


# ------------------------------------------------------------- optimizer
def test_adamw_descends_quadratic():
    tcfg = TrainConfig(lr=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optimizer.init(params, tcfg)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}          # d/dw w^2
        params, state, metrics = optimizer.update(grads, state, params, tcfg)
    assert params["w"].abs().max().item() < 0.5
    assert np.isfinite(metrics["grad_norm"].item())


def test_grad_clip_bounds_update():
    tcfg = TrainConfig(lr=1.0, warmup_steps=0, grad_clip=1e-3,
                       weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    state = optimizer.init(params, tcfg)
    new_params, _, _ = optimizer.update({"w": torch.full((3,), 1e6)}, state,
                                        params, tcfg)
    assert new_params["w"].abs().max().item() < 10.0


def test_lr_schedule_warmup_and_decay():
    tcfg = TrainConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(optimizer.lr_schedule(tcfg, s)) for s in range(101)]
    assert lrs[1] < lrs[9] <= lrs[11]
    assert lrs[100] < lrs[20]
    assert max(lrs) <= 1e-3 * 1.001


def test_master_copy_mode():
    tcfg = TrainConfig(lr=0.01, warmup_steps=0, use_master_copy=True)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = optimizer.init(params, tcfg)
    assert state["master"]["w"].dtype == torch.float32
    new_params, new_state, _ = optimizer.update(
        {"w": torch.ones(4, dtype=torch.bfloat16)}, state, params, tcfg)
    assert new_params["w"].dtype == torch.bfloat16
    assert new_state["master"]["w"].dtype == torch.float32
    assert new_state["master"]["w"][0].item() < 1.0


@pytest.mark.parametrize("master", [False, True])
def test_update_matches_reference(master):
    """Three AdamW steps from the same params and gradients (fp32 and a
    bfloat16 leaf, bfloat16 moments under the master copy), both
    packages."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5,
              use_master_copy=master,
              master_dtype="bfloat16" if master else "float32")
    tcfg, jt = TrainConfig(**kw), JaxTrainConfig(**kw)
    w = rng.standard_normal((6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    params = {"w": torch.from_numpy(w.copy()),
              "b": torch.from_numpy(b).bfloat16()}
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)}
    state, jstate = optimizer.init(params, tcfg), jax_opt.init(jparams, jt)
    for _ in range(3):
        gw = rng.standard_normal((6, 5)).astype(np.float32)
        gb = rng.standard_normal(5).astype(np.float32)
        params, state, metrics = optimizer.update(
            {"w": torch.from_numpy(gw), "b": torch.from_numpy(gb)}, state,
            params, tcfg)
        jparams, jstate, jmetrics = jax_opt.update(
            {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, jstate, jparams,
            jt)
        for key in ("lr", "grad_norm"):
            assert metrics[key].item() == pytest.approx(
                float(jmetrics[key]), rel=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    trees = [(params, jparams), (state["m"], jstate["m"]),
             (state["v"], jstate["v"])]
    if master:
        trees.append((state["master"], jstate["master"]))
    for got, want in trees:
        for name in ("w", "b"):
            assert got[name].dtype == {
                np.dtype(np.float32): torch.float32}.get(
                    np.dtype(want[name].dtype), torch.bfloat16)
            np.testing.assert_allclose(
                got[name].float().numpy(),
                np.asarray(want[name]).astype(np.float32), rtol=1e-5,
                atol=1e-7 if got[name].dtype == torch.float32 else 1e-2)


# ------------------------------------------------------------------ data
def test_data_deterministic_and_step_dependent():
    cfg = DataConfig(vocab_size=101, seq_len=16, global_batch=4, seed=3)
    pipe = SyntheticTokens(cfg, device="cpu")
    b1, b2, b3 = pipe.batch(7), pipe.batch(7), pipe.batch(8)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < 101
    assert b1["labels"].shape == (4, 16)
    # labels are the next tokens of the affine recurrence (the last pads)
    assert torch.equal(b1["tokens"][:, 1:-1], b1["labels"][:, :-2])
    follows = (31 * b1["tokens"][:, :-1] + 17) % 101 == b1["labels"][:, :-1]
    assert follows.float().mean().item() > 0.8     # noise 0.05
    other = SyntheticTokens(DataConfig(vocab_size=101, seq_len=16,
                                       global_batch=4, seed=4), "cpu")
    assert not torch.equal(other.batch(7)["tokens"], b1["tokens"])


def test_data_modality_stubs_and_resume_state():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2, seed=0,
                     n_img_tokens=3, n_frames=5, d_model=4)
    b = SyntheticTokens(cfg, device="cpu").batch(0)
    assert b["img_embed"].shape == (2, 3, 4) and b["frames"].shape == (2, 5, 4)
    pipe = SyntheticTokens(DataConfig(vocab_size=50, seq_len=8,
                                      global_batch=2), device="cpu")
    assert SyntheticTokens.resume_step(pipe.state_dict(step=42)) == 42


# ------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    bf = torch.randn(4, generator=torch.Generator().manual_seed(0)).bfloat16()
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": bf, "blocks.0.attn.wq": torch.ones(2, 2)},
            "count": torch.tensor(5, dtype=torch.int32),
            "host": np.float64(2.5), "seven": 7}
    ck.save(10, tree, {"next_step": 10})
    got, extra = ck.restore()
    assert extra["next_step"] == 10
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"].view(torch.int16), bf.view(torch.int16))
    assert torch.equal(got["b"]["blocks.0.attn.wq"], torch.ones(2, 2))
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 5
    assert float(got["host"]) == 2.5 and int(got["seven"]) == 7


def test_checkpoint_gc_keeps_last_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.ones(2)})
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.full((8,), 3.0)
    ck.async_save(3, {"x": x})
    x.fill_(4.0)                # written after the call: not in step 3
    ck.wait()
    got, _ = ck.restore(3)
    assert float(got["x"][0]) == 3.0


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_99.tmp").mkdir()          # simulated dead writer
    ck.save(1, {"x": torch.ones(1)})
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()


# -------------------------------------------------------- fault tolerance
def _counting_step(trace):
    def step_fn(state, step):
        trace.append(step)
        return {"x": state["x"] + 1.0}, {"loss": float(step)}
    return step_fn


def test_resilient_loop_restarts_and_completes(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    faults = {7}

    def fault_hook(step):
        if step in faults:
            faults.discard(step)
            raise RuntimeError("injected node failure")

    res = run_resilient(total_steps=12, checkpointer=ck,
                        init_state=lambda: {"x": torch.zeros(())},
                        step_fn=lambda st, s: ({"x": st["x"] + 1},
                                               {"loss": float(s)}),
                        save_every=4, fault_hook=fault_hook,
                        async_checkpoint=False)
    assert res.last_step == 12 and res.restarts == 1
    assert float(ck.restore()[0]["x"]) == 12 == float(res.state["x"])


def test_run_resilient_resumes_from_checkpoint_across_invocations(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    trace1 = []
    res1 = run_resilient(total_steps=6, checkpointer=ckpt,
                         init_state=lambda: {"x": np.float64(0.0)},
                         step_fn=_counting_step(trace1), save_every=3,
                         async_checkpoint=False)
    assert res1.last_step == 6 and trace1 == [0, 1, 2, 3, 4, 5]
    assert ckpt.latest_step() == 6
    trace2 = []
    res2 = run_resilient(total_steps=10, checkpointer=ckpt,
                         init_state=lambda: pytest.fail(
                             "resume must not re-init state"),
                         step_fn=_counting_step(trace2), save_every=3,
                         async_checkpoint=True)
    assert trace2 == [6, 7, 8, 9]
    assert res2.last_step == 10 and res2.restarts == 0
    state, extra = ckpt.restore()
    assert extra["next_step"] == 10
    assert float(state["x"]) == pytest.approx(10.0)


def test_run_resilient_rolls_back_to_last_good_checkpoint(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")
    trace = []
    boom = {"armed": True}

    def fault_hook(step):
        if step == 4 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device halt")

    res = run_resilient(total_steps=6, checkpointer=ckpt,
                        init_state=lambda: {"x": np.float64(0.0)},
                        step_fn=_counting_step(trace), save_every=3,
                        fault_hook=fault_hook, async_checkpoint=False)
    assert res.restarts == 1 and res.last_step == 6
    assert trace == [0, 1, 2, 3, 3, 4, 5]
    assert float(ckpt.restore()[0]["x"]) == pytest.approx(6.0)


def test_run_resilient_gives_up_after_max_restarts(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck")

    def fault_hook(step):
        raise RuntimeError("permanently broken")

    with pytest.raises(RuntimeError, match="permanently broken"):
        run_resilient(total_steps=4, checkpointer=ckpt,
                      init_state=lambda: {"x": np.float64(0.0)},
                      step_fn=_counting_step([]), max_restarts=2,
                      fault_hook=fault_hook, async_checkpoint=False)


def test_straggler_watchdog_flags_outlier():
    wd = StragglerWatchdog(threshold=3.0)
    for i in range(20):
        wd.record(i, 0.1 + 0.001 * (i % 3))
    assert not wd.flagged
    assert wd.record(20, 5.0)
    assert wd.flagged[0]["step"] == 20


# ---------------------------------------------------- grad compression
@pytest.mark.parametrize("seed", range(8))
def test_int8_quantization_matches_reference_and_error_bound(seed):
    x = np.random.default_rng(seed).standard_normal(64).astype(np.float32) \
        * (seed % 7 + 1)
    q, scale = gc.quantize_int8(torch.from_numpy(x))
    jq, jscale = jax_gc.quantize_int8(jnp.asarray(x))
    assert torch.equal(q, torch.from_numpy(np.asarray(jq)))
    assert scale.item() == pytest.approx(float(jscale), rel=1e-7)
    err = (gc.dequantize_int8(q, scale) - torch.from_numpy(x)).abs()
    assert err.max().item() <= scale.item() * 0.5 + 1e-6


@pytest.fixture
def gloo_world(tmp_path):
    """A one-process gloo group (a file store: no network)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_psum_matches_reference_on_one_rank(gloo_world):
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((8, 16)).astype(np.float32) * 0.1,
         "b": rng.standard_normal(5).astype(np.float32)}
    ef = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
          for k, v in g.items()}
    mesh = Mesh(np.array(jax.devices()[:1]), ("pod",))
    spec = {k: P() for k in g}
    body = shard_map(lambda g, e: jax_gc.compressed_psum(g, e, "pod"),
                     mesh=mesh, in_specs=(spec, spec),
                     out_specs=(spec, spec))
    want, want_ef = body({k: jnp.asarray(v) for k, v in g.items()},
                         {k: jnp.asarray(v) for k, v in ef.items()})
    got, got_ef = gc.compressed_psum(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in ef.items()})
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_ef[k].numpy(), np.asarray(want_ef[k]),
                                   rtol=1e-5, atol=1e-7)
    plain = gc.plain_psum({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        assert torch.equal(plain[k], torch.from_numpy(g[k]))
        # the residual joins the feedback: reduced + new ef == g + ef
        np.testing.assert_allclose((got[k] + got_ef[k]).numpy(),
                                   g[k] + ef[k], rtol=1e-5, atol=1e-6)
    zeros = gc.init_error_feedback({k: torch.from_numpy(v)
                                    for k, v in g.items()})
    assert all(float(z.abs().max()) == 0 for z in zeros.values())
