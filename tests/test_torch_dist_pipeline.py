"""The port's pipeline executor and pipelined train step against the JAX
package on the CPU.

``pipeline_apply`` (forward, and the gradient of ``(out * ct).sum()`` for
the stage weights and the input) and one ``make_pipeline_train_step``
(loss and updated stage weights) with stages ``tanh(h @ w)``: gpipe and
one_f_one_b on 4 ranks, interleaved on 2 ranks with 2 virtual stages, each
at m in {1, S, 4S} microbatches, and the sequential fallback when B % m !=
0, against the JAX ``pipeline_apply`` / ``make_pipeline_train_step`` on
forced host devices at the reference test's limits (1e-5 forward, 1e-4
gradients and parameters).  Every rank of the pipeline must return the
same, whole values.  The JAX side runs in one subprocess
(``tests/helpers.py``), the port's in one spawn of 4 gloo ranks over a
``FileStore`` under ``tmp_path``; inputs are seeded numpy.
"""
import numpy as np
import pytest
import torch

from helpers import run_multidevice
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.pipeline import pipeline_apply, sequential_apply
from repro_torch.dist.plan import Plan
from repro_torch.launch.mesh import make_test_mesh, run_ranks
from repro_torch.train import optimizer, train_step as ts

S, B, D = 4, 16, 8
LR = 1e-2
# (schedule, ranks, virtual stages, microbatches); the last is the fallback
CASES = [(sched, ranks, v, m)
         for sched, ranks, v in (("gpipe", 4, 1), ("one_f_one_b", 4, 1),
                                 ("interleaved", 2, 2))
         for m in (1, S, 4 * S)] + [("one_f_one_b", 4, 1, 3)]


def _inputs(tmp):
    rng = np.random.default_rng(14)
    np.savez(tmp / "in.npz",
             ws=(rng.standard_normal((S, D, D)) * 0.3).astype(np.float32),
             x=rng.standard_normal((B, D)).astype(np.float32),
             y=rng.standard_normal((B, D)).astype(np.float32),
             ct=rng.standard_normal((B, D)).astype(np.float32))


JAX_SIDE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import TrainConfig
from repro.dist.compat import AxisType, mesh_from_devices
from repro.dist.pipeline import pipeline_apply, sequential_apply
from repro.dist.plan import Plan
from repro.train import optimizer, train_step as ts

inp = {k: jnp.asarray(v) for k, v in np.load(TMP + '/in.npz').items()}
ws, x, y, ct = inp['ws'], inp['x'], inp['y'], inp['ct']
tcfg = TrainConfig(lr=LR, warmup_steps=1)
out = {'seq': sequential_apply(lambda w, h: jnp.tanh(h @ w), ws, x)}

def stage_fn(w, h):
    return jnp.tanh(h @ w)

for i, (sched, ranks, v, m) in enumerate(CASES):
    mesh = mesh_from_devices(jax.devices()[:ranks], (ranks,), ('pod',),
                             axis_types=(AxisType.Auto,))
    def f(ws, x):
        o = pipeline_apply(stage_fn, ws, x, mesh, microbatches=m,
                           schedule=sched, virtual_stages=v)
        return (o * ct).sum(), o
    (_, o), (gw, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(ws, x)
    plan = Plan(microbatches=m, pipeline_schedule=sched, virtual_stages=v)
    step = ts.make_pipeline_train_step(stage_fn, tcfg, mesh, plan)
    p1, _, met = jax.jit(step)(ws, optimizer.init(ws, tcfg), (x, y),
                               jnp.int32(0))
    out.update({f'{i}/out': o, f'{i}/gw': gw, f'{i}/gx': gx,
                f'{i}/p1': p1, f'{i}/loss': met['loss']})
np.savez(TMP + '/jax.npz', **{k: np.asarray(v) for k, v in out.items()})
print('ok')
"""


def stage_fn(w, h):
    return torch.tanh(h @ w)


def _rank(rank, world, tmp):
    inp = {k: torch.from_numpy(v) for k, v in np.load(f"{tmp}/in.npz")
           .items()}
    tcfg = TrainConfig(lr=LR, warmup_steps=1)
    meshes = {r: make_test_mesh((r,), ("pod",), device="cpu")
              for r in (4, 2)}
    out = {"seq": sequential_apply(stage_fn, inp["ws"], inp["x"])}
    for i, (sched, ranks, v, m) in enumerate(CASES):
        mesh = meshes[ranks]
        if mesh.get_coordinate() is None:
            continue
        ws = inp["ws"].clone().requires_grad_()
        x = inp["x"].clone().requires_grad_()
        o = pipeline_apply(stage_fn, ws, x, mesh, microbatches=m,
                           schedule=sched, virtual_stages=v)
        gw, gx = torch.autograd.grad((o * inp["ct"]).sum(), [ws, x])
        plan = Plan(microbatches=m, pipeline_schedule=sched,
                    virtual_stages=v)
        step = ts.make_pipeline_train_step(stage_fn, tcfg, mesh, plan)
        p1 = inp["ws"].clone()
        p1, _, met = step(p1, optimizer.init({"stages": p1}, tcfg),
                          (inp["x"], inp["y"]), 0)
        out.update({f"{i}/out": o.detach(), f"{i}/gw": gw, f"{i}/gx": gx,
                    f"{i}/p1": p1, f"{i}/loss": met["loss"]})
    torch.save(out, f"{tmp}/rank{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_pipeline")
    _inputs(tmp)
    run_multidevice(f"TMP = {str(tmp)!r}\nLR = {LR!r}\nCASES = {CASES!r}\n"
                    + JAX_SIDE, n_devices=4)
    run_ranks(_rank, 4, str(tmp), backend="gloo")
    return dict(np.load(tmp / "jax.npz")), {
        r: torch.load(tmp / f"rank{r}.pt") for r in range(4)}


def test_sequential_apply_matches_jax(runs):
    jx, ranks = runs
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["seq"].numpy(), jx["seq"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pipeline_apply_matches_jax(runs, case):
    jx, ranks = runs
    n = CASES[case][1]
    for r in range(n):
        got = ranks[r]
        np.testing.assert_allclose(got[f"{case}/out"].numpy(),
                                   jx[f"{case}/out"], rtol=1e-5, atol=1e-5)
        for g in ("gw", "gx"):
            np.testing.assert_allclose(got[f"{case}/{g}"].numpy(),
                                       jx[f"{case}/{g}"], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{g} rank {r}")
        assert torch.equal(got[f"{case}/gw"], ranks[0][f"{case}/gw"])
    per_stage = np.abs(jx[f"{case}/gw"]).sum(axis=(1, 2))
    assert (per_stage > 0).all()


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pipeline_train_step_matches_jax(runs, case):
    jx, ranks = runs
    for r in range(CASES[case][1]):
        got = ranks[r]
        assert abs(float(got[f"{case}/loss"]) - float(jx[f"{case}/loss"])) \
            <= 1e-5
        np.testing.assert_allclose(got[f"{case}/p1"].numpy(),
                                   jx[f"{case}/p1"], rtol=1e-4, atol=1e-5)


def test_pipeline_without_a_pipeline_axis_is_sequential():
    g = torch.Generator().manual_seed(0)
    ws, x = torch.randn(S, D, D, generator=g), torch.randn(B, D, generator=g)
    want = sequential_apply(stage_fn, ws, x)
    assert torch.equal(pipeline_apply(stage_fn, ws, x, None), want)
    assert torch.equal(pipeline_apply(stage_fn, ws, x, None,
                                      schedule="no-such"), want)
