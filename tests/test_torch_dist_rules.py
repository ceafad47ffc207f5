"""The port's meshes and sharding rules against the JAX package on the CPU.

(1) ``Rules.spec`` against the JAX ``Rules.spec`` (which reads only a
mesh's ``axis_names`` and ``shape``, so both run in-process on the same
stand-in mesh) on the reference test's cases and a seeded sweep of mesh
shapes, logical axes, dims, ``exclude_axes`` and ``decode_kv_seq_shard``.
(2) The shard each of 8 gloo ranks holds under ``NamedSharding``'s
placements against JAX's ``devices_indices_map`` for the device at the same
mesh position (8 forced host devices in a subprocess), tuple entries
included.  (3) ``param_axes``, ``cache_axes`` and ``opt_state_axes``
against the JAX trees through ``convert``'s names, for every config at
``reduced()``.  (8) A checkpoint saved from DTensors on a (2, 2) mesh of 4
ranks and restored by ``reshard_restore`` onto ``available_mesh((2, 1))``
in a world of 2.  (9) The training CLI's ``--pod-parallel --compress`` on
one rank against the plain CLI.  The ranks are spawned processes over a
``FileStore`` under ``tmp_path`` (no port); the JAX package is imported
only by the tests that compare with it in-process, so the spawned ranks
do not load it.
"""
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import run_multidevice
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.dist.sharding import (BASE_RULES, NamedSharding, NullRules,
                                       PartitionSpec, Rules, batch_axes,
                                       mesh_axes, tree_shardings)
from repro_torch.launch.mesh import (make_production_mesh, make_test_mesh,
                                     run_ranks)
from repro_torch.models import convert
from repro_torch.models.lm import LM, cache_axes, init_params, param_axes
from repro_torch.runtime.elastic import available_mesh, reshard_restore
from repro_torch.train.optimizer import opt_state_axes

CONFIGS = sorted(ARCHS)


def stand_in(axes, shape):
    """What both packages' ``Rules`` read of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


# ------------------------------------------------------------ (1) specs
def test_reference_rules_cases():
    """tests/test_distributed.py's divisibility and duplicate-axis
    cases."""
    mesh = stand_in(("data", "model"), (2, 4))
    rules = Rules(mesh, Plan())
    assert rules.spec(("embed", "heads", None), dims=(64, 10, 7)) == \
        PartitionSpec(("data",))
    assert rules.spec(("embed", "ff"), dims=(64, 16)) == \
        PartitionSpec(("data",), "model")
    rules = Rules(mesh, Plan(decode_kv_seq_shard=True))
    assert rules.spec(("batch", "kv_seq", "kv_heads", None),
                      dims=(8, 32, 8, 4)) == PartitionSpec(("data",),
                                                           "model")
    assert NullRules().spec(("batch",)) == PartitionSpec()
    assert batch_axes(stand_in(("model", "data", "pod"), (1, 2, 2))) == (
        "pod", "data")


SWEEP_MESHES = [
    (("data", "model"), (2, 4)), (("data", "model"), (4, 2)),
    (("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 2, 2)),
    (("pod", "data", "model"), (2, 16, 16)), (("data",), (8,)),
    (("pod",), (4,)), (("pod", "data"), (3, 2)), (("model", "data"), (2, 4)),
]
LOGICAL = sorted(BASE_RULES) + ["kv_seq", "layers", "seq", None]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 96, 128, 256, 512]


@pytest.mark.parametrize("kv_seq", [False, True])
@pytest.mark.parametrize("mesh_i", range(len(SWEEP_MESHES)))
def test_spec_matches_jax_on_a_sweep(mesh_i, kv_seq):
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    axes, shape = SWEEP_MESHES[mesh_i]
    mesh = stand_in(axes, shape)
    rng = np.random.default_rng(100 * mesh_i + kv_seq)
    for exclude in ((), ("pod",), ("model",)):
        ours = Rules(mesh, Plan(decode_kv_seq_shard=kv_seq), exclude)
        theirs = JaxRules(mesh, JaxPlan(decode_kv_seq_shard=kv_seq), exclude)
        for _ in range(40):
            nd = int(rng.integers(1, 5))
            logical = tuple(LOGICAL[i] for i in
                            rng.integers(0, len(LOGICAL), nd))
            dims = tuple(int(DIMS[i]) for i in rng.integers(0, len(DIMS),
                                                             nd))
            for d in (dims, None):
                got, want = ours.spec(logical, d), theirs.spec(logical, d)
                assert tuple(got) == tuple(want), (logical, d, got, want)


# ------------------------------------------------------------ (2) shards
SHARD_CASES = [
    (("pod",), (8,), (("pod",),), (16, 4)),
    (("pod", "data"), (2, 4), (("pod", "data"),), (16, 4)),
    (("pod", "data"), (2, 4), (("pod", "data"), None), (8, 6)),
    (("pod", "data"), (2, 4), (None, "data"), (3, 8)),
    (("data", "model"), (2, 4), ("data", "model"), (4, 8)),
    (("data", "model"), (4, 2), ("model", "data"), (4, 8)),
    (("data", "model"), (2, 4), (("data", "model"),), (16,)),
    (("pod", "data", "model"), (2, 2, 2), (("pod", "data"), None, "model"),
     (4, 3, 6)),
    (("pod", "data", "model"), (2, 2, 2), (("pod", "data", "model"),),
     (8, 2)),
    (("pod", "data", "model"), (2, 2, 2), ("model", ("pod", "data")),
     (2, 8)),
    (("pod", "data", "model"), (2, 2, 2), (("data", "model"), "pod"),
     (4, 4)),
    (("pod", "data", "model"), (2, 2, 2), (None,), (5,)),
    (("pod", "data", "model"), (2, 2, 2), (("pod", "model"),), (4,)),
]


def _full(shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)


def _shard_rank(rank, world, out_dir):
    meshes, got = {}, {}
    for i, (axes, shape, spec, tshape) in enumerate(SHARD_CASES):
        if (axes, shape) not in meshes:
            meshes[axes, shape] = make_test_mesh(shape, axes, device="cpu")
        sh = NamedSharding(meshes[axes, shape], PartitionSpec(*spec))
        got[i] = sh.distribute(_full(tshape)).to_local().clone()
    # constrain: a replicated DTensor redistributed to its logical axes
    mesh = meshes[("pod", "data", "model"), (2, 2, 2)]
    rules = Rules(mesh, Plan())
    x = NamedSharding(mesh, PartitionSpec()).distribute(_full((8, 4)))
    y = rules.constrain(x, ("batch", "ff"))
    got["constrain"] = (
        str(y.placements),
        str(rules.sharding(("batch", "ff"), (8, 4)).placements),
        torch.equal(y.full_tensor(), _full((8, 4))), tuple(y.to_local().shape))
    torch.save(got, f"{out_dir}/rank{rank}.pt")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """(port: rank -> case -> local shard, JAX: case -> [device, dim,
    (start, stop)] with devices in mesh order)."""
    tmp = tmp_path_factory.mktemp("shards")
    run_ranks(_shard_rank, 8, str(tmp), backend="gloo")
    run_multidevice(f"""
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = {{}}
for i, (axes, shape, spec, tshape) in enumerate({SHARD_CASES!r}):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tshape)
    out[str(i)] = np.array([[[s.start or 0, n if s.stop is None else s.stop]
                             for s, n in zip(idx[d], tshape)]
                            for d in mesh.devices.flat])
np.savez({str(tmp / 'jax.npz')!r}, **out)
print('ok')
""", n_devices=8)
    jax_idx = dict(np.load(tmp / "jax.npz"))
    return ({r: torch.load(tmp / f"rank{r}.pt") for r in range(8)},
            jax_idx)


@pytest.mark.parametrize("case", range(len(SHARD_CASES)))
def test_rank_shard_is_the_jax_device_shard(shards, case):
    ours, theirs = shards
    tshape = SHARD_CASES[case][3]
    full = _full(tshape)
    for r in range(8):
        box = theirs[str(case)][r]
        want = full[tuple(slice(a, b) for a, b in box)]
        assert torch.equal(ours[r][case], want), (case, r)


def test_constrain_redistributes_a_dtensor(shards):
    """On a (2, 2, 2) mesh a replicated [8, 4] DTensor constrained to
    ("batch", "ff") is sharded over pod x data and model, whole values
    kept."""
    for r in range(8):
        placed, asked, same, local = shards[0][r]["constrain"]
        assert placed == asked and same and local == (2, 2), (r, placed)


def test_a_tuple_against_the_mesh_order_has_no_placement():
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "pod"))
    with pytest.raises(ValueError, match="mesh's order"):
        NamedSharding(mesh, PartitionSpec(("pod", "data"))).placements
    ok = NamedSharding(mesh, PartitionSpec(("data", "pod"), None))
    assert [str(p) for p in ok.placements] == ["S(0)", "S(0)"]


def test_production_mesh_under_the_fake_process_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=512)
    try:
        multi = make_production_mesh(multi_pod=True, device="cpu")
        single = make_production_mesh(device="cpu")
        assert mesh_axes(multi) == {"pod": 2, "data": 16, "model": 16}
        assert mesh_axes(single) == {"data": 16, "model": 16}
        assert tuple(multi.get_coordinate()) == (0, 0, 3)
        spec = Rules(multi, Plan()).spec(("batch", "seq", "embed"),
                                         (64, 128, 2048))
        assert spec == PartitionSpec(("pod", "data"))
    finally:
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        with pytest.raises(ValueError, match="256"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- (3) axes
def _port_named(tree, cfg):
    """A JAX params-shaped tree of axes tuples -> the port's names, the
    stacked leading axes dropped (``convert``'s unstacking)."""
    from repro_torch.models.lm import flatten
    lead_of = convert.stacks(cfg)
    out = {k: v for k, v in flatten(
        {k: v for k, v in tree.items()
         if k not in lead_of and k != "tail"}).items()}
    for key, lead in lead_of.items():
        for name, ax in flatten(tree[key]).items():
            assert ax[:len(lead)] == ("layers",) * len(lead), (key, ax)
            for idx in np.ndindex(*lead):
                out[".".join([key, *map(str, idx), name])] = ax[len(lead):]
    for i, block in enumerate(tree.get("tail", [])):
        out.update(flatten(block, f"tail.{i}."))
    return out


@pytest.mark.parametrize("arch", CONFIGS)
def test_param_axes_match_jax_and_the_lm(arch):
    from repro.configs import get_config as jax_config
    from repro.models.lm import param_axes as jax_param_axes
    cfg = get_config(arch).reduced()
    ours = param_axes(cfg)
    assert ours == _port_named(jax_param_axes(jax_config(arch).reduced()),
                               cfg)
    lm = LM(cfg, init_params(cfg, device="cpu"))
    params = lm.params()
    assert set(ours) == set(params)
    assert all(len(ours[n]) == p.ndim for n, p in params.items())


@pytest.mark.parametrize("arch", CONFIGS)
def test_param_shardings_match_jax_on_the_production_mesh(arch):
    from repro.dist.plan import Plan as JaxPlan
    from repro.dist.sharding import Rules as JaxRules
    cfg = get_config(arch).reduced()
    mesh = stand_in(("pod", "data", "model"), (2, 16, 16))
    lm = LM(cfg, init_params(cfg, device="cpu"))
    got = tree_shardings(Rules(mesh, Plan()), param_axes(cfg), lm.params())
    theirs = JaxRules(mesh, JaxPlan())
    for name, p in lm.params().items():
        assert tuple(got[name].spec) == tuple(
            theirs.spec(param_axes(cfg)[name], tuple(p.shape))), name


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", CONFIGS)
def test_cache_axes_match_jax(arch, quant):
    from repro.configs import get_config as jax_config
    from repro.models.lm import cache_axes as jax_cache_axes
    assert cache_axes(get_config(arch).reduced(), quant) == jax_cache_axes(
        jax_config(arch).reduced(), quant)


@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("arch", CONFIGS)
def test_opt_state_axes_match_jax(arch, master):
    from repro.configs import get_config as jax_config
    from repro.configs.base import TrainConfig as JaxTrainConfig
    from repro.models.lm import param_axes as jax_param_axes
    from repro.train.optimizer import opt_state_axes as jax_opt_state_axes
    cfg = get_config(arch).reduced()
    ours = opt_state_axes(param_axes(cfg), TrainConfig(
        use_master_copy=master))
    theirs = jax_opt_state_axes(jax_param_axes(jax_config(arch).reduced()),
                                JaxTrainConfig(use_master_copy=master))
    assert set(ours) == set(theirs)
    for key in theirs:
        if key == "count":
            assert ours[key] == theirs[key] == ()
        else:
            assert ours[key] == _port_named(theirs[key], cfg), key


# ------------------------------------------------- (8) resharded restore
RESHARD_ARCH = "granite-3-2b"


def _reshard_params():
    cfg = get_config(RESHARD_ARCH).reduced()
    return cfg, init_params(cfg, torch.Generator().manual_seed(3), "cpu")


def _save_rank(rank, world, ckpt_dir):
    cfg, params = _reshard_params()
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    sh = tree_shardings(Rules(mesh, Plan()), param_axes(cfg), params)
    tree = {"params": {n: sh[n].distribute(p) for n, p in params.items()}}
    Checkpointer(ckpt_dir).save(7, tree, {"next_step": 7})


def _restore_rank(rank, world, ckpt_dir, out_dir):
    cfg, params = _reshard_params()
    mesh = available_mesh((2, 1), device="cpu")
    tree, extra = reshard_restore(
        Checkpointer(ckpt_dir), step=7, new_mesh=mesh, plan=Plan(), cfg=cfg,
        make_abstract=lambda: {"params": params},
        axes_tree={"params": param_axes(cfg)})
    want = tree_shardings(Rules(mesh, Plan()), param_axes(cfg), params)
    got = {n: (str(t.placements), str(want[n].placements),
               torch.equal(t.full_tensor(), p),
               tuple(t.to_local().shape))
           for n, p in params.items() for t in [tree["params"][n]]}
    torch.save({"got": got, "extra": extra,
                "mesh": mesh_axes(mesh), "dev": str(mesh.device_type)},
               f"{out_dir}/restore{rank}.pt")


def test_checkpoint_reshards_onto_the_smaller_mesh(tmp_path):
    run_ranks(_save_rank, 4, str(tmp_path / "ck"), backend="gloo")
    run_ranks(_restore_rank, 2, str(tmp_path / "ck"), str(tmp_path),
              backend="gloo")
    cfg, params = _reshard_params()
    for r in range(2):
        res = torch.load(tmp_path / f"restore{r}.pt")
        assert res["mesh"] == {"data": 2, "model": 1}
        assert res["extra"] == {"next_step": 7}
        sharded = 0
        for name, (placed, asked, same, local) in res["got"].items():
            assert same, name
            assert placed == asked, (name, placed, asked)
            sharded += "Shard" in placed
        # every "embed" dim of 64 divides over data = 2
        assert sharded > len(params) // 2
        assert res["got"]["embed"][3] == (cfg.padded_vocab,
                                          cfg.d_model // 2)


# ------------------------------------------------------------- (9) CLI
def test_pod_flags_on_one_rank_match_the_plain_cli(tmp_path):
    """The reference's CLI runs the pod step only on a mesh with a "pod"
    axis; one rank's host mesh is ("data",) of 1, so --pod-parallel
    --compress gives the plain CLI's losses, and the CLI leaves no process
    group behind."""
    from repro_torch.launch.train import main
    args = ["--arch", "granite-3-2b", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "32", "--log-every", "100",
            "--device", "cpu"]
    plain = main([*args, "--ckpt-dir", str(tmp_path / "a")])
    pod = main([*args, "--ckpt-dir", str(tmp_path / "b"), "--pod-parallel",
                "--compress"])
    assert not dist.is_initialized()
    losses = [[float(h["loss"]) for h in r.metrics_history]
              for r in (plain, pod)]
    assert len(losses[0]) == 6 and losses[0] == losses[1]


def test_host_mesh_is_the_world_on_one_data_axis():
    from repro_torch.launch.mesh import make_host_mesh
    try:
        mesh = make_host_mesh(device="cpu")
        assert mesh_axes(mesh) == {"data": 1}
        assert dist.get_backend() == "gloo"
        again = available_mesh((4, 2), device="cpu")
        assert mesh_axes(again) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()
        assert not dist.is_initialized()


def test_ranks_and_meshes_are_the_cards_unless_told_otherwise(monkeypatch):
    """``run_ranks`` defaults to NCCL, which needs a card; a mesh left to
    its default device is a card mesh, refused over a gloo group unless
    the caller names the device."""
    from repro_torch.launch import mesh as mesh_mod
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.run_ranks(print, 2)
    assert mesh_mod.init_local_group("cpu")
    try:
        monkeypatch.setattr(mesh_mod, "resolve", lambda d=None: torch.device(
            "cuda" if d is None else d))
        with pytest.raises(ValueError, match="over a gloo group"):
            mesh_mod.make_test_mesh((1,), ("data",))
        assert mesh_axes(mesh_mod.make_test_mesh(
            (1,), ("data",), device="cpu")) == {"data": 1}
    finally:
        dist.destroy_process_group()


def test_constrain_is_the_identity_on_a_plain_tensor():
    rules = Rules(stand_in(("data", "model"), (2, 2)), Plan())
    x = torch.ones(4, 4)
    assert rules.constrain(x, ("batch", None)) is x
    assert NullRules().constrain(x, ("batch", None)) is x
    assert NullRules().sharding(("batch",)) is None
    cfg = get_config("granite-3-2b").reduced()
    assert tree_shardings(NullRules(), param_axes(cfg),
                          {n: None for n in param_axes(cfg)}) == {
        n: None for n in param_axes(cfg)}
