"""The planner's mesh bridge past one device, against the JAX package on
the CPU.

``dist.bridge.mesh_verify`` on a ("data" 4, "model" 2) mesh of the fake
process group (``torch.testing._internal.distributed.fake_pg``: no ranks)
places each app's inputs as DTensors by the destination's role and traces
the candidate as one device runs it.  The reference's ``mesh_verify``
compiles the same candidates for a (4, 2) mesh of 8 forced host devices
(one subprocess).  Per (app, role), the dp winner built all-"dp" and the
tp winner all-"tp" from the apps' small inputs: the same verdict, and
collective bytes wherever the reference has them; 3mm's data role is
traced per device (its FLOPs at most 1.01 x a quarter of the one-device
trace's); an op DTensor cannot shard is gathered, not hidden; the FPGA
analogue and a missing cost runner give None; and ``plan_offload`` with
``CompiledCostRunner(mesh)`` records ``mesh_time_s`` for both loop
analogues (the reference's ``tests/test_dist.py:189, :209`` on this mesh).
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from helpers import run_multidevice
from repro_torch.apps import APPS
from repro_torch.backends import FPGA, GPU, MANY_CORE
from repro_torch.core.ga import GAConfig
from repro_torch.core.measure import CompiledCostRunner, TimedRunner
from repro_torch.core.planner import UserTarget, plan_offload
from repro_torch.dist import bridge
from repro_torch.dist.bridge import LocalMesh
from repro_torch.launch.mesh import make_test_mesh

MESH = (4, 2)
AXES = ("data", "model")
PAIRS = [(app, role) for app in ("3mm", "tdFIR", "NAS.BT")
         for role in ("data", "model")]
IMPL = {"data": "dp", "model": "tp"}

JAX_SIDE = """
import json
from repro.apps import APPS
from repro.core.destinations import GPU, MANY_CORE
from repro.core.measure import CompiledCostRunner
from repro.dist import bridge
from repro.launch.mesh import make_test_mesh
runner = CompiledCostRunner(make_test_mesh(MESH, AXES))
got = {}
for app_name, role in PAIRS:
    app = APPS[app_name]()
    impl = IMPL[role]
    fn = app.build({n.name: impl for n in app.nests})
    ev = bridge.mesh_verify(runner, MANY_CORE if role == 'data' else GPU,
                            fn, app.make_inputs(seed=0, small=True))
    rl = ev.info.get('roofline', {}) if ev is not None else {}
    got[app_name + '/' + role] = {
        'correct': bool(ev is not None and ev.correct),
        'collective_bytes': rl.get('collective_bytes_per_device', 0.0),
        'flops': rl.get('flops_per_device', 0.0)}
print('RESULT ' + json.dumps(got))
"""


def _fn(app, role):
    return app.build({n.name: IMPL[role] for n in app.nests})


@pytest.fixture
def fake_mesh():
    """A (4, 2) ("data", "model") mesh of the fake process group, this
    process rank 0 of 8."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_test_mesh(MESH, AXES, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    import json
    out = run_multidevice(f"MESH, AXES = {MESH!r}, {AXES!r}\n"
                          f"PAIRS, IMPL = {PAIRS!r}, {IMPL!r}\n" + JAX_SIDE,
                          n_devices=8)
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port():
    """Each pair's Evaluation on the fake mesh, and on the one-device
    mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        runner = CompiledCostRunner(make_test_mesh(MESH, AXES, device="cpu"))
        local = CompiledCostRunner(LocalMesh())
        got = {}
        for app_name, role in PAIRS:
            app = APPS[app_name]()
            inputs = app.make_inputs(0, small=True, device="cpu")
            dest = MANY_CORE if role == "data" else GPU
            got[app_name, role] = (
                bridge.mesh_verify(runner, dest, _fn(app, role), inputs),
                bridge.mesh_verify(local, dest, _fn(app, role), inputs))
        return got
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("app_name,role", PAIRS)
def test_sharded_verdicts_match_the_reference(reference, port, app_name,
                                              role):
    want = reference[f"{app_name}/{role}"]
    ev, _ = port[app_name, role]
    assert ev is not None and ev.correct == want["correct"], ev.info
    assert ev.correct and ev.time_s > 0
    assert ev.info["mesh"] == dict(zip(AXES, MESH))
    lead = ev.info["input_axes"][next(iter(ev.info["input_axes"]))]
    assert lead[0 if role == "data" else -1] == (
        "batch" if role == "data" else "ff")
    if want["collective_bytes"] > 0:
        assert ev.info["collective_bytes_per_device"] > 0
    assert ev.info["collective_bytes_per_device"] == \
        ev.info["roofline"]["collective_bytes_per_device"]
    assert ev.info["flops_per_device"] > 0


def test_3mm_data_role_is_traced_per_device(port):
    """Each device computes its own rows: 3mm's dp winner takes at most
    1.01 x a quarter of the one-device trace's FLOPs on "data" 4."""
    ev, whole = port["3mm", "data"]
    assert whole.info["collective_bytes_per_device"] == 0
    assert ev.info["flops_per_device"] <= \
        1.01 * whole.info["flops_per_device"] / MESH[0]


def test_an_op_dtensor_cannot_shard_is_gathered(fake_mesh):
    """tdFIR's grouped convolution over a channel split: DTensor has no
    way to shard it, so its operands are gathered whole (counted
    all-gathers) and it runs on whole tensors, its FLOPs the whole
    convolution's."""
    from repro_torch.core import trace_analysis
    from repro_torch.dist.sharding import Rules, tree_shardings
    app = APPS["tdFIR"]()
    inputs = app.make_inputs(0, small=True, device="cpu")
    fn = _fn(app, "data")
    shardings = tree_shardings(Rules(fake_mesh, bridge.DEST_PLANS["data"]),
                               bridge.state_axes(inputs, "data"), inputs)
    art = trace_analysis.trace(fn, inputs, shardings)
    convs = [op for op in art.ops if "convolution" in op.name]
    f, n = inputs["x_re"].shape
    assert convs and all(op.outputs[0][1][1] == f for op in convs)
    assert art.analyze()["count_all-gather"] > 0
    one = trace_analysis.trace(fn, inputs)
    assert sum(op.flops for op in convs) == sum(
        op.flops for op in one.ops if "convolution" in op.name)


def test_fpga_and_missing_runner_give_none(fake_mesh):
    app = APPS["3mm"]()
    inputs = app.make_inputs(0, small=True, device="cpu")
    fn = _fn(app, "data")
    runner = CompiledCostRunner(fake_mesh)
    assert runner.n_chips == int(np.prod(MESH))
    assert bridge.mesh_verify(runner, FPGA, fn, inputs) is None
    assert bridge.mesh_verify(None, MANY_CORE, fn, inputs) is None
    assert bridge.mesh_verify(CompiledCostRunner(), MANY_CORE, fn,
                              inputs) is None


def test_local_mesh_is_one_device():
    """The one-device mesh the modeled-cost path uses unless given
    another: axes data and model of size 1, nothing placed, no
    collective."""
    assert LocalMesh().size == 1 and dict(LocalMesh().shape) == {
        "data": 1, "model": 1}
    app = APPS["3mm"]()
    ev = bridge.mesh_verify(CompiledCostRunner(LocalMesh()), MANY_CORE,
                            _fn(app, "data"),
                            app.make_inputs(0, small=True, device="cpu"))
    assert ev.correct and ev.info["collective_bytes_per_device"] == 0
    assert ev.info["mesh"] == {"data": 1, "model": 1}


def test_planner_records_mesh_time_on_a_sharded_mesh(fake_mesh):
    app = APPS["tdFIR"]()
    report = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0),
        cost_runner=CompiledCostRunner(fake_mesh), device="cpu")
    assert len(report.records) == 6
    by_method = {(r.paper_analogue, r.method): r for r in report.records}
    for analogue in ("many-core CPU", "GPU"):
        rec = by_method[(analogue, "loop")]
        assert rec.mesh_time_s is not None and rec.mesh_time_s > 0
        assert "roofline" in rec.mesh_info
        assert rec.mesh_info["mesh"] == dict(zip(AXES, MESH))
        assert rec.energy_info["source"] == "roofline"
    assert by_method[("FPGA", "loop")].mesh_time_s is None
    assert torch.distributed.get_world_size() == 8
