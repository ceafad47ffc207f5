"""The port's modeled-cost path against the JAX package on the CPU: the trace
analysis against ``analyze_hlo``, the kernels' fake-tensor work formulas,
the H100 cost model, the publishing rule, and the reference's tests of the
mesh bridge, the modeled and power policies, the Candidate constructors,
the roofline energy charge and the end-to-end modeled margin, run on the
port (``tests/test_dist.py``, ``test_backends.py``, ``test_candidates.py``,
``test_power.py``, ``test_system.py``)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import DEFAULT_REGISTRY as JAX_REGISTRY
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.core import cost_model as jax_cm
from repro.core import plan_lookup as jax_pl
from repro.core.hlo_analysis import analyze_hlo
from repro.core.planner import VerificationRecord as JaxRecord
from repro_torch.apps import APPS
from repro_torch.backends import (DEFAULT_REGISTRY, FPGA, GPU, MANY_CORE,
                                  Backend, BackendRegistry, get_policy)
from repro_torch.backends.builtin import ga_loop_search
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core import cost_model
from repro_torch.core import plan_lookup as pl
from repro_torch.core.candidates import Candidate
from repro_torch.core.function_blocks import Registry
from repro_torch.core.ga import Evaluation, GAConfig
from repro_torch.core.measure import CompiledCostRunner, TimedRunner
from repro_torch.core.offloadable import LoopNest, OffloadableApp
from repro_torch.core.planner import (UserTarget, VerificationRecord,
                                      plan_offload)
from repro_torch.core.trace_analysis import TensorSpec, trace
from repro_torch.dist import bridge
from repro_torch.dist.bridge import LocalMesh
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import tdfir as fir
from repro_torch.power import (GENERIC, GPU_T4, H100_SXM, MANY_CORE_XEON,
                               EnergyModel, cell_energy, energy_for_record)

APP_NAMES = ("3mm", "NAS.BT", "tdFIR")


def spec_of(t):
    return TensorSpec(tuple(t.shape), t.dtype, t.device)


def _jax_analysis(fn, *shapes):
    comp = jax.jit(fn).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                               for s in shapes]).compile()
    return analyze_hlo(comp.as_text())


# ------------------------------------------------------------ the analysis
def test_lone_matmul_flops_match_analyze_hlo():
    want = _jax_analysis(lambda a, b: a @ b, (64, 128), (128, 32))
    got = trace(lambda ab: ab[0] @ ab[1],
                (TensorSpec((64, 128), device="cpu"),
                 TensorSpec((128, 32), device="cpu"))).analyze()
    assert got["flops"] == pytest.approx(2 * 64 * 128 * 32, rel=1e-12)
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)
    assert got["flops_fp32"] == got["flops"]
    io_bytes = 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert got["bytes"] >= io_bytes and want["bytes"] >= io_bytes * 0.9


@pytest.mark.parametrize("layers", [1, 7])
def test_matmul_loop_flops_match_analyze_hlo(layers):
    """A forward loop of matmuls with tanh: JAX's ``lax.scan`` with its trip
    count against the port's Python loop, traced op by op."""
    b, d = 64, 128

    def jax_f(ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, ws)
        return h.sum()

    def port_f(state):
        ws, h = state
        for i in range(ws.shape[0]):
            h = torch.tanh(h @ ws[i])
        return h.sum()

    want = _jax_analysis(jax_f, (layers, d, d), (b, d))
    got = trace(port_f, (TensorSpec((layers, d, d), device="cpu"),
                         TensorSpec((b, d), device="cpu"))).analyze()
    fwd = 2 * layers * b * d * d
    assert fwd <= got["flops"] < fwd * 1.05
    assert got["flops"] == pytest.approx(want["flops"], rel=0.05)


@pytest.mark.parametrize("name", APP_NAMES)
@pytest.mark.parametrize("key", ["seq", "dp", "tp"])
def test_bytes_cover_inputs_and_output(name, key):
    app = APPS[name]()
    state = app.make_inputs(0, small=True, device="cpu")
    fn = app.build({n.name: key for n in app.nests})
    analysis = trace(fn, state).analyze()
    out = fn(state)
    io = sum(t.numel() * t.element_size() for t in state.values()) + \
        out.numel() * out.element_size()
    assert analysis["bytes"] >= io
    assert analysis["flops"] > 0
    assert analysis["collective_bytes"] == 0.0


def test_views_are_free_and_each_op_boundary_counts():
    def fn(state):
        x, = state
        y = x.reshape(-1)[:8].t()        # views: no bytes, no FLOPs
        z = x + 1.0                      # read x, write z
        z.mul_(2.0)                      # read z, write z
        return z.sum() + y.sum()

    art = trace(fn, (TensorSpec((16, 4), device="cpu"),))
    by_name = {}
    for op in art.ops:
        by_name.setdefault(op.name, []).append(op)
    for view in ("aten.t.default", "aten.view.default", "aten.slice.Tensor"):
        assert all(op.bytes == 0 and op.flops == 0 for op in by_name[view])
    assert by_name["aten.add.Tensor"][0].bytes == 2 * 64 * 4
    assert by_name["aten.mul_.Tensor"][0].bytes == 2 * 64 * 4
    assert by_name["aten.sum.default"][0].flops == 64
    assert "aten.mm" not in art.as_text()


def test_spec_and_tensor_inputs_give_one_analysis():
    app = APPS["tdFIR"]()
    state = app.make_inputs(0, small=True, device="cpu")
    fn = app.build({"tdfir_filter_bank": "dp", "scale_output": "dp"})
    from_tensors = trace(fn, state).analyze()
    from_specs = trace(fn, {k: spec_of(v) for k, v in state.items()}
                       ).analyze()
    assert from_tensors == from_specs


def test_inputs_on_two_devices_are_refused():
    with pytest.raises(ValueError, match="span devices"):
        trace(lambda s: s[0] + s[1], (TensorSpec((4,), device="cpu"),
                                      TensorSpec((4,), device="meta")))


def test_collectives_are_counted_under_the_reference_keys():
    """A fake two-rank process group: CommDebugMode counts the collectives,
    the recorder charges their operand bytes (the reference's rule)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        def fn(state):
            x, = state
            y = funcol.all_reduce(x * 2.0, "sum", dist.group.WORLD)
            gather = getattr(funcol, "all_gather_single",
                             funcol.all_gather_tensor)
            return gather(y, 0, dist.group.WORLD).sum()

        got = trace(fn, (TensorSpec((64, 32), device="cpu"),)).analyze()
    finally:
        dist.destroy_process_group()
    assert got["count_all-reduce"] == 1 and got["count_all-gather"] == 1
    assert got["coll_all-reduce"] == 64 * 32 * 4
    assert got["coll_all-gather"] == 64 * 32 * 4
    assert got["collective_bytes"] == 2 * 64 * 32 * 4
    assert set(got) >= {f"{p}_{k}" for p in ("coll", "count")
                        for k in jax_cm.COLLECTIVE_OPS}


# ------------------------------------------------- the kernels' fake calls
def _kernel_case(kernel):
    f, n, k = 8, 256, 16
    if kernel == "matmul":
        shapes = ((64, 96), (96, 32))
        want = mm.work(64, 32, 96)
        return (lambda s: ops.matmul(*s)), shapes, want, [(64, 32)]
    if kernel == "tdfir":
        return ((lambda s: ops.tdfir(*s)), ((f, n), (f, k)),
                fir.work(f, n, k), [(f, n)])
    return ((lambda s: ops.tdfir_complex(*s)),
            ((f, n), (f, n), (f, k), (f, k)), fir.complex_work(f, n, k),
            [(f, n), (f, n)])


@pytest.mark.parametrize("kernel", ["matmul", "tdfir", "tdfir_complex"])
def test_fake_kernel_call_counts_its_formula(kernel):
    fn, shapes, (flops, nbytes), out_shapes = _kernel_case(kernel)
    ops.reset_launch_counts()
    results = []

    def keep(state):
        out = fn(state)
        results.extend(out if isinstance(out, tuple) else (out,))
        return out

    art = trace(keep, tuple(TensorSpec(s, device="cpu") for s in shapes))
    kernels = [op for op in art.ops if op.name.startswith("kernel.")]
    assert [op.name for op in kernels] == [f"kernel.{kernel}"]
    assert kernels[0].flops == flops and kernels[0].bytes == nbytes
    analysis = art.analyze()
    # nothing else did work: the plain version (float64 sums) never ran
    assert analysis["flops"] == flops and analysis["bytes"] == nbytes
    assert analysis["flops_fp64"] == 0.0
    assert [tuple(r.shape) for r in results] == out_shapes
    assert all(r.dtype == torch.float32 for r in results)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("kernel", ["matmul", "tdfir", "tdfir_complex"])
def test_a_real_first_operand_beside_a_fake_one_is_not_run(kernel):
    """A trace may close over a real tensor: any fake operand takes the
    fake path, so neither the kernel nor its plain version runs."""
    fn, shapes, (flops, nbytes), out_shapes = _kernel_case(kernel)
    real = torch.zeros(shapes[0])
    ops.reset_launch_counts()
    art = trace(lambda s: fn((real,) + tuple(s)),
                tuple(TensorSpec(s, device="cpu") for s in shapes[1:]))
    kernels = [op for op in art.ops if op.name.startswith("kernel.")]
    assert [op.name for op in kernels] == [f"kernel.{kernel}"]
    assert kernels[0].flops == flops and kernels[0].bytes == nbytes
    assert all(op.flops == op.bytes == 0 for op in art.ops
               if op not in kernels)
    assert set(ops.launch_counts().values()) == {0}


def test_kernel_formulas_are_the_bounds():
    assert mm.work(512, 512, 512) == (2.0 * 512 ** 3, 4.0 * 3 * 512 ** 2)
    assert fir.work(64, 4096, 128) == (2.0 * 64 * 4096 * 128,
                                       4.0 * (2 * 64 * 4096 + 64 * 128))
    flops, nbytes = fir.complex_work(64, 4096, 128)
    assert flops == 4 * 2.0 * 64 * 4096 * 128 + 2.0 * 64 * 4096
    assert nbytes == 4.0 * (4 * 64 * 4096 + 2 * 64 * 128)


def test_pinned_kernel_nest_is_analysed_by_its_formula():
    """The residual rule can pin the FPGA analogue's tdFIR bank into a dp
    winner: its analysis holds the kernel's work, and nothing launches."""
    app = APPS["tdFIR"]()
    state = app.make_inputs(0, small=True, device="cpu")
    ops.reset_launch_counts()
    ev = CompiledCostRunner(mesh=LocalMesh()).measure(
        app.build({"tdfir_filter_bank": "pallas", "scale_output": "dp"}),
        state)
    assert ev.correct and ev.time_s > 0
    f, n = state["x_re"].shape
    k = state["h_re"].shape[1]
    assert ev.info["roofline"]["flops_per_device"] >= \
        fir.complex_work(f, n, k)[0]
    assert set(ops.launch_counts().values()) == {0}


def test_a_failing_trace_is_an_incorrect_evaluation():
    ev = CompiledCostRunner().measure(lambda s: float(s[0].sum()),
                                      (TensorSpec((4,), device="cpu"),))
    assert not ev.correct and ev.time_s == float("inf")
    assert "error" in ev.info


# -------------------------------------------------------------- cost model
@pytest.mark.parametrize("schedule", ["gpipe", "one_f_one_b", "interleaved",
                                      "not-a-schedule"])
def test_pipeline_terms_equal_jax(schedule):
    for ranks in (1, 2, 4, 8):
        for m in (0, 1, 2, 4, 8, 16):
            for v in (1, 2, 4):
                args = (schedule, ranks, m, v)
                assert cost_model.pipeline_bubble_fraction(*args) == \
                    jax_cm.pipeline_bubble_fraction(*args)
                assert cost_model.pipeline_in_flight(*args) == \
                    jax_cm.pipeline_in_flight(*args)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_jax(arch):
    for shape in SHAPES:
        assert cost_model.model_flops_for(ARCHS[arch], SHAPES[shape]) == \
            jax_cm.model_flops_for(JAX_ARCHS[arch], JAX_SHAPES[shape])


@pytest.mark.parametrize("terms", [(1e12, 1e9, 1e6, 256, 2e14, 0.0),
                                   (1e9, 1e11, 1e6, 1, 0.0, 0.3),
                                   (1e9, 1e6, 5e10, 8, 1e9, 0.5)])
def test_roofline_keeps_the_reference_arithmetic(terms):
    flops, nbytes, coll, chips, model, bubble = terms
    rl = cost_model.roofline_terms(flops, nbytes, coll, n_chips=chips,
                                   model_flops=model, bubble_fraction=bubble)
    assert rl.compute_s == pytest.approx(flops / cost_model.PEAK_FLOPS)
    assert rl.memory_s == pytest.approx(nbytes / cost_model.HBM_BW)
    assert rl.collective_s == pytest.approx(coll / cost_model.LINK_BW)
    terms_s = {"compute": rl.compute_s, "memory": rl.memory_s,
               "collective": rl.collective_s}
    assert rl.dominant == max(terms_s, key=terms_s.get)
    busy = max(terms_s.values())
    assert rl.step_time_s == pytest.approx(busy / (1 - bubble))
    assert rl.pipeline_s == pytest.approx(rl.step_time_s - busy)
    assert rl.useful_flops_ratio == pytest.approx(model / (flops * chips))
    useful_s = (model / chips) / cost_model.PEAK_FLOPS
    assert rl.roofline_fraction == pytest.approx(useful_s / rl.step_time_s)


def test_each_dtype_is_priced_at_its_own_peak():
    assert cost_model.PEAK_FLOPS_BY_DTYPE["fp32"] == 67e12
    assert cost_model.PEAK_FLOPS_BY_DTYPE["bf16"] == 989e12
    assert (cost_model.HBM_BW, cost_model.LINK_BW) == (3.35e12, 450e9)
    split = cost_model.roofline_terms(
        3e12, 0.0, 0.0, n_chips=1,
        flops_by_dtype={"fp32": 1e12, "bf16": 2e12})
    assert split.compute_s == pytest.approx(1e12 / 67e12 + 2e12 / 989e12)
    # an analysis without the split is priced at the fp32 peak
    plain = cost_model.roofline_from_analysis(
        {"flops": 3e12, "bytes": 0.0, "collective_bytes": 0.0}, n_chips=1)
    assert plain.compute_s == pytest.approx(3e12 / 67e12)
    with pytest.raises(ValueError):
        cost_model.compute_seconds(1.0, {"tf32": 1.0})


def test_bf16_products_run_at_the_tensor_core_peak():
    art = trace(lambda ab: ab[0] @ ab[1],
                (TensorSpec((256, 256), torch.bfloat16, "cpu"),
                 TensorSpec((256, 256), torch.bfloat16, "cpu")))
    analysis = art.analyze()
    assert analysis["flops_bf16"] == 2.0 * 256 ** 3
    rl = cost_model.roofline_from_analysis(analysis, n_chips=1)
    assert rl.compute_s == pytest.approx(2.0 * 256 ** 3 / 989e12)


# -------------------------------------------------------------- publishing
def _records(record_cls, roofline_terms, backends):
    """Scripted records, one per (backend, method) of the paper's order:
    a roofline record, a host-time record, a failure on a key with no
    success, a failure after a success, and an unusable infinite time."""
    dp, tp, fpga = backends
    rl = roofline_terms(2e9, 3e8, 0.0, n_chips=1).to_dict()

    def rec(dest, method, t, correct, mesh):
        return dest, record_cls(
            order=1, destination=dest.name,
            paper_analogue=dest.paper_analogue, method=method,
            best_time_s=t, improvement=1.0, price=dest.price,
            n_measurements=1, verify_elapsed_s=0.25, met_target=False,
            correct=correct, note="" if correct else "wrong result",
            mesh_info={"roofline": rl} if mesh else {})

    return [rec(dp, "function_block", 0.002, True, True),
            rec(tp, "function_block", 0.003, True, False),
            rec(fpga, "function_block", 1000.0, False, False),
            rec(dp, "loop", 1000.0, False, False),
            rec(tp, "loop", float("inf"), True, False)]


def test_publish_registers_what_the_jax_package_registers():
    mine, theirs = pl.PlanLookup(), jax_pl.PlanLookup()
    port_backends = (MANY_CORE, GPU, FPGA)
    jax_backends = tuple(JAX_REGISTRY.get(b.key) for b in port_backends)
    got = [pl.publish_record(mine, r, b, "3mm") for b, r in _records(
        VerificationRecord, cost_model.roofline_terms, port_backends)]
    want = [jax_pl.publish_record(theirs, r, b, "3mm") for b, r in _records(
        JaxRecord, jax_cm.roofline_terms, jax_backends)]
    assert got == want == [True, True, True, False, False]
    assert set(mine.cache._entries) == set(theirs.cache._entries)
    assert set(mine.cache._failed) == set(theirs.cache._failed)
    for h, payload in mine.cache._entries.items():
        ref = theirs.cache._entries[h]
        assert payload["extra"] == ref["extra"]
        assert payload["compile_s"] == ref["compile_s"]
        if payload["extra"]["source"] == "roofline":
            for k in ("flops", "bytes", "collective_bytes"):
                assert payload["analysis"][k] == ref["analysis"][k]
    # the host-time fallback gives back the measured time exactly
    key = pl.serve_key(GPU.name, "3mm")
    assert mine.score(key).time_s == pytest.approx(0.003, rel=1e-12)
    assert mine.score(pl.serve_key(FPGA.name, "3mm")) is None
    # a mesh-verified record's published analysis reproduces its roofline
    dp_key = pl.serve_key(MANY_CORE.name, "3mm")
    assert mine.score(dp_key).time_s == pytest.approx(
        cost_model.roofline_terms(2e9, 3e8, 0.0, n_chips=1).step_time_s)


def test_analysis_from_roofline_keeps_the_dtype_split():
    rl = cost_model.roofline_terms(3e12, 1e9, 0.0, n_chips=1,
                                   flops_by_dtype={"bf16": 3e12})
    analysis = pl.analysis_from_roofline(rl.to_dict())
    assert analysis["flops_bf16"] == 3e12
    again = cost_model.roofline_from_analysis(analysis, n_chips=1)
    assert again.step_time_s == pytest.approx(rl.step_time_s)


# ------------------------------------------- tests/test_dist.py: the bridge
def test_bridge_mesh_verify_dp_tp_only():
    app = APPS["tdFIR"]()
    inputs = app.make_inputs(seed=0, small=True, device="cpu")
    runner = CompiledCostRunner(LocalMesh())
    fn = app.build({})
    ev_dp = bridge.mesh_verify(runner, MANY_CORE, fn, inputs)
    ev_tp = bridge.mesh_verify(runner, GPU, fn, inputs)
    assert ev_dp is not None and ev_dp.correct and ev_dp.time_s > 0
    assert ev_tp is not None and ev_tp.correct and ev_tp.time_s > 0
    assert "roofline" in ev_dp.info
    assert ev_dp.info["mesh"] == {"data": 1, "model": 1}
    assert ev_dp.info["input_axes"]["x_re"] == ("batch", None)
    assert ev_tp.info["input_axes"]["x_re"] == (None, "ff")
    # the FPGA analogue is a kernel substitution, not a sharding
    assert bridge.mesh_verify(runner, FPGA, fn, inputs) is None
    assert bridge.mesh_verify(None, MANY_CORE, fn, inputs) is None
    assert bridge.mesh_verify(CompiledCostRunner(), MANY_CORE, fn,
                              inputs) is None
    # the default hook of the built-in backends is the bridge
    assert MANY_CORE.mesh_verify(runner, fn, inputs).time_s == ev_dp.time_s


def test_planner_records_mesh_time():
    app = APPS["tdFIR"]()
    report = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0),
        cost_runner=CompiledCostRunner(LocalMesh()), device="cpu")
    assert len(report.records) == 6
    by_method = {(r.paper_analogue, r.method): r for r in report.records}
    for analogue in ("many-core CPU", "GPU"):
        rec = by_method[(analogue, "loop")]
        assert rec.mesh_time_s is not None and rec.mesh_time_s > 0
        assert "roofline" in rec.mesh_info
        assert rec.energy_info["source"] == "roofline"
    # FPGA verifications carry no mesh analogue
    assert by_method[("FPGA", "loop")].mesh_time_s is None
    assert by_method[("FPGA", "loop")].energy_info["source"] == "host-time"


# ------------------------------- tests/test_backends.py: the modeled policy
class ScriptedRunner:
    """Deterministic verification environment: the app encodes its own
    "processing time" in the output scalar."""

    def measure(self, fn, inputs, reference_out):
        out = fn(inputs)
        return Evaluation(time_s=float(out), correct=True,
                          info={"output": out})


def _stage(value):
    def impl(state):
        s = dict(state)
        s["out"] = torch.tensor(value, dtype=torch.float32)
        return s
    return impl


def _scripted_app(times):
    nest = LoopNest(name="stage",
                    impls={k: _stage(v) for k, v in times.items()})
    return OffloadableApp(
        name="scripted", nests=[nest],
        make_inputs=lambda seed=0, small=False, device=None:
        {"x": torch.ones(4)})


class FakeCostRunner:
    """Scripted mesh verification: modeled time (or a Roofline) per
    backend key."""

    def __init__(self, mesh_times):
        self.mesh_times = mesh_times


def _fake_mesh_verify(backend, cost_runner, fn, inputs):
    t = cost_runner.mesh_times.get(backend.key)
    if t is None:
        return None
    if isinstance(t, cost_model.Roofline):
        return Evaluation(time_s=t.step_time_s, correct=True,
                          info={"roofline": t.to_dict()})
    return Evaluation(time_s=t, correct=True, info={"scripted": True})


def _dp_tp_registry():
    dp = Backend(key="dp", name="xla_dp", paper_analogue="many-core CPU",
                 price=1.2, verify_time=1.0, mesh_role="data",
                 power=MANY_CORE_XEON, search_fn=ga_loop_search,
                 mesh_verify_fn=_fake_mesh_verify)
    tp = Backend(key="tp", name="sharded_tp", paper_analogue="GPU",
                 price=1.0, verify_time=1.5, mesh_role="model",
                 power=GPU_T4, search_fn=ga_loop_search,
                 mesh_verify_fn=_fake_mesh_verify)
    return BackendRegistry([dp, tp])


def _plan(app, policy, cost_runner):
    return plan_offload(app, UserTarget(), runner=ScriptedRunner(),
                        ga_cfg=GAConfig(population=2, generations=2),
                        registry=Registry(), backends=_dp_tp_registry(),
                        cost_runner=cost_runner, policy=policy,
                        device="cpu")


def test_modeled_policy_flips_selection_on_comm_bound_candidate():
    """With a cost_runner recording mesh times, policy="modeled" selects by
    mesh_time_s — the host-fastest tp candidate is comm-bound on the mesh,
    so modeled selection flips to dp; host-time keeps tp."""
    app = _scripted_app({"seq": 1.0, "dp": 0.8, "tp": 0.5})
    cost_runner = FakeCostRunner({"dp": 0.1, "tp": 2.0})

    host = _plan(app, "host-time", cost_runner)
    assert host.policy == "host-time"
    assert host.selected.destination == "sharded_tp"
    assert host.selected.best_time_s == pytest.approx(0.5)

    modeled = _plan(app, "modeled", cost_runner)
    assert modeled.policy == "modeled"
    assert modeled.selected.destination == "xla_dp"
    assert modeled.selected.mesh_time_s == pytest.approx(0.1)
    tp_rec = next(r for r in modeled.records
                  if r.destination == "sharded_tp" and r.method == "loop")
    assert tp_rec.mesh_time_s == pytest.approx(2.0)


def test_summary_rows_include_mesh_time_and_correct():
    app = _scripted_app({"seq": 1.0, "dp": 0.8, "tp": 0.5})
    report = _plan(app, None, FakeCostRunner({"dp": 0.1, "tp": 2.0}))
    rows = report.summary_rows()
    assert all("mesh_time_s" in row and "correct" in row for row in rows)
    by_dest = {(row["destination"], row["method"]): row for row in rows}
    assert by_dest[("many-core CPU", "loop")]["mesh_time_s"] == \
        pytest.approx(0.1)
    assert by_dest[("GPU", "loop")]["mesh_time_s"] == pytest.approx(2.0)
    assert all(row["correct"] for row in rows
               if row["time_s"] < float("inf"))


# ---------------------------- tests/test_candidates.py: the constructors
def test_from_analysis_is_score_analysis_then_the_envelope_charge():
    analysis = {"flops": 1e9, "bytes": 1e6, "collective_bytes": 0.0}
    scale = 4 + 8 / 8.0                              # max_gen=4, prompt=8
    c = Candidate.from_analysis(analysis, backend=GPU, n_chips=1,
                                scale=scale)
    ev = CompiledCostRunner(n_chips=1).score_analysis(dict(analysis),
                                                      cache_hit=True)
    service = ev.time_s * scale
    assert c.best_time_s == pytest.approx(service)
    assert c.mesh_time_s == pytest.approx(service)
    assert c.price == GPU.price and c.backend == GPU.name
    rep = EnergyModel(GPU_T4).from_roofline(ev.info["roofline"])
    assert c.avg_watts == pytest.approx(rep.avg_watts)
    assert c.energy_j == pytest.approx(rep.avg_watts * service)
    # an explicit price overrides the backend's
    priced = Candidate.from_analysis(analysis, backend=GPU, price=9.0)
    assert priced.price == 9.0
    assert Candidate.from_analysis({"flops": 1.0}, backend=GPU) is None


def test_from_cell_ranks_like_a_charged_cell():
    energy = {"energy_j": 12.0, "avg_watts": 60.0, "edp": 12.0 * 0.2}
    c = Candidate.from_cell(0.2, n_chips=8.0, energy=energy)
    assert get_policy("host-time").score_candidate(c) == pytest.approx(0.2)
    assert get_policy("price-weighted").score_candidate(c) \
        == pytest.approx(0.2 * 8.0)
    assert get_policy("power").score_candidate(c) == pytest.approx(12.0)
    assert get_policy("edp").score_candidate(c) \
        == pytest.approx(energy["edp"])
    # an uncharged cell takes the joule-scale fallback
    bare = Candidate.from_cell(0.2, n_chips=8.0)
    assert bare.energy_j is None
    assert get_policy("power").score_candidate(bare) \
        == pytest.approx(GENERIC.peak_w * 0.2)


def test_from_roofline_charges_the_h100_cell():
    rl = {"step_time_s": 0.01, "compute_util": 0.5, "memory_util": 0.2,
          "collective_util": 0.0, "bytes_per_device": 1e6}
    c = Candidate.from_roofline(rl, n_chips=8, price=1.5, time_s=0.01)
    rep = cell_energy(rl, 8)
    assert rep.envelope == f"{H100_SXM.name}x8"
    assert rep.avg_watts == pytest.approx(
        8 * (H100_SXM.idle_w + H100_SXM.active_w * (0.7 * 0.5 + 0.3 * 0.2)))
    assert c.energy_j == pytest.approx(rep.energy_j)
    assert c.avg_watts == pytest.approx(rep.avg_watts)
    assert get_policy("power").score_candidate(c) \
        == pytest.approx(rep.energy_j)
    assert get_policy("edp").score_candidate(c) \
        == pytest.approx(rep.energy_j * 0.01)
    assert get_policy("price-weighted").score_candidate(c) \
        == pytest.approx(0.01 * 1.5)


def test_h100_envelope_is_the_card_limit_and_its_idle_draw():
    assert H100_SXM.peak_w == 700.0
    assert 0 < H100_SXM.idle_w < H100_SXM.peak_w
    assert H100_SXM.memory_w_fraction == 0.30
    # the paper's destinations keep their calibration
    assert MANY_CORE.power is MANY_CORE_XEON and GPU.power is GPU_T4
    assert [b.mesh_role for b, m in DEFAULT_REGISTRY.verification_order()
            if m == "loop"] == ["data", "model", ""]


# ------------------------------------ tests/test_power.py: roofline cases
def test_roofline_carries_utilization_terms():
    rl = cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4)
    step = rl.step_time_s
    assert rl.compute_util == pytest.approx(rl.compute_s / step)
    assert rl.memory_util == pytest.approx(rl.memory_s / step)
    assert rl.collective_util == pytest.approx(rl.collective_s / step)
    assert max(rl.compute_util, rl.memory_util,
               rl.collective_util) == pytest.approx(1.0)
    rb = cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4,
                                   bubble_fraction=0.5)
    assert rb.memory_util == pytest.approx(rl.memory_util * 0.5)


def test_energy_monotone_in_bubble_fraction():
    model = EnergyModel(GPU_T4)
    energies = []
    for bubble in (0.0, 0.2, 0.4, 0.6):
        rl = cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4,
                                       bubble_fraction=bubble)
        energies.append(model.from_roofline(rl).energy_j)
    assert energies == sorted(energies)
    assert energies[0] < energies[-1]
    w0 = model.from_roofline(
        cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4)).avg_watts
    w6 = model.from_roofline(
        cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4,
                                  bubble_fraction=0.6)).avg_watts
    assert w6 < w0


def test_collective_term_is_charged_at_the_memory_fraction():
    model = EnergyModel(GPU_T4)
    w = model.watts(0.2, 0.1, 0.5)
    assert w == pytest.approx(GPU_T4.idle_w + GPU_T4.active_w * (
        0.75 * 0.2 + 0.25 * (0.1 + 0.5)))
    assert model.watts(0.2, 0.1) < w


def test_host_time_fallback_charges_peak_watts():
    model = EnergyModel(GPU_T4)
    rep = model.from_time(0.5)
    assert rep.source == "host-time"
    assert rep.avg_watts == pytest.approx(GPU_T4.peak_w)
    assert rep.energy_j == pytest.approx(GPU_T4.peak_w * 0.5)
    assert rep.edp == pytest.approx(rep.energy_j * 0.5)
    assert rep.perf_per_watt == pytest.approx(1.0 / rep.energy_j)
    assert model.from_time(float("inf")) is None
    assert model.from_time(0.0) is None


def test_energy_for_record_prefers_roofline_over_host_time():
    rl = cost_model.roofline_terms(1e12, 1e11, 1e9, n_chips=4)
    rec = VerificationRecord(
        order=1, destination="x", paper_analogue="GPU", method="loop",
        best_time_s=0.5, improvement=2.0, price=1.0, n_measurements=1,
        verify_elapsed_s=0.0, met_target=False,
        mesh_info={"roofline": rl.to_dict()})
    rep = energy_for_record(rec, GPU_T4)
    assert rep.source == "roofline"
    assert rep.step_time_s == pytest.approx(rl.step_time_s)
    rec.mesh_info = {}
    assert energy_for_record(rec, GPU_T4).source == "host-time"
    rec.correct = False
    assert energy_for_record(rec, GPU_T4) is None


def _comm_bound_setup():
    """tp wins on the host but is comm-bound on the mesh; dp is a lean
    compute-bound candidate (collective bytes sized for NVLink's rate)."""
    app = _scripted_app({"seq": 1.0, "dp": 0.8, "tp": 0.5})
    rl_dp = cost_model.roofline_terms(2e13, 1e10, 1e8, n_chips=4)
    rl_tp = cost_model.roofline_terms(2e13, 1e11, 5e11, n_chips=4)
    assert rl_tp.dominant == "collective" and rl_dp.dominant == "compute"
    return app, FakeCostRunner({"dp": rl_dp, "tp": rl_tp}), rl_dp, rl_tp


def test_power_policy_flips_comm_bound_winner():
    app, cost_runner, rl_dp, rl_tp = _comm_bound_setup()
    host = _plan(app, "host-time", cost_runner)
    assert host.selected.destination == "sharded_tp"

    power = _plan(app, "power", cost_runner)
    assert power.policy == "power"
    assert power.selected.destination == "xla_dp"
    dp_rec = next(r for r in power.records
                  if r.destination == "xla_dp" and r.method == "loop")
    tp_rec = next(r for r in power.records
                  if r.destination == "sharded_tp" and r.method == "loop")
    assert dp_rec.energy_j == pytest.approx(
        EnergyModel(MANY_CORE_XEON).from_roofline(rl_dp).energy_j)
    assert tp_rec.energy_j == pytest.approx(
        EnergyModel(GPU_T4).from_roofline(rl_tp).energy_j)
    assert dp_rec.energy_j < tp_rec.energy_j
    assert dp_rec.energy_info["source"] == "roofline"
    # price x time would have kept tp (0.5 x 1.0 < 0.8 x 1.2)
    assert tp_rec.best_time_s * tp_rec.price < \
        dp_rec.best_time_s * dp_rec.price
    sel_row = next(row for row in power.summary_rows() if row["selected"])
    assert sel_row["energy_j"] is not None
    assert sel_row["avg_watts"] is not None


def test_edp_policy_ranks_energy_delay_product():
    app, cost_runner, _, _ = _comm_bound_setup()
    report = _plan(app, "edp", cost_runner)
    assert report.policy == "edp"
    assert report.selected.destination == "xla_dp"


# --------------------------- tests/test_system.py: the end-to-end margin
@pytest.mark.parametrize("name", APP_NAMES)
def test_selected_pattern_modeled_no_slower_than_reference(name):
    """Each app gets a correct destination, and the selected pattern's
    roofline is no slower than 1.5x the single-core reference's."""
    cost = CompiledCostRunner()
    app = APPS[name]()
    inputs = app.make_inputs(0, small=True, device="cpu")
    report = plan_offload(
        app, UserTarget(), inputs=inputs, runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0), device="cpu")
    assert report.selected is not None and report.selected.correct
    assert len(report.records) == 6
    specs = {k: spec_of(v) for k, v in inputs.items()}
    ref_ev = cost.measure(app.reference_fn(), specs)
    sel_ev = cost.measure(app.build(dict(report.selected.choice)), specs)
    assert ref_ev.correct and sel_ev.correct
    assert sel_ev.time_s <= ref_ev.time_s * 1.5, \
        (sel_ev.time_s, ref_ev.time_s)
    assert math.isfinite(sel_ev.time_s) and np.isfinite(ref_ev.time_s)
