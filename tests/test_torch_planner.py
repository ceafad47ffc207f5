"""The port's planner against a JAX run of the same, per app at small size
on the CPU: the paper's protocol (verification order, correctness verdicts,
function-block matches, residual rule, <= 4 FPGA measurements, the 1000 s
penalty, the wrong smoother never selected).  Winners may differ: they
depend on timing."""
import re

import pytest

from repro.apps import APPS as JAX_APPS
from repro.core.ga import GAConfig as JaxGAConfig
from repro.core.measure import TimedRunner as JaxTimedRunner
from repro.core.planner import UserTarget as JaxUserTarget
from repro.core.planner import plan_offload as jax_plan_offload
from repro_torch.apps import APPS
from repro_torch.backends import DEFAULT_REGISTRY
from repro_torch.core import ga
from repro_torch.core.ga import GAConfig
from repro_torch.core.measure import CompiledCostRunner, TimedRunner
from repro_torch.core.plan_lookup import PlanLookup, serve_key
from repro_torch.core.planner import UserTarget, plan_offload
from repro_torch.dist.bridge import LocalMesh
from repro_torch.obs import Tracer, use_tracer

APP_NAMES = ("3mm", "NAS.BT", "tdFIR")


def _port_report(name, **kw):
    app = APPS[name]()
    return plan_offload(
        app, UserTarget(**kw),
        inputs=app.make_inputs(0, small=True, device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0), device="cpu")


@pytest.fixture(scope="module")
def reports():
    out = {}
    for name in APP_NAMES:
        app = JAX_APPS[name]()
        jax_report = jax_plan_offload(
            app, JaxUserTarget(), inputs=app.make_inputs(0, small=True),
            runner=JaxTimedRunner(repeats=1),
            ga_cfg=JaxGAConfig(population=3, generations=3, seed=0))
        out[name] = (jax_report, _port_report(name))
    return out


def _fb_note_kind(note):
    """(entry, nest, method) of each function-block match in a note."""
    return re.findall(r"(\w+)@(\w+)\((\w+):", note)


@pytest.mark.parametrize("name", APP_NAMES)
def test_protocol_matches_jax(reports, name):
    jax_report, report = reports[name]
    assert len(report.records) == 6 and not report.early_stopped
    assert ([(r.paper_analogue, r.method) for r in report.records]
            == [(r.paper_analogue, r.method) for r in jax_report.records]
            == [(b.paper_analogue, m)
                for b, m in DEFAULT_REGISTRY.verification_order()])
    assert ([r.correct for r in report.records]
            == [r.correct for r in jax_report.records])
    for got, want in zip(report.records, jax_report.records):
        if got.method == "function_block":
            assert _fb_note_kind(got.note) == _fb_note_kind(want.note)
            assert (got.best_time_s == float("inf")) == \
                (want.best_time_s == float("inf"))
    assert report.selected is not None and report.selected.correct


@pytest.mark.parametrize("name", APP_NAMES)
def test_residual_rule_and_fpga_budget(reports, name):
    _, report = reports[name]
    fb = [r for r in report.records if r.method == "function_block"
          and r.correct and r.best_time_s < float("inf")]
    loops = [r for r in report.records if r.method == "loop"]
    if fb:
        best_fb = min(fb, key=lambda r: r.best_time_s)
        if best_fb.best_time_s < report.ref_time_s:
            for r in loops:
                for nest, impl in best_fb.choice.items():
                    assert r.choice.get(nest) == impl
    fpga = [r for r in loops if r.paper_analogue == "FPGA"]
    assert len(fpga) == 1 and fpga[0].n_measurements <= 4


def test_smoother_never_selected_on_dp_tp(reports):
    _, report = reports["NAS.BT"]
    for r in report.records:
        if r.correct and r.method == "loop":
            assert r.choice.get("seidel_relax", "seq") not in ("dp", "tp")
    assert report.selected.choice.get("seidel_relax", "seq") == "seq"


def test_wrong_result_costs_the_penalty():
    """A wrong pattern is charged the paper's 1000 s: the smoother on dp
    measures incorrect and its effective time is the penalty."""
    assert ga.PENALTY_TIME_S == 1000.0
    assert GAConfig(population=3, generations=3).penalty_s == 1000.0
    app = APPS["NAS.BT"]()
    state = app.make_inputs(0, small=True, device="cpu")
    runner = TimedRunner(repeats=1)
    ref = runner.measure(app.reference_fn(), state, None).info["output"]
    ev = runner.measure(app.build({"seidel_relax": "dp"}), state, ref)
    assert not ev.correct and ev.effective_time == 1000.0
    ok = runner.measure(app.build({"add_update": "dp"}), state, ref)
    assert ok.correct and ok.effective_time < 1000.0


def test_early_stop_on_met_target():
    report = _port_report("tdFIR", target_speedup=0.1)
    assert report.early_stopped and len(report.records) < 6


@pytest.mark.parametrize("kw", [{"lint_choice": lambda c: []}])
def test_later_slice_arguments_raise(kw, reports):
    """The arguments a later slice brought no longer raise: a lint that
    rejects nothing leaves 3mm's verdicts and measurement counts as the
    unlinted run's."""
    app = APPS["3mm"]()
    linted = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0), device="cpu",
        **kw)
    _, plain = reports["3mm"]
    assert [(r.destination, r.method, r.correct) for r in linted.records] == \
        [(r.destination, r.method, r.correct) for r in plain.records]
    fpga = [r for r in linted.records if r.paper_analogue == "FPGA"
            and r.method == "loop"]
    assert fpga and fpga[0].n_measurements <= 4


def test_cost_runner_records_modeled_times_on_the_cpu():
    """``cost_runner=`` traces every correct dp / tp winner on the CPU's
    fake tensors and records its roofline; the FPGA analogue has none, and
    the modeled policy selects a correct record."""
    app = APPS["3mm"]()
    report = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0),
        cost_runner=CompiledCostRunner(mesh=LocalMesh()), policy="modeled",
        device="cpu")
    assert len(report.records) == 6
    for r in report.records:
        usable = r.correct and r.best_time_s < float("inf")
        if usable and r.paper_analogue in ("many-core CPU", "GPU"):
            assert r.mesh_time_s > 0 and "roofline" in r.mesh_info
        else:
            assert r.mesh_time_s is None and not r.mesh_info
    assert report.selected is not None and report.selected.correct


def test_publish_warms_the_lookup_on_the_cpu():
    """``publish=`` registers each destination's verdict: a warm key for a
    destination with a correct record, a failure for one with none."""
    app = APPS["NAS.BT"]()
    lookup = PlanLookup()
    report = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0),
        publish=lookup, device="cpu")
    for backend, _ in DEFAULT_REGISTRY.verification_order():
        recs = [r for r in report.records if r.destination == backend.name]
        payload = lookup.lookup(serve_key(backend.name, app.name))
        if any(r.correct and r.best_time_s < float("inf") for r in recs):
            assert lookup.usable(payload)
            assert payload["extra"]["source"] == "host-time"
        elif any(not r.correct for r in recs):
            assert "error" in payload
    assert lookup.stats.misses > 0


def test_planner_records_the_jax_span_names():
    tracer = Tracer()
    with use_tracer(tracer):
        _port_report("tdFIR")
    kinds = {(r["cat"], r["name"]) for r in tracer.records}
    assert kinds == {("plan", "offload"), ("plan", "verify"),
                     ("ga", "generation")}
    verifies = [r["attrs"] for r in tracer.records if r["name"] == "verify"]
    assert [(a["backend"], a["method"]) for a in verifies] == [
        (b.name, m) for b, m in DEFAULT_REGISTRY.verification_order()]
