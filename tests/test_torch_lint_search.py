"""Prune before trace and before measurement, in the port, against the JAX
package: the linted batch evaluator (``make_cached_batch_evaluator(lint=,
workers=, from_genes=)``, ``tests/test_analysis.py``'s GA cases on the
port's counting traceable), the loop GA and the FPGA search under
``lint_choice`` (a pruned choice is never measured), and ``plan_offload(
lint_choice=)`` on the small 3mm, tdFIR and NAS.BT giving the reference's
verdicts under the same lint."""
import threading

import pytest
import torch
import torch.distributed as dist

from repro.analysis import Finding as JaxFinding
from repro.analysis import lint_plan as jax_lint_plan
from repro.apps import APPS as JAX_APPS
from repro.configs.base import ShapeConfig as JaxShape
from repro.core.ga import GAConfig as JaxGAConfig
from repro.core.measure import TimedRunner as JaxTimedRunner
from repro.core.planner import UserTarget as JaxUserTarget
from repro.core.planner import plan_offload as jax_plan_offload
from repro.dist.plan import Plan as JaxPlan
from repro_torch.analysis import Finding, has_errors, lint_plan
from repro_torch.apps import APPS
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import search_cache as sc
from repro_torch.core import trace_analysis
from repro_torch.core.ga import Evaluation, GAConfig, run_ga
from repro_torch.core.measure import CompiledCostRunner, TimedRunner
from repro_torch.core.planner import UserTarget, plan_offload
from repro_torch.core.trace_analysis import TensorSpec, trace
from repro_torch.dist.plan import Plan
from test_torch_search_cache import (CountingTraceable, genes_with,
                                     make_evaluator)

# batch 6: microbatches 4 and 8 are infeasible (6 % 4, 6 % 8), 1 and 2 fine
SHAPE_B6 = ShapeConfig("b6", seq_len=32, global_batch=6, kind="train")
SHAPE_B8 = ShapeConfig("b8", seq_len=32, global_batch=8, kind="train")


def lint_for(shape):
    return lambda plan: lint_plan(plan, shape=shape)


@pytest.mark.parametrize("mb", [1, 2, 4, 8])
def test_lint_plan_prunes_as_the_reference_does(mb):
    genes = list(genes_with(microbatches=mb))
    theirs = jax_lint_plan(JaxPlan.from_genes(genes), shape=JaxShape(
        "b6", seq_len=32, global_batch=6, kind="train"))
    mine = lint_plan(Plan.from_genes(genes), shape=SHAPE_B6)
    assert [f.to_dict() for f in mine] == [f.to_dict() for f in theirs]
    assert has_errors(mine) == (6 % mb != 0)


def test_evaluator_prunes_infeasible_without_tracing():
    counter = {"lowers": 0, "compiles": 0}
    cache = sc.SearchCache()
    ev = make_evaluator(cache, counter, lint=lint_for(SHAPE_B6))
    evs = ev([genes_with(), genes_with(microbatches=4),
              genes_with(microbatches=8)])
    assert counter["compiles"] == 1             # only the feasible candidate
    assert counter["lowers"] == 1
    assert evs[0].correct
    for e in evs[1:]:
        assert not e.correct and e.info["static_pruned"]
        assert e.info["static_findings"][0]["rule_id"] == "P002"
    assert cache.stats.static_pruned == 2
    assert cache.stats.candidates == 3
    assert cache.stats.to_dict()["static_pruned"] == 2
    # pruned candidates are neither hits nor misses
    assert cache.stats.hits == 0 and cache.stats.misses == 1


def test_lint_verdicts_are_memoized_per_individual():
    calls = {"n": 0}

    def counting_lint(plan):
        calls["n"] += 1
        return lint_plan(plan, shape=SHAPE_B6)

    counter = {"lowers": 0, "compiles": 0}
    ev = make_evaluator(sc.SearchCache(), counter, lint=counting_lint)
    gen = [genes_with(microbatches=4), genes_with()]
    ev(gen)
    ev(gen)                                     # second generation: memo
    assert calls["n"] == 2


def test_ga_with_linter_traces_strictly_less_same_selection():
    """Same GA, same seed, a population with infeasible candidates: the
    linted run builds strictly fewer traceables (the infeasible ones fail
    when built, as ``_split_microbatches`` raises), traces as often,
    selects the same winner, and its history counts the prunes."""
    cards = Plan.gene_cardinalities()
    cfg = GAConfig(population=8, generations=4, seed=3, cardinalities=cards)

    def run(lint):
        counter = {"lowers": 0, "compiles": 0}

        def trace_plan(plan):
            counter["lowers"] += 1
            if SHAPE_B6.global_batch % plan.microbatches:
                raise ValueError("batch % microbatches != 0")
            return CountingTraceable(counter)

        ev = sc.make_cached_batch_evaluator(
            trace_plan, CompiledCostRunner(n_chips=1), sc.SearchCache(),
            key_extra=("test",), pipe_ranks=2, lint=lint)
        res = run_ga(len(cards), ev.evaluate, cfg, evaluate_batch=ev)
        return counter, res, ev.cache.stats

    base_counter, base_res, _ = run(None)
    lint_counter, lint_res, stats = run(lint_for(SHAPE_B6))
    assert stats.static_pruned > 0
    assert lint_counter["lowers"] < base_counter["lowers"]
    assert lint_counter["compiles"] == base_counter["compiles"]
    assert lint_res.best_genes == base_res.best_genes
    assert sum(h["n_pruned"] for h in lint_res.history) > 0
    best = Plan.from_genes(list(lint_res.best_genes))
    assert not has_errors(lint_plan(best, shape=SHAPE_B6))
    assert lint_res.best_eval.correct


def test_ga_with_linter_identical_on_all_feasible_population():
    cards = Plan.gene_cardinalities()
    cfg = GAConfig(population=8, generations=4, seed=5, cardinalities=cards)

    def run(lint):
        counter = {"lowers": 0, "compiles": 0}
        ev = make_evaluator(sc.SearchCache(), counter, lint=lint)
        res = run_ga(len(cards), ev.evaluate, cfg, evaluate_batch=ev)
        return counter, res, ev.cache.stats

    base_counter, base_res, _ = run(None)
    lint_counter, lint_res, stats = run(lint_for(SHAPE_B8))
    assert stats.static_pruned == 0
    assert lint_counter["compiles"] == base_counter["compiles"]
    assert lint_res.best_genes == base_res.best_genes
    assert lint_res.best_eval.effective_time == \
        base_res.best_eval.effective_time


def test_unique_misses_are_traced_on_the_worker_pool():
    """Two unique keys of one generation trace at the same time (each
    waits for the other at a barrier), on threads other than the caller's,
    and at most one trace runs a key; ``from_genes`` builds the plans."""
    barrier = threading.Barrier(2, timeout=20)
    threads, built = set(), []

    class Meeting(CountingTraceable):
        def trace(self):
            threads.add(threading.get_ident())
            barrier.wait()
            return super().trace()

    counter = {"lowers": 0, "compiles": 0}

    def from_genes(genes):
        built.append(tuple(genes))
        return Plan.from_genes(list(genes))

    ev = sc.make_cached_batch_evaluator(
        lambda plan: Meeting(counter), CompiledCostRunner(n_chips=1),
        sc.SearchCache(), key_extra=("test",), workers=2,
        from_genes=from_genes)
    gen = [genes_with(), genes_with(remat="full"),
           genes_with(pipeline_schedule="one_f_one_b")]
    evs = ev(gen)
    assert all(e.correct for e in evs)
    assert counter["compiles"] == 2             # two structural keys
    assert len(threads) == 2 and threading.get_ident() not in threads
    assert built == gen


def _matmul(ab):
    return ab[0] @ ab[1]


@pytest.fixture(scope="module")
def fake_mesh():
    """A (2, 2) ("data", "model") mesh of the fake process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_test_mesh((2, 2), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_traces_take_turns(fake_mesh):
    """A trace on a mesh holds the process-wide lock for its whole run (DTensor
    propagation is not shared across threads); one without a mesh does
    not."""
    from repro_torch.dist.sharding import NamedSharding, PartitionSpec
    held = []

    def fn(ab):
        held.append(trace_analysis._MESH_TRACES.locked())
        return _matmul(ab)

    specs = (TensorSpec((8, 8), torch.float32, "cpu"),) * 2
    sh = (NamedSharding(fake_mesh, PartitionSpec("data")),
          NamedSharding(fake_mesh, PartitionSpec()))
    trace(fn, specs, sh)
    trace(fn, specs)
    assert held == [True, False]
    assert not trace_analysis._MESH_TRACES.locked()


# ------------------------------------------------- the loop searches
class _Nest:
    def __init__(self, name, impls):
        self.name = name
        self.impls = impls


class _CountingRunner:
    def __init__(self):
        self.calls = []

    def measure(self, fn, inputs, ref_out):
        self.calls.append(dict(fn))
        return Evaluation(time_s=1.0, correct=True)


def test_loop_ga_lint_choice_prunes_without_measuring():
    from repro_torch.backends.builtin import MANY_CORE
    from repro_torch.core.loop_offload import ga_search

    class App:
        name = "lint-app"
        nests = [_Nest("a", {"dp": None, "seq": None}),
                 _Nest("b", {"dp": None, "seq": None})]

        def build(self, choice):
            return dict(choice)

    def lint_choice(choice):
        if choice.get("a") == "dp":
            return [Finding("X001", "error", "nest a cannot offload")]
        return []

    runner = _CountingRunner()
    res = ga_search(App(), MANY_CORE, runner, inputs=None, ref_out=None,
                    ga_cfg=GAConfig(population=4, generations=4, seed=0),
                    lint_choice=lint_choice)
    assert res.cache_stats["static_pruned"] >= 1
    assert all(c.get("a") != "dp" for c in runner.calls)
    assert res.best_choice.get("a") != "dp"
    assert res.best_correct
    assert res.cache_stats["measured"] == len(runner.calls)


def test_fpga_search_lint_prunes_candidate_slots():
    from repro_torch.backends import FPGA
    from repro_torch.core.loop_offload import fpga_search

    app = APPS["3mm"]()
    st = app.make_inputs(seed=0, small=True, device="cpu")
    ref = app.reference_fn()(st)
    measured = []
    build = app.build

    def spying(choice):
        measured.append(dict(choice))
        return build(choice)

    app.build = spying

    def lint_choice(choice):
        if choice.get("mm1_E_AB") == "pallas":
            return [Finding("X001", "error", "mm1 statically rejected")]
        return []

    res = fpga_search(app, FPGA, TimedRunner(repeats=1), st, ref, st,
                      lint_choice=lint_choice)
    assert res.cache_stats["static_pruned"] >= 1
    assert res.best_choice.get("mm1_E_AB") != "pallas"
    assert res.n_measurements <= 4 and len(measured) <= 4
    assert all(c.get("mm1_E_AB") != "pallas" for c in measured)


# one statically rejected pattern an app, each one the search would meet
REJECT = {"3mm": ("mm1_E_AB", ("pallas",)),
          "tdFIR": ("scale_output", ("dp",)),
          "NAS.BT": ("seidel_relax", ("dp", "tp"))}


def _lint(name, finding):
    nest, impls = REJECT[name]

    def lint_choice(choice):
        if choice.get(nest) in impls:
            return [finding("X001", "error", f"{nest} statically rejected")]
        return []
    return lint_choice


@pytest.mark.parametrize("name", sorted(REJECT))
def test_plan_offload_lint_choice_matches_the_reference(name):
    app = APPS[name]()
    measured = []
    build = app.build

    def spying(choice):
        measured.append(dict(choice))
        return build(choice)

    app.build = spying
    mine = plan_offload(
        app, UserTarget(), inputs=app.make_inputs(0, small=True,
                                                  device="cpu"),
        runner=TimedRunner(repeats=1),
        ga_cfg=GAConfig(population=3, generations=3, seed=0), device="cpu",
        lint_choice=_lint(name, Finding))
    jax_app = JAX_APPS[name]()
    theirs = jax_plan_offload(
        jax_app, JaxUserTarget(), inputs=jax_app.make_inputs(0, small=True),
        runner=JaxTimedRunner(repeats=1),
        ga_cfg=JaxGAConfig(population=3, generations=3, seed=0),
        lint_choice=_lint(name, JaxFinding))
    assert [(r.destination, r.method, r.correct) for r in mine.records] == \
        [(r.destination, r.method, r.correct) for r in theirs.records]
    nest, impls = REJECT[name]
    assert all(c.get(nest) not in impls for c in measured)
    assert sum(r.cache_stats.get("static_pruned", 0)
               for r in mine.records) >= 1
    assert mine.selected is not None and mine.selected.correct
    assert mine.selected.choice.get(nest) not in impls
    fpga = [r for r in mine.records if r.paper_analogue == "FPGA"
            and r.method == "loop"]
    assert fpga and fpga[0].n_measurements <= 4
