"""repro_torch.fleet: placement of N apps over a shared pool from warm state,
the reference's tests/test_fleet.py run on the port, then the planner against
the JAX package's on one world.

Pins the subsystem contract: planning traces, captures and launches nothing
(run under ``kernels.ops.no_device_work``, like the router's hot path), a published verification failure is never placed
on, capacity (slots / memory / power cap) is enforced, the GA never does
worse than its greedy seed, and replan keeps unaffected apps pinned.
"""
import pytest

from repro_torch.core.cost_model import PEAK_FLOPS
from repro_torch.core.ga import Evaluation, GAConfig, run_ga
from repro_torch.core.plan_lookup import PlanLookup, serve_key
from repro_torch.fleet import (FleetApp, FleetPlanner, PoolBackend,
                               round_robin)
from repro_torch.kernels import ops
from repro_torch.power import PowerEnvelope
from test_torch_control import assert_same_records, payload, pkg_mod


class FakeBackend:
    def __init__(self, name, price=1.0, power=None):
        self.name = name
        self.price = price
        self.paper_analogue = ""
        self.power = power


HOT = PowerEnvelope("hot", idle_w=100.0, peak_w=200.0)
COOL = PowerEnvelope("cool", idle_w=5.0, peak_w=10.0)


def warm_time(lookup, backend_name, arch, t):
    """Payload whose roofline step time is exactly ``t`` (compute-bound)."""
    lookup.register(serve_key(backend_name, arch),
                    {"flops": t * PEAK_FLOPS, "bytes": 0.0,
                     "collective_bytes": 0.0})


def make_world(*, hot_t=0.1, cool_t=0.2, n_apps=4, load_rps=1.0,
               slots=8.0, power_budget_w=None, policy=None):
    """Two-backend pool (fast+hot vs slow+cool), every pair warm."""
    lookup = PlanLookup()
    pool = [
        PoolBackend(name="hot", backend=FakeBackend("hot", power=HOT),
                    slots=slots),
        PoolBackend(name="cool", backend=FakeBackend("cool", power=COOL),
                    slots=slots),
    ]
    apps = [FleetApp(name=f"a{i}", arch=f"m{i}", load_rps=load_rps,
                     tokens_per_request=1.0) for i in range(n_apps)]
    for app in apps:
        warm_time(lookup, "hot", app.arch, hot_t)
        warm_time(lookup, "cool", app.arch, cool_t)
    planner = FleetPlanner(pool, lookup, policy=policy,
                           power_budget_w=power_budget_w,
                           ga_cfg=GAConfig(population=6, generations=6,
                                           seed=0,
                                           cardinalities=[2] * n_apps))
    return planner, apps, lookup


# ----------------------------------------------------------- zero-trace pin
def test_fleet_planning_is_zero_compile():
    """The acceptance pin: planning N apps over warm PlanLookup entries
    performs no traces, captures or launches — only ``lookups`` moves."""
    planner, apps, lookup = make_world()
    misses0 = lookup.stats.misses
    lookups0 = lookup.stats.lookups
    with ops.no_device_work():
        placement = planner.plan(apps)
    assert placement.feasible
    assert lookup.stats.misses == misses0            # zero traces
    assert lookup.stats.lookups > lookups0           # warm reads happened


# ----------------------------------------------------------- basic behavior
def test_host_time_policy_packs_everything_on_the_fast_backend():
    planner, apps, _ = make_world(hot_t=0.1, cool_t=0.2)
    placement = planner.plan(apps)
    assert placement.feasible
    assert all(b == "hot" for b in placement.by_app.values())
    # load-weighted service sum: 4 apps x 1 rps x 0.1 s
    assert placement.objective == pytest.approx(0.4, rel=1e-3)


def test_published_failure_verdict_is_never_placed_on():
    planner, apps, lookup = make_world()
    lookup.register_failure(serve_key("hot", apps[0].arch), "wrong result")
    planner._cand_cache.clear()
    placement = planner.plan(apps)
    assert placement.feasible
    assert placement.by_app["a0"] == "cool"          # refused, not retried
    # forcing the failed pair is recorded as a violation, never silent
    forced = planner.evaluate(apps, tuple([0] * len(apps)))
    assert not forced.feasible
    assert any("published failure" in v or "no warm verified plan" in v
               for v in forced.violations)


def test_cold_pair_is_infeasible_not_compiled():
    """An app nothing ever verified anywhere cannot be placed."""
    planner, apps, lookup = make_world()
    stranger = FleetApp(name="x", arch="unseen", tokens_per_request=1.0)
    placement = planner.plan(list(apps) + [stranger])
    assert not placement.feasible
    assert any("x:" in v for v in placement.violations)


def test_power_cap_moves_load_to_the_cool_backend():
    """Under a fleet power cap the fast backend's draw no longer fits:
    the planner degrades to the slow cool destination instead of
    breaching the budget."""
    # load 10 rps x 0.1 s = utilization 1.0 -> the hot backend draws its
    # full modeled watts (~200 W); the cool one ~10 W
    free, apps, _ = make_world(load_rps=10.0)
    unconstrained = free.plan(apps)
    assert unconstrained.feasible
    assert unconstrained.fleet_draw_w > 100.0
    capped, apps, _ = make_world(load_rps=10.0, power_budget_w=50.0)
    placement = capped.plan(apps)
    assert placement.feasible
    assert placement.fleet_draw_w <= 50.0
    assert all(b == "cool" for b in placement.by_app.values())


def test_slot_capacity_splits_load_across_the_pool():
    # u = 6 rps x 0.1 s = 0.6 (hot) / 6 x 0.15 = 0.9 (cool) slot-
    # equivalents per app; slots=1.0 fits one app per backend, not two
    planner, apps, _ = make_world(n_apps=2, load_rps=6.0, slots=1.0,
                                  cool_t=0.15)
    placement = planner.plan(apps)
    assert placement.feasible
    assert set(placement.by_app.values()) == {"hot", "cool"}
    # and three such apps cannot fit a two-backend pool at all
    planner3, apps3, _ = make_world(n_apps=3, load_rps=6.0, slots=1.0,
                                    cool_t=0.15)
    assert not planner3.plan(apps3).feasible


def test_memory_capacity_is_enforced():
    lookup = PlanLookup()
    pool = [PoolBackend(name="small", backend=FakeBackend("small"),
                        memory_bytes=100.0),
            PoolBackend(name="big", backend=FakeBackend("big"),
                        memory_bytes=1e9)]
    app = FleetApp(name="a", arch="m", memory_bytes=200.0,
                   tokens_per_request=1.0)
    warm_time(lookup, "small", "m", 0.1)             # faster, but too small
    warm_time(lookup, "big", "m", 0.2)
    planner = FleetPlanner(pool, lookup,
                           ga_cfg=GAConfig(population=2, generations=2,
                                           seed=0, cardinalities=[2]))
    placement = planner.plan([app])
    assert placement.feasible and placement.by_app["a"] == "big"
    forced = planner.evaluate([app], (0,))
    assert not forced.feasible and any("small" in v
                                       for v in forced.violations)


# ------------------------------------------------------------ greedy vs GA
def test_ga_never_does_worse_than_its_greedy_seed():
    planner, apps, _ = make_world(n_apps=5, load_rps=3.0, slots=2.0)
    seed = planner.greedy(apps)
    assert seed is not None
    greedy_p = planner.evaluate(apps, seed)
    placement = planner.plan(apps)
    assert placement.feasible
    assert placement.objective <= greedy_p.objective + 1e-12


def test_run_ga_seed_population_is_injected_and_optional():
    target = (1, 0, 1)

    def fitness(genes):
        d = sum(a != b for a, b in zip(genes, target))
        return Evaluation(time_s=1.0 + d, correct=True)

    cfg = GAConfig(population=3, generations=1, seed=0)
    seeded = run_ga(3, fitness, cfg, seed_population=[target])
    assert seeded.best_genes == target               # present in gen 0
    # omitted -> byte-identical to the pre-parameter behavior
    a = run_ga(3, fitness, GAConfig(population=4, generations=3, seed=1))
    b = run_ga(3, fitness, GAConfig(population=4, generations=3, seed=1),
               seed_population=None)
    assert a.best_genes == b.best_genes and a.history == b.history
    with pytest.raises(AssertionError):
        run_ga(3, fitness, cfg, seed_population=[(1, 0)])


# ------------------------------------------------------------------ replan
def test_replan_keeps_unaffected_apps_pinned():
    planner, apps, lookup = make_world(n_apps=4)
    # a3 was proven wrong on hot offline -> it starts (and stays) on cool
    lookup.register_failure(serve_key("hot", apps[3].arch), "wrong result")
    planner._cand_cache.clear()
    placement = planner.plan(apps)
    assert placement.feasible
    assert placement.by_app["a0"] == "hot"
    assert placement.by_app["a3"] == "cool"
    out = planner.replan(apps, placement, "hot")
    assert out.feasible
    assert "hot" not in out.by_app.values()          # dead backend unused
    assert out.by_app["a3"] == "cool"                # unaffected: pinned
    assert out.info["replan"]["failed"] == "hot"
    assert out.info["replan"]["mode"] == "pinned-greedy"


def test_replan_unknown_backend_raises():
    planner, apps, _ = make_world()
    with pytest.raises(ValueError):
        planner.replan(apps, planner.plan(apps), "nope")


def test_replan_reports_infeasible_when_survivors_cannot_hold_the_fleet():
    planner, apps, _ = make_world(n_apps=2, load_rps=6.0, slots=1.0,
                                  cool_t=0.15)
    placement = planner.plan(apps)
    assert placement.feasible
    out = planner.replan(apps, placement, "hot")
    assert not out.feasible                          # 2x0.6 u > 1 slot
    assert "hot" not in [b for a, b in out.by_app.items()
                         if out.candidates.get(a)]


def test_replan_under_live_traffic_uses_observed_loads():
    """Satellite pin: the control loop replans with *observed* per-arch
    load folded in (repro_torch.fleet.observed_apps), not the declared
    estimates — survivors stay pinned, the displaced app is re-placed on
    the surviving backend under its real load."""
    from repro_torch.fleet import observed_apps
    planner, apps, lookup = make_world(n_apps=3, load_rps=1.0, slots=8.0)
    lookup.register_failure(serve_key("hot", apps[2].arch), "wrong result")
    planner._cand_cache.clear()
    placement = planner.plan(apps)
    assert placement.feasible
    assert placement.by_app["a2"] == "cool"
    # live traffic doubled on a0/a1 and halved on a2 vs the estimates
    live = observed_apps(apps, {"m0": 2.0, "m1": 2.0, "m2": 0.5})
    assert [a.load_rps for a in live] == pytest.approx([2.0, 2.0, 0.5])
    out = planner.replan(live, placement, "hot")
    assert out.feasible
    assert "hot" not in out.by_app.values()      # dead backend unused
    assert out.by_app["a2"] == "cool"            # survivor: pinned
    assert out.by_app["a0"] == out.by_app["a1"] == "cool"
    # the objective reflects the observed loads, not the declared ones:
    # (2 + 2 + 0.5) rps x 0.2 s on cool
    assert out.objective == pytest.approx(0.9, rel=1e-3)


def test_replan_violations_name_the_overflowing_backend():
    """A placement that was feasible before the failure must come back
    with explicit violations when the shrunken pool cannot host it —
    never a silently-infeasible or silently-dropped app."""
    planner, apps, _ = make_world(n_apps=2, load_rps=6.0, slots=1.0,
                                  cool_t=0.15)
    placement = planner.plan(apps)
    assert placement.feasible                    # one app per backend fits
    out = planner.replan(apps, placement, "hot")
    assert not out.feasible
    assert out.violations                        # explicit, not silent
    # and the survivors-only assignment names the overflowing backend:
    # 2 apps x 6 rps x 0.15 s = 1.8 slot-equivalents > cool's 1.0
    forced = planner.evaluate(apps, (1, 1), usable=[False, True])
    assert not forced.feasible
    assert any("cool" in v and "slot" in v for v in forced.violations)


# ---------------------------------------------------------------- baseline
def test_round_robin_is_the_capacity_blind_baseline():
    planner, apps, _ = make_world(n_apps=4)
    rr = round_robin(apps, planner.pool)
    assert rr == (0, 1, 0, 1)
    p = planner.evaluate(apps, rr)
    assert p.feasible                                # fits here, by luck
    best = planner.plan(apps)
    assert best.objective <= p.objective + 1e-12


# ------------------------------------------------ parity with the JAX package
def _placement_dict(p):
    return {"assignment": list(p.assignment), "by_app": p.by_app,
            "feasible": p.feasible, "objective": p.objective,
            "fleet_draw_w": p.fleet_draw_w,
            "joules_per_request": p.joules_per_request,
            "violations": p.violations, "info": p.info}


def fleet_run(pkg, *, load_rps, power_budget_w):
    """``make_world`` in ``pkg`` (payloads at its own peaks) with a
    published failure for a3 on hot, then ``plan`` and ``replan`` after
    the hot backend fails."""
    fleet = pkg_mod(pkg, "fleet")
    pl = pkg_mod(pkg, "core.plan_lookup")
    power = pkg_mod(pkg, "power")
    GA = pkg_mod(pkg, "core.ga").GAConfig
    hot = FakeBackend("hot", power=power.PowerEnvelope(
        "hot", idle_w=100.0, peak_w=200.0))
    cool = FakeBackend("cool", power=power.PowerEnvelope(
        "cool", idle_w=5.0, peak_w=10.0))
    lookup = pl.PlanLookup()
    pool = [fleet.PoolBackend(name="hot", backend=hot, slots=8.0),
            fleet.PoolBackend(name="cool", backend=cool, slots=8.0)]
    apps = [fleet.FleetApp(name=f"a{i}", arch=f"m{i}", load_rps=load_rps,
                           tokens_per_request=1.0) for i in range(4)]
    for app in apps:
        lookup.register(pl.serve_key("hot", app.arch), payload(pkg, 0.1))
        lookup.register(pl.serve_key("cool", app.arch), payload(pkg, 0.2))
    lookup.register_failure(pl.serve_key("hot", "m3"), "wrong result")
    planner = fleet.FleetPlanner(pool, lookup, power_budget_w=power_budget_w,
                                 ga_cfg=GA(population=6, generations=6,
                                           seed=0, cardinalities=[2] * 4))
    placement = planner.plan(apps)
    return placement, planner.replan(apps, placement, "hot")


@pytest.mark.parametrize("load_rps,power_budget_w", [(1.0, None),
                                                     (10.0, 50.0)])
def test_plan_and_replan_equal_the_jax_packages(load_rps, power_budget_w):
    ref = fleet_run("repro", load_rps=load_rps,
                    power_budget_w=power_budget_w)
    with ops.no_device_work():
        ours = fleet_run("repro_torch", load_rps=load_rps,
                         power_budget_w=power_budget_w)
    for r, o in zip(ref, ours):
        assert_same_records(_placement_dict(r), _placement_dict(o),
                            path="placement")
    plan, replan = ours
    assert plan.by_app["a3"] == "cool"              # never on its failure
    assert "hot" not in replan.by_app.values()
