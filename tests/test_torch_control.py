"""repro_torch.runtime.control: the closed plan -> serve -> observe -> replan
loop, the reference's tests/test_control.py run on the port, then the chaos
scenario against the JAX package's.

Pins the PR's acceptance scenario: an endpoint killed mid-trace opens its
circuit, the quarantined endpoint receives zero non-probe dispatches,
in-flight requests drain to completion (zero dropped, zero
double-completed), the FleetController replans without placing on the
failed backend, and a half-open probe restores the endpoint after the
fault window — all on a deterministic tick clock with zero traces,
captures and launches (``kernels.ops.no_device_work``, like the router's
and the fleet planner's pins).
"""
import importlib

import pytest

from repro_torch.core.cost_model import PEAK_FLOPS
from repro_torch.core.ga import GAConfig
from repro_torch.core.plan_lookup import PlanLookup, serve_key
from repro_torch.fleet import (FleetApp, FleetPlanner, PoolBackend,
                               observed_apps)
from repro_torch.kernels import ops
from repro_torch.power import PowerEnvelope
from repro_torch.runtime.control import (ControlLoop, Fault, FaultInjector,
                                         FleetController)
from repro_torch.serve import Endpoint, HealthConfig, Request, Router
from repro_torch.serve.health import HEALTHY, PROBING, QUARANTINED

TICK_S = 0.01


class FakeBackend:
    def __init__(self, name, power=None):
        self.name = name
        self.price = 1.0
        self.paper_analogue = ""
        self.power = power


HOT = PowerEnvelope("hot", idle_w=100.0, peak_w=200.0)
COOL = PowerEnvelope("cool", idle_w=5.0, peak_w=10.0)


def warm_time(lookup, backend_name, arch, t):
    lookup.register(serve_key(backend_name, arch),
                    {"flops": t * PEAK_FLOPS, "bytes": 0.0,
                     "collective_bytes": 0.0})


def req(rid, tick, *, arch="m0", max_gen=1):
    # scale = max_gen + prompt_len/8 = 2 decode-steps of modeled work
    return Request(rid=rid, arch=arch, prompt_len=8, max_gen=max_gen,
                   arrival_s=tick * TICK_S)


def make_world(*, hot_t=0.005, cool_t=0.02, load_rps=1.0,
               power_budget_w=None, health_cfg=None, n_slots=4):
    """One app, two destinations: hot0 (fast, hungry) and cool0 (slow,
    frugal), Router endpoints and FleetPlanner pool sharing one lookup
    and one backend namespace so serve keys line up."""
    lookup = PlanLookup()
    hot_b, cool_b = FakeBackend("hot", HOT), FakeBackend("cool", COOL)
    warm_time(lookup, "hot", "m0", hot_t)
    warm_time(lookup, "cool", "m0", cool_t)
    hot0 = Endpoint(name="hot0", backend=hot_b, arch="m0", n_slots=n_slots)
    cool0 = Endpoint(name="cool0", backend=cool_b, arch="m0",
                     n_slots=n_slots)
    cfg = health_cfg if health_cfg is not None else HealthConfig(
        error_threshold=1, backoff_ticks=4, backoff_mult=2.0,
        probe_quota=1, probe_successes=1)
    router = Router([hot0, cool0], lookup, policy="modeled",
                    health_cfg=cfg)
    pool = [PoolBackend(name="hot", backend=hot_b, slots=16.0),
            PoolBackend(name="cool", backend=cool_b, slots=16.0)]
    apps = [FleetApp(name="a0", arch="m0", load_rps=load_rps,
                     tokens_per_request=2.0)]
    planner = FleetPlanner(pool, lookup, power_budget_w=power_budget_w,
                           ga_cfg=GAConfig(population=4, generations=4,
                                           seed=0, cardinalities=[2]))
    return router, planner, apps, lookup, (hot0, cool0)


# ------------------------------------------------------------ fault plans
def test_fault_windows_are_pure_functions_of_tick():
    inj = FaultInjector([
        Fault(kind="kill", endpoint="a", at_tick=5, until_tick=10),
        Fault(kind="latency", endpoint="a", at_tick=0, until_tick=4,
              factor=3.0),
        Fault(kind="latency", endpoint="a", at_tick=2, until_tick=4,
              factor=2.0),
        Fault(kind="wrong_result", endpoint="b", at_tick=7),
        Fault(kind="power_spike", endpoint="b", at_tick=1, until_tick=3,
              factor=40.0),
    ])
    assert not inj.is_dead("a", 4) and inj.is_dead("a", 5)
    assert inj.is_dead("a", 9) and not inj.is_dead("a", 10)
    assert inj.latency_factor("a", 1) == pytest.approx(3.0)
    assert inj.latency_factor("a", 3) == pytest.approx(6.0)  # compounds
    assert inj.latency_factor("a", 4) == 1.0
    assert inj.latency_factor("b", 3) == 1.0                 # scoped
    assert not inj.wrong_result("b", 6)
    assert inj.wrong_result("b", 7) and inj.wrong_result("b", 10_000)
    assert inj.power_spike_w("b", 2) == pytest.approx(40.0)
    assert inj.power_spike_w("b", 3) == 0.0
    # querying never mutates: same answers on replay
    assert inj.is_dead("a", 5) and inj.latency_factor("a", 3) == 6.0


def test_fault_validation():
    with pytest.raises(ValueError):
        Fault(kind="meteor", endpoint="a", at_tick=0)
    with pytest.raises(ValueError):
        Fault(kind="kill", endpoint="a", at_tick=5, until_tick=5)


# ------------------------------------------------- the acceptance scenario
def test_chaos_kill_quarantine_drain_replan_probe_recover():
    """The PR's acceptance pin, end to end on one deterministic clock."""
    router, planner, apps, lookup, (hot0, cool0) = make_world()
    placement = planner.plan(apps)
    assert placement.feasible and placement.by_app["a0"] == "hot"
    ctl = FleetController(router, planner, apps, placement=placement,
                          tick_s=TICK_S)
    kill = Fault(kind="kill", endpoint="hot0", at_tick=10, until_tick=30)
    loop = ControlLoop(
        router, [req(f"r{i:03d}", i) for i in range(60)],
        controller=ctl, injector=FaultInjector([kill]), tick_s=TICK_S)

    misses0 = lookup.stats.misses
    lookups0 = lookup.stats.lookups

    with ops.no_device_work():
        out = loop.run()

    # zero-trace: the whole loop re-scored through PlanLookup only
    assert lookup.stats.misses == misses0
    assert lookup.stats.lookups > lookups0

    # every request completes exactly once: no drops, no double counting
    assert out["completed"] == 60
    assert out["dropped"] == []
    assert out["double_completed"] == 0
    assert out["failed"] >= 1                    # the kill was really felt
    assert out["fleet_draw_w_min"] >= 0.0

    # the circuit opened at the kill and closed only after the window
    health = router.health["hot0"]
    seq = [(t["from"], t["to"]) for t in health.transitions]
    assert (HEALTHY, QUARANTINED) == seq[0]
    assert (QUARANTINED, PROBING) in seq
    assert (PROBING, QUARANTINED) in seq         # a probe died in-window
    assert seq[-1] == (PROBING, HEALTHY)         # recovered post-window
    assert health.recoveries == 1
    recovered_tick = health.transitions[-1]["tick"]
    assert recovered_tick >= 30

    # while quarantined, hot0 saw zero non-probe dispatches: every
    # dispatch inside the fault window was a half-open probe that died
    quarantined_at = health.transitions[0]["tick"]
    in_window = [t for t, _, name in loop.dispatch_log
                 if name == "hot0" and quarantined_at < t < 30]
    probe_failures = sum(1 for a, b in seq if (a, b) ==
                         (PROBING, QUARANTINED))
    assert len(in_window) == probe_failures      # probes only, nothing else
    # after recovery the fast endpoint carries traffic again
    assert any(name == "hot0" and t > recovered_tick
               for t, _, name in loop.dispatch_log)

    # the controller replanned off the failed backend without placing on it
    replans = [e for e in ctl.events if e["event"] == "replan"]
    assert replans and replans[0]["failed"] == "hot"
    assert replans[0]["by_app"]["a0"] == "cool"
    assert all(e["fleet_draw_w"] >= 0.0 for e in replans)

    # in-flight work admitted before the kill drained through the ledger
    assert router.fleet_draw_w == 0.0
    assert all(ep.in_flight == 0 for ep in router.endpoints)


def test_chaos_replay_is_deterministic():
    """Same fault plan + same trace => identical summary, tick for tick."""
    def run_once():
        router, planner, apps, _, _ = make_world()
        ctl = FleetController(router, planner, apps,
                              placement=planner.plan(apps), tick_s=TICK_S)
        loop = ControlLoop(
            router, [req(f"r{i:03d}", i) for i in range(40)],
            controller=ctl,
            injector=FaultInjector([Fault(kind="kill", endpoint="hot0",
                                          at_tick=8, until_tick=20)]),
            tick_s=TICK_S)
        out = loop.run()
        return out, loop.dispatch_log

    (out_a, log_a), (out_b, log_b) = run_once(), run_once()
    assert log_a == log_b
    for key in ("ticks", "completed", "failed", "dropped",
                "double_completed", "dispatches", "refusals"):
        assert out_a[key] == out_b[key], key


def test_chaos_replay_trace_is_byte_identical():
    """The replay pin, extended to observability: tracing the identical
    scenario twice must serialize to byte-identical JSONL — every span and
    event rides the loop's virtual tick clock (Tracer.set_time), and ids
    are sequential, so nothing wall-clock-shaped can leak in."""
    from repro_torch.obs import Tracer, jsonl_line, use_tracer

    def run_once() -> str:
        tr = Tracer()
        with use_tracer(tr):
            # pin the clock before the world is built so the pre-loop
            # records (fleet plan span, GA generation events) are pinned too
            tr.set_time(0.0)
            router, planner, apps, _, _ = make_world()
            ctl = FleetController(router, planner, apps,
                                  placement=planner.plan(apps),
                                  tick_s=TICK_S)
            loop = ControlLoop(
                router, [req(f"r{i:03d}", i) for i in range(40)],
                controller=ctl,
                injector=FaultInjector([Fault(kind="kill", endpoint="hot0",
                                              at_tick=8, until_tick=20)]),
                tick_s=TICK_S)
            loop.run()
        return "\n".join(jsonl_line(r) for r in tr.records) + "\n"

    a, b = run_once(), run_once()
    assert a == b
    # and the trace actually observed the scenario, layer by layer
    for marker in ('"name":"route"', '"name":"tick"', '"name":"request"',
                   '"name":"transition"', '"name":"replan"',
                   '"name":"generation"', '"name":"plan"'):
        assert marker in a, marker


# ------------------------------------------------------------ wrong result
def test_wrong_result_publishes_failure_and_replan_avoids_the_backend():
    """A wrong result is the online form of a verification failure: the
    request fails, the verdict lands in the lookup, and neither the
    router nor the next replan ever uses that destination again."""
    router, planner, apps, lookup, _ = make_world()
    ctl = FleetController(router, planner, apps,
                          placement=planner.plan(apps), tick_s=TICK_S)
    loop = ControlLoop(
        router, [req(f"r{i:02d}", i * 2) for i in range(10)],
        controller=ctl,
        injector=FaultInjector([Fault(kind="wrong_result",
                                      endpoint="hot0", at_tick=0)]),
        tick_s=TICK_S)
    out = loop.run()
    assert out["completed"] == 10 and out["dropped"] == []
    # the verdict is published: the key refuses statically from now on
    assert not lookup.usable(lookup.lookup(serve_key("hot", "m0")))
    # the wrongdoer saw exactly one dispatch — the one that caught it
    assert out["dispatches"]["hot0"] == 1
    assert out["dispatches"]["cool0"] == 10
    # and the replan (triggered by the quarantine) avoided it
    replans = [e for e in ctl.events if e["event"] == "replan"]
    assert replans and all(e["by_app"]["a0"] == "cool" for e in replans)
    assert ctl.placement.feasible
    assert ctl.placement.by_app["a0"] == "cool"


# --------------------------------------------------- drain-based migration
def test_observed_load_replans_and_migrates_by_draining():
    """Observed load (not the declared estimate) drives the replan; the
    freed endpoint is drained, its in-flight requests complete through
    the ledger (zero dropped / double-completed), and only then is it
    removed.  The migration never goes draw-negative."""
    router, planner, apps, lookup, (hot0, cool0) = make_world(
        hot_t=0.1, cool_t=0.2, load_rps=0.1, power_budget_w=50.0)
    placement = planner.plan(apps)
    assert placement.by_app["a0"] == "hot"       # cheap at the declared load
    ctl = FleetController(router, planner, apps, placement=placement,
                          tick_s=TICK_S)
    # admit three requests onto hot0 (the soon-to-be-migrated endpoint)
    decisions = []
    for i in range(3):
        d = router.route(req(f"fly{i}", 0))
        assert d.accepted and d.endpoint.name == "hot0"
        router.dispatch(d)
        decisions.append(d)
    draw_before = router.fleet_draw_w
    assert draw_before > 0.0
    # observe 20 rps of real traffic: utilization 2.0 slot-equivalents at
    # ~200 W on hot — over the 50 W budget; cool holds it at ~10 W
    for i in range(20):
        ctl.on_complete(req(f"obs{i}", i * 5), "hot0", 0.1, tick=i * 5)
    assert ctl.observed_load_rps()["m0"] == pytest.approx(20.0, rel=0.1)
    folded = ctl.observed_apps()
    assert folded[0].load_rps == pytest.approx(20.0, rel=0.1)

    new = ctl.replan(tick=100)
    assert new.feasible and new.by_app["a0"] == "cool"
    assert hot0.draining                         # migration = drain, not cut
    assert router.endpoint("hot0") is not None   # still live while draining
    # no new dispatches land on the draining endpoint
    d = router.route(req("after", 100))
    assert d.accepted and d.endpoint.name == "cool0"
    router.dispatch(d)
    # in-flight work completes through the ledger: nothing dropped
    for dec in decisions:
        assert router.complete(dec, latency_s=0.1)
        assert router.fleet_draw_w >= 0.0
    assert router.drained("hot0")
    ctl.step(101)                                # controller reaps the drain
    assert router.endpoint("hot0") is None
    removed = [e for e in ctl.events if e["event"] == "removed"]
    assert [e["endpoint"] for e in removed] == ["hot0"]
    # the survivor still serves and the books balance
    assert router.complete(d, latency_s=0.2)
    assert router.fleet_draw_w == 0.0


def test_quarantined_endpoint_is_never_drained():
    """Recovery owns a quarantined endpoint: migration must not drain it,
    or the half-open probes would have nothing to restore."""
    router, planner, apps, _, (hot0, _) = make_world()
    ctl = FleetController(router, planner, apps,
                          placement=planner.plan(apps), tick_s=TICK_S)
    router.health["hot0"].quarantine("died")
    ctl.replan(tick=5, failed="hot")
    assert not hot0.draining
    assert ctl.placement.by_app["a0"] == "cool"


# ------------------------------------------------------------------ resize
def test_elastic_resize_event_triggers_a_replan():
    from repro_torch.runtime.elastic import ResizeEvent, detect_resize
    assert detect_resize(None, 4) is None        # first observation
    assert detect_resize(4, 4) is None           # stable
    ev = detect_resize(4, 2, tick=17)
    assert ev == ResizeEvent(tick=17, n_before=4, n_after=2)
    assert not ev.grew and detect_resize(2, 4, tick=18).grew

    router, planner, apps, _, _ = make_world()
    ctl = FleetController(router, planner, apps,
                          placement=planner.plan(apps), tick_s=TICK_S)
    out = ctl.on_resize(ev)
    assert out.feasible
    kinds = [e["event"] for e in ctl.events]
    assert kinds == ["resize", "replan"]
    assert ctl.events[0]["n_after"] == 2


# ----------------------------------------------------- metrics observation
def test_metrics_report_refusal_reasons_and_endpoint_percentiles():
    """All endpoints quarantined => the refusal says so (not a generic
    infeasibility), and completed requests feed per-endpoint p50/p95."""
    router, planner, apps, _, _ = make_world()
    loop = ControlLoop(
        router, [req(f"r{i}", i) for i in range(8)],
        injector=FaultInjector([
            Fault(kind="kill", endpoint="hot0", at_tick=2, until_tick=6),
            Fault(kind="latency", endpoint="cool0", at_tick=0, factor=2.0),
        ]), tick_s=TICK_S, max_ticks=120)
    out = loop.run()
    assert out["completed"] == 8 and out["dropped"] == []
    summary = router.metrics.summary()
    assert summary["refusals"] == out["refusals"]
    eps = summary["endpoints"]
    assert set(eps) <= {"hot0", "cool0"} and "cool0" in eps
    for name, s in eps.items():
        assert s["completed"] >= 1
        assert 0.0 <= s["latency_p50_s"] <= s["latency_p95_s"]
    # per-arch observation is stamped on every request record
    assert all(m.arch == "m0" for m in router.metrics.requests.values())


def test_all_endpoints_quarantined_refuses_with_the_right_reason():
    router, planner, apps, _, _ = make_world()
    for h in router.health.values():
        h.quarantine("chaos")
    d = router.route(req("r0", 0))
    assert not d.accepted and d.reason == "endpoint quarantined"
    assert router.metrics.refusals["endpoint quarantined"] == 1


def test_observed_apps_splits_load_across_apps_sharing_an_arch():
    apps = [FleetApp(name="a", arch="m"), FleetApp(name="b", arch="m"),
            FleetApp(name="c", arch="other", load_rps=7.0)]
    out = observed_apps(apps, {"m": 10.0})
    assert [a.load_rps for a in out] == pytest.approx([5.0, 5.0, 7.0])
    assert [a.name for a in out] == ["a", "b", "c"]
    assert observed_apps(apps, {})[2].load_rps == 7.0


def test_power_spike_fault_shows_up_in_the_draw_trace():
    router, planner, apps, _, _ = make_world()
    spike = Fault(kind="power_spike", endpoint="hot0", at_tick=0,
                  until_tick=5, factor=123.0)
    loop = ControlLoop(router, [req("r0", 0)],
                       injector=FaultInjector([spike]), tick_s=TICK_S)
    out = loop.run()
    assert out["completed"] == 1
    assert out["fleet_draw_w_max"] >= 123.0
    assert out["fleet_draw_w_min"] >= 0.0


# ------------------------------------------------ parity with the JAX package
# The worlds below are built the same way in both packages through
# importlib.  The one difference by design is the roofline's peaks: the
# port prices FLOPs and bytes at the H100's rates, the reference at a TPU
# chip's, so a payload is written as the seconds each roofline term should
# take and scaled by the package's own peaks (``payload``).  Every modeled
# time, watt and joule then agrees, and the comparisons are exact (floats
# in the trace to rel 1e-9).
PACKAGES = ("repro", "repro_torch")


def pkg_mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def payload(pkg, compute_s, memory_s=0.0, collective_s=0.0):
    """A warm analysis whose roofline terms take these seconds in ``pkg``:
    FLOPs, bytes and collective bytes at that package's own peaks (the
    port's ``LINK_BW``, the reference's ``ICI_BW``)."""
    cm = pkg_mod(pkg, "core.cost_model")
    link = cm.LINK_BW if hasattr(cm, "LINK_BW") else cm.ICI_BW
    return {"flops": compute_s * cm.PEAK_FLOPS,
            "bytes": memory_s * cm.HBM_BW,
            "collective_bytes": collective_s * link}


def assert_same_records(a, b, rel=1e-9, path="records"):
    """Structural equality with floats held to ``rel``."""
    if isinstance(a, float) and isinstance(b, float):
        assert b == pytest.approx(a, rel=rel, abs=0.0), path
    elif isinstance(a, dict) and isinstance(b, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same_records(a[k], b[k], rel, f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_records(x, y, rel, f"{path}[{i}]")
    else:
        assert a == b, path


def chaos_run(pkg, *, requests=120, kill_at=20, revive_at=60):
    """The reference's benchmarks/chaos.py kill scenario in ``pkg``: a
    fast hungry and a slow frugal destination warm in one lookup, an
    open-loop trace of one request a tick, the fast endpoint killed
    mid-trace and revived later, every layer traced on the tick clock."""
    obs = pkg_mod(pkg, "obs")
    ctl = pkg_mod(pkg, "runtime.control")
    serve = pkg_mod(pkg, "serve")
    pl = pkg_mod(pkg, "core.plan_lookup")
    fleet = pkg_mod(pkg, "fleet")
    power = pkg_mod(pkg, "power")
    GA = pkg_mod(pkg, "core.ga").GAConfig
    tracer = obs.Tracer()
    with obs.use_tracer(tracer):
        tracer.set_time(0.0)
        lookup = pl.PlanLookup()
        hot_b = FakeBackend("hot", power.PowerEnvelope(
            "hot", idle_w=100.0, peak_w=200.0))
        cool_b = FakeBackend("cool", power.PowerEnvelope(
            "cool", idle_w=5.0, peak_w=10.0))
        for order, (name, step_t) in enumerate((("hot", 0.005),
                                                ("cool", 0.02))):
            with obs.get_tracer().span(
                    "verify", cat="plan", track=f"backend:{name}",
                    backend=name, method="roofline-register",
                    order=order) as vspan:
                lookup.register(pl.serve_key(name, "app"),
                                payload(pkg, step_t))
                vspan.set(best_time_s=step_t, correct=True, compile_s=0.0,
                          cache_hit=True)
        router = serve.Router(
            [serve.Endpoint(name="hot0", backend=hot_b, arch="app",
                            n_slots=8),
             serve.Endpoint(name="cool0", backend=cool_b, arch="app",
                            n_slots=8)],
            lookup, policy="modeled",
            health_cfg=serve.HealthConfig(error_threshold=1,
                                          backoff_ticks=4, backoff_mult=2.0,
                                          probe_quota=1, probe_successes=1))
        planner = fleet.FleetPlanner(
            [fleet.PoolBackend(name="hot", backend=hot_b, slots=16.0),
             fleet.PoolBackend(name="cool", backend=cool_b, slots=16.0)],
            lookup, ga_cfg=GA(population=4, generations=4, seed=0,
                              cardinalities=[2]))
        apps = [fleet.FleetApp(name="app#0", arch="app", load_rps=1.0,
                               tokens_per_request=2.0)]
        controller = ctl.FleetController(router, planner, apps,
                                         placement=planner.plan(apps),
                                         tick_s=TICK_S)
        trace = [serve.Request(rid=f"r{i:04d}", arch="app", prompt_len=8,
                               max_gen=1, arrival_s=i * TICK_S)
                 for i in range(requests)]
        loop = ctl.ControlLoop(
            router, trace, controller=controller,
            injector=ctl.FaultInjector([ctl.Fault(
                kind="kill", endpoint="hot0", at_tick=kill_at,
                until_tick=revive_at)]),
            tick_s=TICK_S, max_ticks=50 * requests)
        summary = loop.run()
        tracer.clear_time()
    return {"summary": summary, "router": router, "loop": loop,
            "controller": controller, "records": tracer.records,
            "jsonl": "".join(obs.jsonl_line(r) + "\n"
                             for r in tracer.records)}


def test_chaos_scenario_equals_the_jax_packages():
    """The kill scenario in both packages: the same routing decisions,
    health transitions, replans, summary and JSONL log record for record;
    the port's run traces, captures and launches nothing."""
    ref = chaos_run("repro")
    with ops.no_device_work():
        ours = chaos_run("repro_torch")
    s = ours["summary"]
    assert s == ref["summary"]
    assert s["completed"] == 120 and s["dropped"] == []
    assert s["double_completed"] == 0 and s["failed"] >= 1
    assert ours["loop"].dispatch_log == ref["loop"].dispatch_log
    for name in ("hot0", "cool0"):
        assert ours["router"].health[name].transitions == \
            ref["router"].health[name].transitions
    assert ours["router"].health["hot0"].recoveries == 1
    assert_same_records(ref["controller"].events,
                        ours["controller"].events, path="events")
    assert len(ours["records"]) == len(ref["records"]) > 300
    assert_same_records(ref["records"], ours["records"])
    # and the port's log replays byte for byte
    assert chaos_run("repro_torch")["jsonl"] == ours["jsonl"]
