"""repro_torch.serve.router + repro_torch.core.plan_lookup: the search/lookup
split, the reference's tests/test_serve_router.py run on the port, then the
router against the JAX package's on one world.

After warm-up, routing any number of requests performs zero traces, graph
captures and kernel launches — the hot path is dict lookup + roofline
arithmetic.  ``CacheStats.misses`` is the trace counter, and the tests
additionally run the path under ``kernels.ops.no_device_work`` (the port's
``trace_analysis.trace`` and ``CountedGraph`` poisoned, launch counters
held), where the reference poisons ``jax.jit``.  The payloads here are
absolute FLOPs and bytes; the port prices them at the H100's peaks, so
times differ from the reference's but every ranking below is the same.
"""
import time

import pytest

from repro_torch.backends.builtin import GPU, MANY_CORE
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.core.plan_lookup import (PlanLookup, analysis_from_roofline,
                                          analysis_from_time, publish_record,
                                          serve_key)
from repro_torch.serve import Endpoint, Request, Router
from test_torch_control import assert_same_records, payload, pkg_mod

ARCH = "granite-3-2b"


def make_endpoints(cfg, *, n_slots=2, cache_len=64):
    gpu = Endpoint(name="gpu0", backend=GPU, arch=cfg.name,
                   n_slots=n_slots, cache_len=cache_len, cfg=cfg)
    mc = Endpoint(name="mc0", backend=MANY_CORE, arch=cfg.name,
                  n_slots=n_slots, cache_len=cache_len, cfg=cfg)
    return gpu, mc


def warm(lookup, gpu, mc, *, gpu_collective=0.0):
    # gpu: lighter compute => faster modeled step; mc: 50x the flops
    lookup.register(gpu.lookup_key(),
                    {"flops": 1e9, "bytes": 1e6,
                     "collective_bytes": gpu_collective})
    lookup.register(mc.lookup_key(),
                    {"flops": 5e10, "bytes": 1e6, "collective_bytes": 0.0})


def req(rid, *, prompt_len=8, max_gen=4, **kw):
    return Request(rid=rid, arch=ARCH, prompt_len=prompt_len,
                   max_gen=max_gen, **kw)


# ------------------------------------------------------------ plan lookup
def test_serve_key_distinguishes_backend_arch_and_plan():
    from repro_torch.dist.plan import Plan, SERVE_LOW_MEM
    a = serve_key("gpu", "m1")
    assert a == serve_key("gpu", "m1")
    assert a != serve_key("cpu", "m1") and a != serve_key("gpu", "m2")
    assert serve_key("gpu", "m1", Plan()) != \
        serve_key("gpu", "m1", SERVE_LOW_MEM)
    # model-only genes don't split serving identities (structural_key)
    import dataclasses
    sched = dataclasses.replace(Plan(), pipeline_schedule="1f1b")
    assert serve_key("gpu", "m1", Plan()) == serve_key("gpu", "m1", sched)


def test_analysis_roundtrips_roofline_and_host_time():
    from repro_torch.core.cost_model import roofline_from_analysis
    src = {"flops": 2e9, "bytes": 3e6, "collective_bytes": 4e5}
    rl = roofline_from_analysis(src, n_chips=1)
    back = analysis_from_roofline(rl.to_dict())
    assert back == pytest.approx(src)
    assert analysis_from_roofline({}) is None
    # host-time fallback reproduces the measured seconds when scored
    an = analysis_from_time(0.25)
    rl2 = roofline_from_analysis(an, n_chips=1)
    assert rl2.step_time_s == pytest.approx(0.25)
    assert analysis_from_time(float("inf")) is None


def test_lookup_score_and_failure_refusal():
    lk = PlanLookup()
    key = serve_key("gpu", ARCH)
    assert lk.score(key) is None                 # cold
    lk.register(key, {"flops": 1e9, "bytes": 1e6, "collective_bytes": 0.0})
    ev = lk.score(key)
    assert ev is not None and ev.correct and ev.time_s > 0
    # a later failure supersedes the success — never dispatched to again
    lk.register_failure(key, "wrong result")
    assert lk.score(key) is None
    assert not lk.usable(lk.lookup(key))


def test_publish_record_rules():
    class Rec:
        correct = True
        best_time_s = 0.01
        verify_elapsed_s = 1.0
        note = ""
        mesh_info = {}
    lk = PlanLookup()
    assert publish_record(lk, Rec(), GPU, "app")
    ev = lk.score(serve_key(GPU.name, "app"))
    assert ev.correct and ev.time_s == pytest.approx(0.01)
    # an incorrect record must NOT clobber the success from another
    # verification method of the same backend...
    bad = Rec()
    bad.correct = False
    bad.note = "result mismatch"
    assert not publish_record(lk, bad, GPU, "app")
    assert lk.score(serve_key(GPU.name, "app")) is not None
    # ...but on a cold key it is a recorded refusal
    assert publish_record(lk, bad, MANY_CORE, "app")
    assert lk.score(serve_key(MANY_CORE.name, "app")) is None


# ----------------------------------------------------------- hot routing
def test_hot_path_zero_traces_zero_compiles_after_warmup():
    """The acceptance pin: after warm-up, routing N requests moves only
    ``lookups`` — ``misses`` (the trace counter) stays flat, and any
    attempt to trace, capture or launch on the path raises."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    router.route(req("warmup"))                  # exercise every code path

    misses0 = lk.stats.misses
    lookups0 = lk.stats.lookups
    t0 = time.perf_counter()
    n = 200
    with ops.no_device_work():
        for i in range(n):
            d = router.route(req(f"q{i}"))
            assert d.accepted and d.endpoint.name == "gpu0"
    elapsed = time.perf_counter() - t0
    assert lk.stats.misses == misses0            # zero traces
    assert lk.stats.lookups >= lookups0 + n      # the hot reads happened
    # sub-ms per route on any plausible host (generous 5x headroom)
    assert elapsed / n < 5e-3, f"{elapsed / n * 1e3:.2f} ms per route"


def test_policy_ranked_dispatch_flips_on_comm_bound_request():
    """Satellite pin: under the modeled policy the compute-light gpu wins,
    until its warm analysis shows a dominant collective — then the router
    flips to the many-core endpoint for the same request."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    assert router.route(req("a")).endpoint.name == "gpu0"
    # re-warm gpu as comm-bound: collective term dwarfs mc's compute
    warm(lk, gpu, mc, gpu_collective=1e12)
    assert router.route(req("b")).endpoint.name == "mc0"


def test_power_budget_admission_rejects_when_fleet_saturated():
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg, n_slots=8)
    warm(lk, gpu, mc)
    probe = Router([gpu, mc], lk, policy="modeled").route(req("probe"))
    assert probe.avg_watts is not None and probe.avg_watts > 0
    gpu.in_flight = mc.in_flight = 0
    # budget fits exactly two in-flight requests' draw
    budget = probe.avg_watts * 2.5
    router = Router([gpu, mc], lk, policy="modeled",
                    power_budget_w=budget)
    d1 = router.route(req("r1"))
    router.dispatch(d1)
    d2 = router.route(req("r2"))
    router.dispatch(d2)
    d3 = router.route(req("r3"))
    assert not d3.accepted and d3.reason == "power budget saturated"
    assert router.metrics.rejected == 1
    # completing one frees draw: admission recovers
    router.complete(d1)
    assert router.route(req("r4")).accepted


def test_double_complete_cannot_drive_accounting_negative():
    """Satellite pin: the admission ledger releases exactly what dispatch
    charged, once — double complete, completing a rejected decision, or
    completing a routed-but-never-dispatched decision are all no-ops, and
    double dispatch of one request is refused."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    d = router.route(req("r1"))
    assert d.accepted and d.avg_watts > 0
    # routed but not dispatched: complete is a no-op
    assert not router.complete(d)
    assert router.fleet_draw_w == 0.0 and gpu.in_flight == 0
    router.dispatch(d)
    assert gpu.in_flight == 1
    assert router.fleet_draw_w == pytest.approx(d.avg_watts)
    with pytest.raises(ValueError):
        router.dispatch(d)                           # double dispatch
    assert router.complete(d)                        # the one real release
    assert gpu.in_flight == 0 and router.fleet_draw_w == 0.0
    assert not router.complete(d)                    # double complete
    assert not router.complete(d)
    assert gpu.in_flight == 0 and router.fleet_draw_w == 0.0
    # a rejected decision never touches the ledger
    rejected = router.route(req("slo", deadline_s=1e-12))
    assert not rejected.accepted
    assert not router.complete(rejected)
    assert router.fleet_draw_w == 0.0


def test_removed_endpoint_ledger_entries_stay_completable():
    """Satellite pin (dangling-ledger fix): removing an endpoint with
    requests in flight must keep their ledger entries completable — draw
    and slots release on ``complete`` exactly as if it were live, never
    orphaned — and the draw entry drops only once fully drained."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    d1, d2 = router.route(req("r1")), None
    router.dispatch(d1)
    d2 = router.route(req("r2"))
    router.dispatch(d2)
    assert d1.endpoint.name == d2.endpoint.name == "gpu0"
    draw_full = router.fleet_draw_w
    assert draw_full == pytest.approx(d1.avg_watts + d2.avg_watts)
    router.remove_endpoint("gpu0")
    assert router.endpoint("gpu0") is None       # out of routing
    assert router.route(req("r3")).endpoint.name == "mc0"
    assert router.in_flight_of("gpu0") == 2      # ledger survives removal
    assert router.fleet_draw_w == pytest.approx(draw_full)
    assert router.complete(d1)                   # completable, not orphaned
    assert router.fleet_draw_w == pytest.approx(d2.avg_watts)
    assert not router.drained("gpu0")
    assert router.complete(d2)
    assert router.drained("gpu0")
    assert router.fleet_draw_w == 0.0            # books fully closed
    assert not router.complete(d1)               # idempotent after removal
    # re-admission after a full drain is legal again
    router.add_endpoint(Endpoint(name="gpu0", backend=GPU, arch=cfg.name,
                                 n_slots=2, cache_len=64, cfg=cfg))
    assert router.route(req("r4")).endpoint.name == "gpu0"


def test_drain_stops_dispatch_but_in_flight_completes():
    """Satellite pin: drain is the migration primitive — no new
    dispatches, in-flight requests keep their slots, removal only after
    ``drained`` reports the ledger empty."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    d = router.route(req("r1"))
    router.dispatch(d)
    assert d.endpoint.name == "gpu0"
    router.drain("gpu0")
    assert router.route(req("r2")).endpoint.name == "mc0"
    assert not router.drained("gpu0")
    assert router.complete(d, latency_s=0.01)
    assert router.drained("gpu0") and gpu.in_flight == 0
    with pytest.raises(ValueError):
        router.drain("nope")


def test_quarantine_with_in_flight_requests_drains_cleanly():
    """Quarantine mid-flight: no new dispatches, but the admitted request
    still completes through the ledger and feeds the health machine."""
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    d = router.route(req("r1"))
    router.dispatch(d)
    router.health["gpu0"].quarantine("operator")
    assert router.route(req("r2")).endpoint.name == "mc0"
    assert router.complete(d, latency_s=0.01)
    assert router.fleet_draw_w == 0.0 and gpu.in_flight == 0


def test_failure_reports_open_the_circuit_and_requests_shift():
    """Router-level circuit breaking: consecutive ``fail`` reports
    quarantine the endpoint; traffic shifts to the survivor and the
    refusal reason is specific once nothing is left."""
    from repro_torch.serve import HealthConfig
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled",
                    health_cfg=HealthConfig(error_threshold=2))
    for _ in range(2):
        d = router.route(req("r"))
        assert d.endpoint.name == "gpu0"
        router.dispatch(d)
        assert router.fail(d, reason="endpoint died")
    assert router.health["gpu0"].state == "quarantined"
    d = router.route(req("shift"))
    assert d.accepted and d.endpoint.name == "mc0"
    router.health["mc0"].quarantine("chaos")
    refused = router.route(req("none"))
    assert not refused.accepted
    assert refused.reason == "endpoint quarantined"


def test_incorrect_record_backend_is_never_dispatched_to():
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg)
    warm(lk, gpu, mc)
    lk.register_failure(gpu.lookup_key(), "wrong result")
    router = Router([gpu, mc], lk, policy="modeled")
    for i in range(20):
        d = router.route(req(f"q{i}"))
        assert d.accepted and d.endpoint.name == "mc0"
    lk.register_failure(mc.lookup_key(), "wrong result")
    d = router.route(req("last"))
    assert not d.accepted and d.reason == "no feasible endpoint"


def test_static_lint_prunes_endpoint_before_scoring():
    """The prune-before-trace contract at serve time: a request the endpoint's cache cannot
    host is pruned by arithmetic (stats.static_pruned), not discovered by
    a failed prefill."""
    cfg = get_config(ARCH).reduced()             # full attention
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg, cache_len=64)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    pruned0 = lk.stats.static_pruned
    d = router.route(req("big", prompt_len=60, max_gen=20))
    assert not d.accepted and d.reason == "no feasible endpoint"
    assert lk.stats.static_pruned == pruned0 + 2
    assert router.route(req("ok")).accepted      # small requests unaffected


def test_slo_deadline_and_slot_fallthrough():
    cfg = get_config(ARCH).reduced()
    lk = PlanLookup()
    gpu, mc = make_endpoints(cfg, n_slots=1)
    warm(lk, gpu, mc)
    router = Router([gpu, mc], lk, policy="modeled")
    # impossible SLO: rejected up front
    d = router.route(req("slo", deadline_s=1e-12))
    assert not d.accepted and d.reason == "SLO infeasible"
    # best endpoint full: ranked fallthrough to the next one
    d1 = router.route(req("a"))
    assert d1.endpoint.name == "gpu0"
    router.dispatch(d1)
    d2 = router.route(req("b"))
    assert d2.accepted and d2.endpoint.name == "mc0"
    router.dispatch(d2)
    d3 = router.route(req("c"))
    assert not d3.accepted and d3.reason == "all slots busy"


def test_planner_publish_feeds_router_end_to_end():
    """plan_offload(publish=...) warms the lookup the router consumes: the
    offline search is the write side, routing is the read side."""
    from repro_torch.apps import APPS
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.measure import TimedRunner
    from repro_torch.core.planner import UserTarget, plan_offload

    app = APPS["tdFIR"]()
    inputs = app.make_inputs(0, small=True, device="cpu")
    lk = PlanLookup()
    report = plan_offload(app, UserTarget(), inputs=inputs,
                          runner=TimedRunner(repeats=1),
                          ga_cfg=GAConfig(population=3, generations=3,
                                          seed=0),
                          publish=lk, device="cpu")
    assert report.selected is not None
    warm_dests = [r.destination for r in report.records
                  if lk.score(serve_key(r.destination, app.name))
                  is not None]
    assert warm_dests                            # something is serveable
    # and scoring them is trace-free from here on
    misses0 = lk.stats.misses
    for dest in warm_dests:
        ev = lk.score(serve_key(dest, app.name))
        assert ev.correct and ev.time_s > 0
    assert lk.stats.misses == misses0


# ------------------------------------------------ parity with the JAX package
def router_trace(pkg):
    """One router trace in ``pkg``: two endpoints over reduced granite
    (linted per request), payloads at the package's own peaks, 40 ticks of
    traffic with an oversized request every 7 ticks (lint-pruned), an
    impossible SLO every 9, and gpu0 failing every request it is handed on
    ticks 10-15 — its circuit opens, backs off, probes and closes."""
    obs = pkg_mod(pkg, "obs")
    serve = pkg_mod(pkg, "serve")
    pl = pkg_mod(pkg, "core.plan_lookup")
    builtin = pkg_mod(pkg, "backends.builtin")
    cfg = pkg_mod(pkg, "configs").get_config(ARCH).reduced()
    gpu = serve.Endpoint(name="gpu0", backend=builtin.GPU, arch=cfg.name,
                         n_slots=2, cache_len=64, cfg=cfg)
    mc = serve.Endpoint(name="mc0", backend=builtin.MANY_CORE, arch=cfg.name,
                        n_slots=2, cache_len=64, cfg=cfg)
    lk = pl.PlanLookup()
    lk.register(gpu.lookup_key(), payload(pkg, 1e-4, 2e-5))
    lk.register(mc.lookup_key(), payload(pkg, 5e-4, 2e-5))
    misses0 = lk.stats.misses
    tracer = obs.Tracer()
    decisions = []
    with obs.use_tracer(tracer):
        router = serve.Router(
            [gpu, mc], lk, policy="modeled",
            health_cfg=serve.HealthConfig(error_threshold=2, backoff_ticks=3,
                                          probe_quota=1, probe_successes=1))
        inflight = []
        for tick in range(40):
            now = tick * 0.01
            tracer.set_time(now)
            for h in router.health.values():
                h.on_tick(tick)
            for d in inflight:
                if d.endpoint.name == "gpu0" and 10 <= tick < 16:
                    router.fail(d, reason="endpoint died", now_s=now)
                else:
                    router.complete(d, latency_s=d.service_time_s,
                                    now_s=now)
            inflight = []
            reqs = [serve.Request(rid=f"r{tick:02d}", arch=ARCH,
                                  prompt_len=8, max_gen=4, arrival_s=now)]
            if tick % 7 == 3:
                reqs.append(serve.Request(rid=f"big{tick:02d}", arch=ARCH,
                                          prompt_len=60, max_gen=20,
                                          arrival_s=now))
            if tick % 9 == 4:
                reqs.append(serve.Request(rid=f"slo{tick:02d}", arch=ARCH,
                                          prompt_len=8, max_gen=4,
                                          arrival_s=now, deadline_s=1e-12))
            for r in reqs:
                d = router.route(r)
                decisions.append({
                    "rid": d.rid, "reason": d.reason,
                    "endpoint": d.endpoint.name if d.accepted else None,
                    "service_time_s": d.service_time_s,
                    "energy_j": d.energy_j, "avg_watts": d.avg_watts,
                    "considered": d.considered})
                if d.accepted:
                    router.dispatch(d)
                    inflight.append(d)
    return {"decisions": decisions, "router": router, "lookup": lk,
            "misses0": misses0, "records": tracer.records}


def test_router_trace_with_quarantine_and_probe_equals_the_jax_packages():
    ref = router_trace("repro")
    with ops.no_device_work():
        ours = router_trace("repro_torch")
    assert_same_records(ref["decisions"], ours["decisions"], path="routes")
    for name in ("gpu0", "mc0"):
        assert ours["router"].health[name].transitions == \
            ref["router"].health[name].transitions
    seq = [(t["from"], t["to"])
           for t in ours["router"].health["gpu0"].transitions]
    assert ("healthy", "quarantined") in seq
    assert ("quarantined", "probing") in seq
    assert seq[-1] == ("probing", "healthy")
    reasons = {d["reason"] for d in ours["decisions"]}
    assert {"ok", "no feasible endpoint", "SLO infeasible"} <= reasons
    assert ours["lookup"].stats.static_pruned == \
        ref["lookup"].stats.static_pruned > 0
    assert ours["lookup"].stats.misses == ours["misses0"]   # zero traces
    assert_same_records(ref["router"].metrics.summary(),
                        ours["router"].metrics.summary(), path="metrics")
    assert_same_records(ref["records"], ours["records"])
