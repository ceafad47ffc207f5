"""repro_torch.obs (the reference's tests/test_obs.py run on the port):
tracer null-object contract, span nesting, deterministic
exporters, the metrics registry's consolidated snapshot, the post-mortem
report sections, and the ceil-based nearest-rank percentile fix.

The tier-1 pins here are behavioral, not cosmetic: the ambient tracer
must default to a no-op (instrumented call sites run in every existing
test with zero behavior change), a pinned-clock trace must serialize
byte-identically, and the Chrome export must be loadable trace-event
JSON (ph X/i/M, one lane per track).
"""
import json

import pytest

from repro_torch import obs
from repro_torch.obs import (NULL_SPAN, NULL_TRACER, MetricsRegistry, Tracer,
                             chrome_trace, get_tracer, jsonl_line, set_tracer,
                             text_summary, use_tracer)
from repro_torch.obs.report import render


# ------------------------------------------------------- null-object tracer
def test_ambient_tracer_defaults_to_null():
    assert get_tracer() is NULL_TRACER
    assert not get_tracer().enabled


def test_null_tracer_is_a_complete_noop():
    tr = NULL_TRACER
    with tr.span("x", cat="c", track="t", foo=1) as sp:
        assert sp is NULL_SPAN
        assert sp.set(bar=2) is sp          # chainable, records nothing
    assert tr.complete_span("x", 0.0, 1.0) is None
    assert tr.event("x") is None
    tr.set_time(3.0)
    tr.clear_time()                          # all accepted, all ignored


def test_null_span_swallows_nothing():
    # exceptions still propagate through the disabled context manager
    with pytest.raises(RuntimeError):
        with NULL_TRACER.span("x"):
            raise RuntimeError("boom")


def test_use_tracer_scopes_and_restores():
    tr = Tracer()
    assert get_tracer() is NULL_TRACER
    with use_tracer(tr):
        assert get_tracer() is tr
        with use_tracer(None):               # None = explicitly disabled
            assert get_tracer() is NULL_TRACER
        assert get_tracer() is tr
    assert get_tracer() is NULL_TRACER


def test_set_tracer_none_restores_null():
    tr = Tracer()
    assert set_tracer(tr) is tr
    assert get_tracer() is tr
    assert set_tracer(None) is NULL_TRACER
    assert get_tracer() is NULL_TRACER


# ------------------------------------------------------------ span recording
def test_spans_nest_and_record_parents():
    tr = Tracer(clock=lambda: 0.0)
    with tr.span("outer", cat="a") as outer:
        with tr.span("inner", cat="a") as inner:
            inner.set(k=1)
        outer.set(done=True)
    # completion order: inner first
    names = [r["name"] for r in tr.records]
    assert names == ["inner", "outer"]
    inner_r, outer_r = tr.records
    assert inner_r["parent"] == outer_r["id"]
    assert outer_r["parent"] is None
    assert inner_r["attrs"] == {"k": 1}
    assert outer_r["attrs"] == {"done": True}


def test_span_records_exactly_once():
    tr = Tracer(clock=lambda: 0.0)
    sp = tr.span("x")
    sp.finish()
    sp.finish()                              # idempotent
    assert len(tr.records) == 1


def test_span_exception_lands_in_attrs_and_propagates():
    tr = Tracer(clock=lambda: 0.0)
    with pytest.raises(ValueError):
        with tr.span("x"):
            raise ValueError("bad gene")
    assert len(tr.records) == 1
    assert "bad gene" in tr.records[0]["attrs"]["error"]


def test_set_time_pins_the_clock():
    ticks = iter([1.0, 2.0, 3.0])
    tr = Tracer(clock=lambda: next(ticks))
    tr.set_time(0.25)
    ev = tr.event("e")
    with tr.span("s") as sp:
        pass
    assert ev["t"] == 0.25
    assert (tr.records[-1]["t0"], tr.records[-1]["t1"]) == (0.25, 0.25)
    tr.clear_time()
    assert tr.event("e2")["t"] == 1.0        # back on the supplied clock


def test_complete_span_uses_explicit_window():
    tr = Tracer()
    rec = tr.complete_span("request", 0.10, 0.35, cat="serve",
                           track="endpoint:hot0", rid="r1", ok=True)
    assert rec["t0"] == 0.10 and rec["t1"] == 0.35
    assert rec["parent"] is None
    assert tr.records == [rec]


def test_attrs_are_clamped_to_json():
    tr = Tracer(clock=lambda: 0.0)
    tr.event("e", weird=object(), nested={"k": (1, 2)})
    attrs = tr.records[0]["attrs"]
    json.dumps(attrs)                        # round-trips
    assert attrs["nested"] == {"k": [1, 2]}
    assert isinstance(attrs["weird"], str)


# ---------------------------------------------------------------- exporters
def make_records():
    tr = Tracer(clock=lambda: 0.0)
    tr.set_time(0.0)
    with tr.span("verify", cat="plan", track="backend:hot", backend="hot"):
        pass
    tr.set_time(0.01)
    tr.event("tick", cat="loop", track="loop", tick=1)
    tr.complete_span("request", 0.0, 0.01, cat="serve",
                     track="endpoint:hot0", ok=True)
    return tr.records


def test_jsonl_lines_are_byte_stable():
    a = [jsonl_line(r) for r in make_records()]
    b = [jsonl_line(r) for r in make_records()]
    assert a == b
    for line in a:
        rec = json.loads(line)
        assert rec["type"] in ("span", "event")
        assert line == jsonl_line(rec)       # canonical re-encode


def test_jsonl_roundtrip_through_files(tmp_path):
    recs = make_records()
    p = obs.write_jsonl(recs, tmp_path / "events.jsonl")
    assert obs.read_jsonl(p) == recs


def test_chrome_trace_is_perfetto_shaped():
    trace = chrome_trace(make_records())
    evs = trace["traceEvents"]
    phases = {e["ph"] for e in evs}
    assert phases == {"M", "X", "i"}
    # one thread_name metadata row per distinct track, names preserved
    meta = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert meta == {"backend:hot", "loop", "endpoint:hot0"}
    # µs timestamps: the 0.01 s request span is 10_000 µs long
    req = next(e for e in evs if e["ph"] == "X" and e["name"] == "request")
    assert req["ts"] == 0.0 and req["dur"] == pytest.approx(10_000.0)
    inst = next(e for e in evs if e["ph"] == "i")
    assert inst["s"] == "t" and inst["ts"] == pytest.approx(10_000.0)
    json.dumps(trace)                        # loadable JSON


def test_text_summary_counts_spans_and_events():
    s = text_summary(make_records())
    assert "2 spans, 1 events" in s
    assert "plan/verify" in s and "loop/tick" in s


# ---------------------------------------------------------- metrics registry
def test_registry_instruments_are_get_or_create():
    reg = MetricsRegistry()
    assert reg.counter("a") is reg.counter("a")
    assert reg.gauge("g") is reg.gauge("g")
    assert reg.histogram("h") is reg.histogram("h")
    reg.counter("a").inc(2)
    reg.gauge("g").set(7.5)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.histogram("h").observe(v)
    snap = reg.snapshot()
    assert snap["counters"]["a"] == 2.0
    assert snap["gauges"]["g"] == 7.5
    h = snap["histograms"]["h"]
    assert h["count"] == 4 and h["mean"] == 2.5
    assert h["min"] == 1.0 and h["max"] == 4.0
    assert h["p50"] == 2.0                   # ceil nearest-rank
    with pytest.raises(ValueError):
        reg.counter("a").inc(-1)


def test_registry_consolidates_existing_faces():
    from repro_torch.core.search_cache import SearchCache
    from repro_torch.serve.health import EndpointHealth, HealthConfig
    from repro_torch.serve.metrics import ServeMetrics

    reg = MetricsRegistry()
    cache = SearchCache()
    cache.stats.candidates = 3
    reg.attach_cache_stats("search", cache.stats)
    reg.attach_serve_metrics("serve", ServeMetrics())
    h = EndpointHealth("ep0", HealthConfig(error_threshold=1))
    h.observe_error("died")
    reg.attach_health("health", {"ep0": h})
    snap = reg.snapshot()["collected"]
    assert snap["search"]["candidates"] == 3
    assert snap["serve"]["completed"] == 0
    assert snap["health"]["ep0"]["state"] == "quarantined"
    assert snap["health"]["ep0"]["transitions"] == 1
    # and the public faces are untouched
    assert cache.stats.to_dict()["candidates"] == 3
    assert h.transitions[0]["observed"]["consecutive_errors"] == 1


def test_registry_dead_collector_cannot_sink_snapshot():
    reg = MetricsRegistry()
    reg.register_collector("ok", lambda: 1)
    reg.register_collector("dead", lambda: 1 / 0)
    snap = reg.snapshot()["collected"]
    assert snap["ok"] == 1
    assert "ZeroDivisionError" in snap["dead"]["error"]


# ------------------------------------------------------------------- report
def test_report_sections_render_from_a_trace(tmp_path):
    tr = Tracer()
    tr.set_time(0.0)
    with tr.span("verify", cat="plan", track="backend:hot", backend="hot",
                 compile_s=1.5, cache_hit=False, correct=True,
                 best_time_s=0.005) as sp:
        pass
    with tr.span("route", cat="serve", track="router") as sp:
        sp.set(reason="ok", explain=[
            {"endpoint": "hot0", "verdict": "chosen"},
            {"endpoint": "cool0", "verdict": "over-budget"}])
    tr.event("transition", cat="health", track="endpoint:hot0",
             endpoint="hot0", **{"from": "healthy", "to": "quarantined"},
             reason="died", observed={"errors": 1})
    for tick, (lk, hit) in enumerate([(10, 5), (20, 15)]):
        tr.set_time(tick * 0.01)
        tr.event("tick", cat="loop", track="loop", tick=tick, completed=tick,
                 lookups=lk, lookup_hits=hit, energy_j=1.0 * tick,
                 draw_w=30.0)
    out = render(tr.records)
    assert "hot" in out and "verification times per backend" in out
    assert "chosen x1" in out and "over-budget x1" in out
    assert "healthy -> quarantined" in out and "errors=1" in out
    assert "trends over the run" in out
    # the CLI renders the same text from the archived JSONL
    from repro_torch.obs.report import main
    p = obs.write_jsonl(tr.records, tmp_path / "events.jsonl")
    assert main([p, "--section", "health"]) == 0


def test_report_sections_degrade_gracefully_when_empty():
    out = render([], sections=["routing", "verification", "health",
                               "trends"])
    assert "no route spans" in out and "no plan/verify spans" in out
    assert "no transitions" in out and "no loop/tick events" in out


# ------------------------------------- percentile (ceil-based nearest-rank)
def test_percentile_is_ceil_based_nearest_rank():
    from repro_torch.serve.metrics import percentile
    # the old implementation used round() (banker's rounding): p50 of four
    # values picked index round(2.0)-1 via round-half-even surprises; the
    # nearest-rank definition is ceil(p/100 * n)
    assert percentile([1, 2, 3, 4], 50) == 2
    assert percentile([10, 20], 50) == 10
    assert percentile([1, 2, 3], 25) == 1
    assert percentile([1, 2, 3], 100) == 3
    assert percentile([1, 2, 3], 0) == 1
    assert percentile([5], 95) == 5
    assert percentile([], 50) is None
    assert percentile([3, 1, 2], 66.7) == 3  # sorts first; rank ceil(2.0)=3
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile(xs, 95.1) == 96


def test_obs_package_never_imports_jax():
    import subprocess
    import sys
    code = ("import sys; import repro_torch.obs, repro_torch.obs.report; "
            "leaked = [m for m in ('jax', 'torch', 'numpy') "
            "if m in sys.modules]; "
            "assert not leaked, f'repro_torch.obs pulled in {leaked}'")
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
