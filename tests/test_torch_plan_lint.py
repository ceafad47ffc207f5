"""The static plan lint and the small pure pieces around the router
(``repro_torch.analysis``, ``dist/schedules.py``, the straggler watchdog,
the library backend and the fleet's power sums), run on the port: the
reference's tests/test_analysis.py findings and P001–P019 cases,
tests/test_runtime_fault_tolerance.py's watchdog, tests/test_schedules.py's
pure cases and tests/test_power.py's library-backend and fleet-draw cases;
then the lint against the JAX package's on every config.

The lint's one constant that differs by design is the device memory: the
port's default is the H100's 80 GiB, the reference's a TPU chip's 16 GiB.
Tests of a reference fact about 16 GiB pass it in as ``TPU_CHIP_BYTES``.
"""
import dataclasses
import importlib
import json

import pytest

from repro_torch.analysis import (DEVICE_MEMORY_BYTES, Finding, has_errors,
                                  lint_plan, max_severity, sort_findings)
from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import cost_model
from repro_torch.core.ga import Evaluation, GAConfig, run_ga
from repro_torch.dist.plan import NAMED_PLANS, PLAN_CONTEXTS, Plan
from repro_torch.dist.schedules import (SCHEDULES, Schedule, get_schedule,
                                        register_schedule)
from repro_torch.runtime.fault_tolerance import StragglerWatchdog

GiB = 1024 ** 3
TPU_CHIP_BYTES = 16 * GiB          # the reference's DEVICE_MEMORY_BYTES
SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
# the reference's repro.analysis.lint.PRODUCTION_MESHES
PRODUCTION_MESHES = {"single": SINGLE, "multi": MULTI}
TRAIN = get_shape("train_4k")
DECODE = get_shape("decode_32k")


def rules(findings, rule_id):
    return [f for f in findings if f.rule_id == rule_id]


# ------------------------------------------------------------- findings API
def test_finding_severity_ordering_and_json():
    fs = [Finding("P999", "info", "i"), Finding("P998", "error", "e"),
          Finding("P997", "warning", "w")]
    assert [f.severity for f in sort_findings(fs)] == \
        ["error", "warning", "info"]
    assert has_errors(fs) and max_severity(fs) == "error"
    assert max_severity([]) is None
    d = Finding("P001", "error", "m", plan_field="remat", subject="p",
                context={"x": 1}).to_dict()
    assert d == {"rule_id": "P001", "severity": "error", "message": "m",
                 "plan_field": "remat", "subject": "p", "context": {"x": 1}}
    json.dumps(d)                              # JSON-clean by construction


# --------------------------------------------------------------- plan lint
def test_default_plan_lints_clean_on_train_cell():
    cfg = get_config("granite-3-2b")
    out = lint_plan(Plan(), mesh=SINGLE, cfg=cfg, shape=TRAIN)
    assert not has_errors(out)
    assert not any(f.severity == "warning" for f in out)


def test_p001_nonpositive_gene_short_circuits():
    import dataclasses
    bad = dataclasses.replace(Plan(), microbatches=0, vocab_chunk=-1)
    out = lint_plan(bad, mesh=SINGLE, cfg=get_config("granite-3-2b"),
                    shape=TRAIN)
    assert out and all(f.rule_id == "P001" for f in out)
    assert {f.plan_field for f in out} == {"microbatches", "vocab_chunk"}


def test_p002_microbatch_divisibility_is_an_error_on_train_only():
    import dataclasses
    plan = dataclasses.replace(Plan(), microbatches=3)   # 256 % 3 != 0
    out = lint_plan(plan, shape=TRAIN)
    assert [f.severity for f in rules(out, "P002")] == ["error"]
    # same plan on a decode shape: the gene is inert, not fatal
    out = lint_plan(plan, shape=DECODE)
    assert not rules(out, "P002") and not has_errors(out)
    assert any(f.plan_field == "microbatches" for f in rules(out, "P103"))
    # a dividing microbatch count is silent
    ok = dataclasses.replace(Plan(), microbatches=4)
    assert not rules(lint_plan(ok, shape=TRAIN), "P002")


def test_p003_unknown_schedule_severity_follows_pipelined():
    import dataclasses
    plan = dataclasses.replace(Plan(), pipeline_schedule="zb-h1")
    assert [f.severity for f in rules(lint_plan(plan), "P003")] \
        == ["warning"]
    out = lint_plan(plan, mesh=MULTI, pipelined=True)
    assert [f.severity for f in rules(out, "P003")] == ["error"]
    assert has_errors(out)


def test_p004_unhostable_registered_schedule():
    from repro_torch.dist import schedules as sch

    class NeverHosts(sch.Schedule):
        name = "never-hosts"

        def build(self, **kw):
            return None

    sch.register_schedule(NeverHosts())
    try:
        import dataclasses
        plan = dataclasses.replace(Plan(), pipeline_schedule="never-hosts")
        out = lint_plan(plan, mesh=MULTI, pipelined=True)
        assert [f.severity for f in rules(out, "P004")] == ["error"]
        assert not rules(out, "P003")          # registered, so not unknown
    finally:
        del sch.SCHEDULES["never-hosts"]


def test_p005_p006_p007_pipeline_shape_notes():
    import dataclasses
    plan = dataclasses.replace(Plan(), virtual_stages=2)   # gpipe ignores it
    out = lint_plan(plan, mesh=SINGLE, pipelined=True)
    assert rules(out, "P006") and rules(out, "P005")
    # pod axis present, microbatches < ranks: bubble note with the fraction
    plan = dataclasses.replace(Plan(), microbatches=1)
    out = lint_plan(plan, mesh=MULTI, shape=TRAIN, pipelined=True)
    (f,) = rules(out, "P007")
    assert f.context["bubble_fraction"] > 0
    assert not has_errors(out)


def test_p008_state_floor_overflows_a_single_device():
    # by design: the reference's device is a 16 GiB TPU chip; granite's
    # ~35 GB training floor fits the H100's 80 GiB, so the overflow is
    # pinned at the reference's capacity, passed in explicitly
    cfg = get_config("granite-3-2b")        # ~2.5B params
    out = lint_plan(Plan(), mesh={"data": 1}, cfg=cfg, shape=TRAIN,
                    device_memory_bytes=TPU_CHIP_BYTES)
    (f,) = rules(out, "P008")
    assert f.severity == "error"
    assert f.context["state_bytes"] > f.context["capacity_bytes"]
    # the production mesh holds it with room to spare
    assert not rules(lint_plan(Plan(), mesh=SINGLE, cfg=cfg, shape=TRAIN),
                     "P008")
    # a raised per-device capacity clears the same cell
    assert not rules(lint_plan(Plan(), mesh={"data": 1}, cfg=cfg,
                               shape=TRAIN,
                               device_memory_bytes=64 * TPU_CHIP_BYTES),
                     "P008")
    # and the H100 default holds it on one card
    assert not rules(lint_plan(Plan(), mesh={"data": 1}, cfg=cfg,
                               shape=TRAIN), "P008")


def test_p009_vocab_chunk_silent_disable():
    import dataclasses
    shape = ShapeConfig("t", seq_len=1000, global_batch=8, kind="train")
    plan = dataclasses.replace(Plan(), vocab_chunk=512)   # 1000 % 512 != 0
    assert [f.severity for f in rules(lint_plan(plan, shape=shape), "P009")] \
        == ["warning"]
    assert not rules(lint_plan(plan, shape=TRAIN), "P009")  # 4096 % 512 == 0


def test_p010_batch_prefix_sharding():
    shape = ShapeConfig("t", 128, 6, "train")       # 6 % 16 != 0
    out = lint_plan(Plan(), mesh=SINGLE, shape=shape)
    assert [f.severity for f in rules(out, "P010")] == ["warning"]
    # partial prefix: 2 % pod(2) == 0 but 2 % (pod*data) != 0 -> info
    shape = ShapeConfig("t", 128, 2, "train")
    assert [f.severity
            for f in rules(lint_plan(Plan(), mesh=MULTI, shape=shape),
                           "P010")] == ["info"]
    # full prefix and singleton batch are both silent
    assert not rules(lint_plan(Plan(), mesh=MULTI, shape=TRAIN), "P010")
    one = ShapeConfig("t", 128, 1, "decode")
    assert not rules(lint_plan(Plan(), mesh=SINGLE, shape=one), "P010")


def test_p012_decode_kv_shard_replication():
    import dataclasses
    plan = dataclasses.replace(Plan(), decode_kv_seq_shard=True)
    shape = ShapeConfig("d", 1000, 8, "decode")     # 1000 % 16 != 0
    assert rules(lint_plan(plan, mesh=SINGLE, shape=shape), "P012")
    assert not rules(lint_plan(plan, mesh=SINGLE, shape=DECODE), "P012")
    # inert on train: P013 note instead
    assert rules(lint_plan(plan, mesh=SINGLE, shape=TRAIN), "P013")


def test_p018_serve_request_overflows_full_attention_cache():
    """Serving context: a request whose prompt+gen exceed cache_len is a
    static error on a full-attention arch (the router prunes the endpoint
    before scoring) and an info note on a sub-quadratic one (window rings
    wrap by design)."""
    full = get_config("granite-3-2b").reduced()          # attn_kind=full
    swa = get_config("h2o-danube-1.8b").reduced()        # attn_kind=swa
    serve = {"n_slots": 2, "cache_len": 64, "prompt_len": 60, "max_gen": 20}
    out = lint_plan(Plan(), cfg=full, serve=serve)
    assert rules(out, "P018") and has_errors(out)
    out = lint_plan(Plan(), cfg=swa, serve=serve)
    assert not has_errors(out)
    assert rules(out, "P104")
    # a fitting request lints clean on both
    ok = {"n_slots": 2, "cache_len": 64, "prompt_len": 8, "max_gen": 8}
    assert not lint_plan(Plan(), cfg=full, serve=ok)


def test_p019_slot_pool_exceeds_capacity_and_quant_hint():
    """A slot pool the endpoint's memory provably cannot host is a static
    error; when int8 KV would fit, the P104 hint names kv_cache_quant."""
    import dataclasses
    cfg = get_config("granite-3-2b")                     # full-size params
    serve = {"n_slots": 64, "cache_len": 131072,
             "prompt_len": 8, "max_gen": 8}
    # 1-device endpoint: pool + params blow straight past 80 GiB
    out = lint_plan(Plan(), cfg=cfg, serve=serve)
    p19 = rules(out, "P019")
    assert p19 and has_errors(out)
    # with quant requested the pool halves; whether or not it then fits,
    # the unquantized lint must carry the hint exactly when quant rescues
    hints = rules(out, "P104")
    quant_out = lint_plan(dataclasses.replace(Plan(), kv_cache_quant=True),
                          cfg=cfg, serve=serve)
    if not rules(quant_out, "P019"):
        assert hints, "quant rescues the pool but no P104 hint was raised"
    # a small pool on a big endpoint lints clean
    small = {"n_slots": 2, "cache_len": 256, "prompt_len": 8, "max_gen": 8}
    assert not rules(lint_plan(Plan(), mesh={"data": 64}, cfg=cfg,
                               serve=small), "P019")


def test_serve_lint_accepts_endpoint_like_objects():
    """The serve context duck-types: the router passes dicts, but any
    object with the four fields works."""
    class Ep:
        n_slots, cache_len, prompt_len, max_gen = 2, 32, 30, 30
    out = lint_plan(Plan(), cfg=get_config("granite-3-2b").reduced(),
                    serve=Ep())
    assert rules(out, "P018")


def test_named_plans_lint_clean_on_documented_contexts():
    """Every named plan on its documented mesh and
    shapes carries no error- or warning-severity findings."""
    from repro_torch.configs import ARCHS, cell_runnable

    for name, plan in NAMED_PLANS.items():
        ctx = PLAN_CONTEXTS[name]
        mesh = PRODUCTION_MESHES[ctx["mesh"]]
        for arch in ARCHS:
            cfg = get_config(arch)
            for shape_name in ctx["shapes"]:
                shape = get_shape(shape_name)
                if not cell_runnable(cfg, shape):
                    continue
                out = lint_plan(plan, mesh=mesh, cfg=cfg, shape=shape)
                bad = [f for f in out if f.severity != "info"]
                assert not bad, (name, arch, shape_name,
                                 [f.to_dict() for f in bad])



# ------------------------------------------------------------- watchdog
def test_watchdog_needs_ten_samples_before_flagging():
    wd = StragglerWatchdog(window=50, threshold=3.0)
    for i in range(9):
        assert not wd.record(i, 1.0)
    # the 10th sample can flag — a 100x outlier against 9 stable steps
    assert wd.record(9, 100.0)
    assert wd.flagged[0]["step"] == 9
    assert wd.flagged[0]["mean"] == pytest.approx(1.0)


def test_watchdog_compares_against_previous_window_not_itself():
    """The outlier is judged against times[:-1]: a big dt must not dilute
    the statistics it is being compared to."""
    wd = StragglerWatchdog()
    for i in range(20):
        wd.record(i, 1.0)
    assert wd.record(20, 2.0)            # zero variance window: any jump
    assert wd.flagged[-1]["std"] == pytest.approx(1e-9)


def test_watchdog_window_evicts_old_samples():
    wd = StragglerWatchdog(window=10, threshold=3.0)
    for i in range(10):
        wd.record(i, 10.0)               # old regime: slow steps
    for i in range(10, 20):
        wd.record(i, 1.0)                # new regime fills the window
    assert len(wd.times) == 10
    assert all(t == 1.0 for t in wd.times)
    # 10.0 was normal under the old regime; after eviction it's an outlier
    assert wd.record(20, 10.0)


def test_watchdog_ewma_tracks_recent_steps():
    wd = StragglerWatchdog(ewma_alpha=0.5)
    wd.record(0, 1.0)
    assert wd.ewma == pytest.approx(1.0)  # first sample seeds the EWMA
    wd.record(1, 3.0)
    assert wd.ewma == pytest.approx(2.0)
    wd.record(2, 2.0)
    assert wd.ewma == pytest.approx(2.0)


def test_watchdog_window_is_a_bounded_deque():
    """Satellite pin: the window is a deque(maxlen=window) — recording
    beyond the window evicts from the left in O(1), never grows, and the
    bound holds under heavy sustained load."""
    from collections import deque
    wd = StragglerWatchdog(window=8)
    assert isinstance(wd.times, deque) and wd.times.maxlen == 8
    for i in range(1000):
        wd.record(i, 1.0 + (i % 5) * 1e-3)
    assert len(wd.times) == 8
    assert list(wd.times) == [1.0 + (i % 5) * 1e-3 for i in range(992, 1000)]


def test_watchdog_reset_gives_a_fresh_window():
    """After an endpoint recovers, its health machine calls reset(): the
    old (faulted) samples and EWMA must not poison the fresh regime."""
    wd = StragglerWatchdog(window=10, ewma_alpha=0.5)
    for i in range(10):
        wd.record(i, 10.0)               # the faulted regime
    assert wd.ewma is not None and len(wd.times) == 10
    wd.reset()
    assert len(wd.times) == 0 and wd.ewma is None
    assert wd.times.maxlen == 10         # the bound survives the reset
    # the fresh regime seeds cleanly: 1.0 is not an outlier now
    assert not wd.record(100, 1.0)
    assert wd.ewma == pytest.approx(1.0)
    # flag history is intentionally kept (it is the incident log)
    for i in range(101, 111):
        wd.record(i, 1.0)
    assert not wd.flagged


def test_watchdog_steady_steps_never_flag():
    wd = StragglerWatchdog(window=20, threshold=3.0)
    flagged = [wd.record(i, 1.0 + 0.001 * (i % 3)) for i in range(100)]
    assert not any(flagged)


# ---------------------------------------------------------------- structure
def test_gpipe_plan_shape():
    plan = SCHEDULES["gpipe"].build(n_stages=4, n_ranks=4, microbatches=8)
    assert plan is not None
    assert plan.total_ticks == 8 + 4 - 1
    assert plan.busy_ticks == 8
    assert plan.bubble_ticks == 3
    assert plan.in_flight == 8                      # all m held to backward
    # drain ticks feed nothing (the mb[m-1] re-feed bug)
    for t in range(8, plan.total_ticks):
        assert plan.ticks[t].feed_mb == -1
        assert plan.ticks[t].feed_buf == -1


def test_one_f_one_b_caps_in_flight():
    g = SCHEDULES["gpipe"].build(n_stages=4, n_ranks=4, microbatches=16)
    f = SCHEDULES["one_f_one_b"].build(n_stages=4, n_ranks=4,
                                       microbatches=16)
    # identical forward tick order; the cap is what changes
    assert [t.feed_mb for t in f.ticks] == [t.feed_mb for t in g.ticks]
    assert [t.capture_out for t in f.ticks] == \
        [t.capture_out for t in g.ticks]
    assert f.in_flight == 4 and g.in_flight == 16


def test_interleaved_bubble_shrinks():
    # S=4 stages on 2 ranks x V=2 chunks, m >= ranks: bubble = ranks-1
    plan = SCHEDULES["interleaved"].build(n_stages=4, n_ranks=2,
                                          microbatches=4, virtual_stages=2)
    assert plan is not None
    assert plan.busy_ticks == 8                     # V passes over m
    assert plan.bubble_ticks == plan.n_ranks - 1 == 1
    # every wrapped chunk output is stashed before (or at) the tick that
    # feeds it back
    stash_tick = {t.stash_buf: i for i, t in enumerate(plan.ticks)
                  if t.stash_buf >= 0}
    for i, t in enumerate(plan.ticks):
        if t.feed_buf >= 0:
            assert stash_tick[t.feed_buf] <= i


@pytest.mark.parametrize("name,v", [("gpipe", 1), ("one_f_one_b", 1),
                                    ("interleaved", 2), ("interleaved", 3)])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_tick_plan_invariants(name, v, m):
    ranks = 2
    plan = SCHEDULES[name].build(n_stages=ranks * v, n_ranks=ranks,
                                 microbatches=m, virtual_stages=v)
    assert plan is not None
    feeds = [t.feed_mb for t in plan.ticks if t.feed_mb >= 0]
    captures = [t.capture_out for t in plan.ticks if t.capture_out >= 0]
    assert sorted(feeds) == list(range(m))          # each mb fed once
    assert sorted(captures) == list(range(m))       # each out captured once
    for t in plan.ticks:                            # feeds are exclusive
        assert not (t.feed_mb >= 0 and t.feed_buf >= 0)
    assert sum(t.phase == "warmup" for t in plan.ticks) == ranks - 1
    assert sum(t.phase == "cooldown" for t in plan.ticks) == ranks - 1
    # the closed forms in cost_model match the built plan exactly
    assert cost_model.pipeline_bubble_fraction(name, ranks, m, v) == \
        pytest.approx(plan.bubble_fraction)
    assert cost_model.pipeline_in_flight(name, ranks, m, v) == plan.in_flight


def test_interleaved_v2_beats_gpipe_at_m_equals_s():
    """Acceptance: modeled bubble for interleaved(V=2) strictly below gpipe
    at m = S."""
    S = 4
    g = cost_model.pipeline_bubble_fraction("gpipe", S, S)
    i = cost_model.pipeline_bubble_fraction("interleaved", S, S,
                                            virtual_stages=2)
    assert 0.0 < i < g
    # and the same holds for the built tick plans
    gp = SCHEDULES["gpipe"].build(n_stages=S, n_ranks=S, microbatches=S)
    ip = SCHEDULES["interleaved"].build(n_stages=2 * S, n_ranks=S,
                                        microbatches=S, virtual_stages=2)
    assert ip.bubble_fraction < gp.bubble_fraction


def test_bubble_stretches_roofline_step_time():
    base = cost_model.roofline_terms(1e12, 1e9, 0.0, n_chips=4)
    bub = cost_model.roofline_terms(1e12, 1e9, 0.0, n_chips=4,
                                    bubble_fraction=0.5)
    assert bub.step_time_s == pytest.approx(2 * base.step_time_s)
    assert bub.pipeline_s == pytest.approx(base.step_time_s)
    assert base.bubble_fraction == 0.0 and bub.bubble_fraction == 0.5


def test_plan_bubble_fraction_reads_genes():
    assert cost_model.plan_bubble_fraction(Plan(), 1) == 0.0
    p = Plan(microbatches=8, pipeline_schedule="interleaved",
             virtual_stages=2)
    assert cost_model.plan_bubble_fraction(p, 4) == \
        cost_model.pipeline_bubble_fraction("interleaved", 4, 8, 2)
    # virtual_stages is ignored by non-interleaved schedules
    q = Plan(microbatches=8, pipeline_schedule="gpipe", virtual_stages=2)
    assert cost_model.plan_bubble_fraction(q, 4) == \
        cost_model.pipeline_bubble_fraction("gpipe", 4, 8)


# ---------------------------------------------------------------- registry
def test_get_schedule_and_register():
    assert get_schedule("gpipe") is SCHEDULES["gpipe"]
    assert get_schedule("nope") is None
    sched = SCHEDULES["interleaved"]
    assert get_schedule(sched) is sched             # instances pass through

    class Custom(Schedule):
        name = "custom-test"

        def build(self, *, n_stages, n_ranks, microbatches,
                  virtual_stages=1):
            return None

    register_schedule(Custom())
    try:
        assert get_schedule("custom-test") is not None
        with pytest.raises(ValueError):
            register_schedule(Custom())
    finally:
        del SCHEDULES["custom-test"]


# ------------------------------------------------------------- GA search
def _modeled_evaluate(n_ranks, mem_weight):
    """Modeled step time from the pipeline genes alone: roofline busy time
    (constant across candidates) stretched by the schedule bubble, plus a
    memory term charging the schedule's in-flight activations."""

    def evaluate(genes):
        plan = Plan.from_genes(list(genes))
        bubble = cost_model.plan_bubble_fraction(plan, n_ranks)
        t = 1.0 / (1.0 - bubble)
        mem = cost_model.pipeline_in_flight(
            plan.pipeline_schedule, n_ranks,
            max(plan.microbatches, 1), plan.virtual_stages)
        return Evaluation(time_s=t + mem_weight * mem, correct=True)

    return evaluate


def _ga_best_plan(mem_weight):
    n = len(Plan.gene_cardinalities())
    cfg = GAConfig(population=16, generations=16, seed=3,
                   cardinalities=Plan.gene_cardinalities())
    res = run_ga(n, _modeled_evaluate(n_ranks=4, mem_weight=mem_weight), cfg)
    return Plan.from_genes(list(res.best_genes))


def test_ga_flips_schedule_gene_on_bubble_vs_memory():
    """The GA's all-zeros baseline is gpipe; when the bubble term dominates
    it must flip pipeline_schedule to interleaved, and when the memory term
    dominates to the 1F1B in-flight cap."""
    bubble_bound = _ga_best_plan(mem_weight=0.0)
    assert bubble_bound.pipeline_schedule == "interleaved"
    assert bubble_bound.virtual_stages == 2
    assert bubble_bound.microbatches == 8           # deepest overlap wins

    memory_bound = _ga_best_plan(mem_weight=0.5)
    assert memory_bound.pipeline_schedule == "one_f_one_b"
    assert memory_bound.microbatches == 8           # cap makes m=8 free


# ----------------------------------------------------- the H100's capacity
def test_device_memory_is_the_h100s():
    assert DEVICE_MEMORY_BYTES == 80 * GiB == 85_899_345_920


def test_h100_default_rejects_whole_large_models_and_holds_served_cells():
    """At the H100's 80 GiB: command-r-plus-104b whole (about 208 GB of
    bf16 weights) is a P019 error, and granite-3-2b with 4 slots at
    cache_len 2112 (a cell the card serves) is clean."""
    serve = {"n_slots": 4, "cache_len": 2112, "prompt_len": 64,
             "max_gen": 32}
    big = lint_plan(Plan(), cfg=get_config("command-r-plus-104b"),
                    serve=serve)
    (f,) = rules(big, "P019")
    assert f.severity == "error"
    assert f.context["param_bytes"] > 200e9
    assert f.context["capacity_bytes"] == DEVICE_MEMORY_BYTES
    assert not lint_plan(Plan(), cfg=get_config("granite-3-2b"), serve=serve)
    # granite's 2.5B bf16 params and this pool fit a 16 GiB chip too
    assert not rules(lint_plan(Plan(), cfg=get_config("granite-3-2b"),
                               serve=serve,
                               device_memory_bytes=TPU_CHIP_BYTES), "P019")


# ------------------------------- tests/test_power.py: library backend, sums
def test_library_backend_slots_into_fb_phase_only():
    from repro_torch.backends import (DEFAULT_REGISTRY, GPU_LIBRARY,
                                      SearchContext,
                                      registry_with_library_backend)
    reg = registry_with_library_backend()
    order = reg.verification_order()
    # the default registry is untouched and the new registry has 4 backends
    assert len(DEFAULT_REGISTRY) == 3
    assert len(reg) == 4
    assert [(b.key, m) for b, m in order] == [
        ("dp", "function_block"),
        ("fb_gpu_lib", "function_block"),     # verify_time 1.2 slots here
        ("tp", "function_block"),
        ("pallas", "function_block"),
        ("dp", "loop"), ("tp", "loop"), ("pallas", "loop"),
    ]
    assert ("fb_gpu_lib", "loop") not in [(b.key, m) for b, m in order]
    assert GPU_LIBRARY.methods == ("function_block",)
    # forcing a loop search on it is a programming error, not a silent skip
    ctx = SearchContext(runner=None, inputs={}, ref_out=None)
    with pytest.raises(NotImplementedError):
        GPU_LIBRARY.search(None, ctx, method="loop")


def test_library_backend_matches_the_jax_packages():
    from repro_torch.backends import GPU_LIBRARY, registry_with_library_backend
    jax_backends = importlib.import_module("repro.backends")
    ref = jax_backends.GPU_LIBRARY
    for field in ("key", "name", "paper_analogue", "price", "verify_time",
                  "methods", "mesh_role"):
        assert getattr(GPU_LIBRARY, field) == getattr(ref, field), field
    assert dataclasses.asdict(GPU_LIBRARY.power) == \
        dataclasses.asdict(ref.power)
    assert [(b.key, m) for b, m in
            registry_with_library_backend().verification_order()] == \
        [(b.key, m) for b, m in
         jax_backends.registry_with_library_backend().verification_order()]


def test_envelope_addition_sums_draws_and_mixes_memory_fraction():
    from repro_torch.power import PowerEnvelope
    a = PowerEnvelope("a", idle_w=10.0, peak_w=110.0,
                      memory_w_fraction=0.2)
    b = PowerEnvelope("b", idle_w=20.0, peak_w=320.0,
                      memory_w_fraction=0.4)
    c = a + b
    assert c.idle_w == pytest.approx(30.0)
    assert c.peak_w == pytest.approx(430.0)
    # active-weighted mix: (100*0.2 + 300*0.4) / 400
    assert c.memory_w_fraction == pytest.approx(0.35)
    assert c.name == "a+b"
    # sum() works via __radd__
    total = sum([a, b, a])
    assert total.peak_w == pytest.approx(540.0)
    assert total.idle_w == pytest.approx(40.0)
    with pytest.raises(TypeError):
        a + 3.0


def test_fleet_draw_w_is_the_shared_summation():
    from repro_torch.power import fleet_draw_w
    assert fleet_draw_w([10.0, 20.0, 30.0]) == pytest.approx(60.0)
    assert fleet_draw_w([]) == 0.0
    # an unmodeled draw contributes nothing
    assert fleet_draw_w([10.0, None, 5.0]) == pytest.approx(15.0)


def test_cache_stats_count_static_prunes_like_the_jax_package():
    from repro_torch.core.search_cache import CacheStats
    jax_stats = importlib.import_module("repro.core.search_cache").CacheStats
    ours, ref = CacheStats(), jax_stats()
    ours.static_pruned = ref.static_pruned = 3
    assert ours.to_dict() == ref.to_dict()
    assert list(ours.to_dict()) == list(ref.to_dict())


# -------------------------------------------- parity with the JAX package
def _lint_contexts():
    """(plan name, mesh, shape name, serve) cells every config is linted
    under: each named plan on its documented mesh and shapes, the default
    plan on both production meshes and the train shape, and a serving
    context that overflows a full-attention cache."""
    cells = [(name, ctx["mesh"], shape, None)
             for name, ctx in PLAN_CONTEXTS.items() for shape in ctx["shapes"]]
    cells += [(None, mesh, "train_4k", None) for mesh in PRODUCTION_MESHES]
    cells += [(None, None, None, {"n_slots": 4, "cache_len": 2112,
                                   "prompt_len": 2048, "max_gen": 128}),
              ("serve-low-mem", None, None,
               {"n_slots": 64, "cache_len": 131072, "prompt_len": 8,
                "max_gen": 8})]
    return cells


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lint_findings_equal_the_jax_packages(arch):
    """Same plan, mesh, config, shape and serving context => the same
    findings (rule, severity, message, field, context) from both packages,
    at the reference's 16 GiB passed to both."""
    jax_lint = importlib.import_module("repro.analysis").lint_plan
    jax_cfgs = importlib.import_module("repro.configs")
    jax_plans = importlib.import_module("repro.dist.plan")
    n = 0
    for plan_name, mesh, shape, serve in _lint_contexts():
        ours_plan = NAMED_PLANS[plan_name] if plan_name else Plan()
        ref_plan = jax_plans.NAMED_PLANS[plan_name] if plan_name \
            else jax_plans.Plan()
        kw = dict(mesh=PRODUCTION_MESHES.get(mesh), serve=serve,
                  device_memory_bytes=TPU_CHIP_BYTES)
        ours = lint_plan(ours_plan, cfg=get_config(arch),
                         shape=get_shape(shape) if shape else None, **kw)
        ref = jax_lint(ref_plan, cfg=jax_cfgs.get_config(arch),
                       shape=jax_cfgs.get_shape(shape) if shape else None,
                       **kw)
        assert [f.to_dict() for f in ours] == [f.to_dict() for f in ref], \
            (plan_name, mesh, shape, serve)
        n += len(ours)
    assert n > 0


@pytest.mark.parametrize("name,v", [("gpipe", 1), ("one_f_one_b", 1),
                                    ("interleaved", 2)])
def test_tick_plans_equal_the_jax_packages(name, v):
    jax_sched = importlib.import_module("repro.dist.schedules")
    for ranks, m in ((2, 1), (2, 4), (4, 8)):
        kw = dict(n_stages=ranks * v, n_ranks=ranks, microbatches=m,
                  virtual_stages=v)
        assert dataclasses.asdict(SCHEDULES[name].build(**kw)) == \
            dataclasses.asdict(jax_sched.SCHEDULES[name].build(**kw))
