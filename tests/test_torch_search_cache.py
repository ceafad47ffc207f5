"""The port's structure-keyed search cache (``repro_torch.core.search_cache``):
``tests/test_search_cache.py`` run on the port, with a counting traceable in
place of its ``FakeLowered`` (a trace stands where lower + compile stood),
and the cache keys held against the JAX package's digests."""
import json

import pytest
import torch

from repro.core import search_cache as jax_sc
from repro.dist.plan import Plan as JaxPlan
from repro_torch.core import search_cache as sc
from repro_torch.core.ga import GAConfig, run_ga
from repro_torch.core.measure import CompiledCostRunner
from repro_torch.core.trace_analysis import TensorSpec, TracedArtifact, trace
from repro_torch.dist.plan import MODEL_ONLY_FIELDS, Plan


# ----------------------------------------------------------- structural key
def genes_with(**overrides):
    idx = {g.field: i for i, g in enumerate(Plan.GENE_SPACE)}
    genes = [0] * len(Plan.GENE_SPACE)
    for f, choice_value in overrides.items():
        genes[idx[f]] = Plan.GENE_SPACE[idx[f]].choices.index(choice_value)
    return tuple(genes)


def test_model_only_fields_are_the_schedule_genes():
    assert MODEL_ONLY_FIELDS == {"pipeline_schedule", "virtual_stages"}
    for g in Plan.GENE_SPACE:
        assert g.structural == (g.field not in MODEL_ONLY_FIELDS)


def test_structural_key_ignores_schedule_genes():
    base = Plan.from_genes(list(genes_with()))
    sched = Plan.from_genes(list(genes_with(
        pipeline_schedule="interleaved", virtual_stages=2)))
    remat = Plan.from_genes(list(genes_with(remat="full")))
    assert base.structural_key() == sched.structural_key()
    assert base.structural_key() != remat.structural_key()
    # the key covers non-gene fields too (anything reaching the trace)
    import dataclasses
    named = {f[0] for f in base.structural_key()}
    for f in dataclasses.fields(Plan):
        if f.name == "name" or f.name in MODEL_ONLY_FIELDS:
            assert f.name not in named
        else:
            assert f.name in named


def test_structural_key_is_stable_and_hashable():
    p = Plan.from_genes(list(genes_with(remat="block")))
    q = Plan.from_genes(list(genes_with(remat="block")), name="other")
    assert p.structural_key() == q.structural_key()     # name is a label
    assert hash(p.structural_key()) == hash(q.structural_key())
    assert sc.hash_key(p.structural_key()) == sc.hash_key(q.structural_key())


# ------------------------------------------------------------ fake tracer
def _matmul_fn(ab):
    return ab[0] @ ab[1]


MATMUL_SPECS = (TensorSpec((64, 64), device="cpu"),
                TensorSpec((64, 64), device="cpu"))


class CountingArtifact(TracedArtifact):
    """A traced 64^3 matmul whose analysis walk is counted (the walk is
    the call the memo saves, as ``as_text()`` was in the reference)."""

    def __init__(self):
        art = trace(_matmul_fn, MATMUL_SPECS)
        super().__init__(art.ops, art.device, art.comm_counts)
        self.analyze_calls = 0

    def analyze(self):
        self.analyze_calls += 1
        return super().analyze()


class CountingTraceable:
    """Stands in for a ``Traceable``: ``trace()`` is the expensive call."""

    def __init__(self, counter):
        self.counter = counter

    def trace(self):
        self.counter["compiles"] += 1
        return CountingArtifact()


def make_counting_trace_plan(counter):
    def trace_plan(plan):
        counter["lowers"] += 1
        return CountingTraceable(counter)
    return trace_plan


def make_evaluator(cache, counter, **kw):
    kw.setdefault("pipe_ranks", 2)
    return sc.make_cached_batch_evaluator(
        make_counting_trace_plan(counter), CompiledCostRunner(n_chips=1),
        cache, key_extra=("test",), **kw)


# ------------------------------------------------- artifact-sharing dedupe
def test_schedule_flip_shares_artifact_remat_flip_misses():
    counter = {"lowers": 0, "compiles": 0}
    cache = sc.SearchCache()
    ev_batch = make_evaluator(cache, counter)

    base = genes_with(microbatches=4)
    flip_sched = genes_with(microbatches=4, pipeline_schedule="one_f_one_b")
    flip_virt = genes_with(microbatches=4, pipeline_schedule="interleaved",
                           virtual_stages=2)
    evs = ev_batch([base, flip_sched, flip_virt])
    assert counter["compiles"] == 1                  # one artifact, 3 scores
    assert counter["lowers"] == 1                    # deduped BEFORE tracing
    assert [e.correct for e in evs] == [True] * 3
    # the schedule genes still differentiate the modeled time via the bubble:
    # gpipe idles (R-1)/(m+R-1) = 0.2, interleaved(V=2) only 1/9
    assert evs[0].info["roofline"]["bubble_fraction"] > 0
    assert evs[2].time_s < evs[0].time_s

    evs2 = ev_batch([genes_with(remat="full")])      # structural flip
    assert counter["compiles"] == 2
    assert evs2[0].info["cache_hit"] is False
    assert cache.stats.unique_compiles == 2
    assert cache.stats.candidates == 4


def test_ga_traces_once_per_unique_structural_key():
    """A full GA over Plan.GENE_SPACE performs at most one trace per unique
    structural key (trace counter)."""
    counter = {"lowers": 0, "compiles": 0}
    ev_batch = make_evaluator(sc.SearchCache(), counter)
    cards = Plan.gene_cardinalities()
    cfg = GAConfig(population=8, generations=4, seed=3,
                   cardinalities=cards)
    res = run_ga(len(cards), ev_batch.evaluate, cfg,
                 evaluate_batch=ev_batch)
    unique = {Plan.from_genes(list(g)).structural_key()
              for g in res.evaluations}
    assert counter["compiles"] == len(unique)
    assert counter["lowers"] == len(unique)
    assert res.best_eval.correct


def test_warm_disk_cache_zero_traces_same_best(tmp_path):
    path = tmp_path / "cache.json"
    cards = Plan.gene_cardinalities()
    cfg = GAConfig(population=6, generations=3, seed=7,
                   cardinalities=cards)

    c1 = {"lowers": 0, "compiles": 0}
    ev1 = make_evaluator(sc.SearchCache(path), c1)
    res1 = run_ga(len(cards), ev1.evaluate, cfg, evaluate_batch=ev1)
    assert c1["compiles"] > 0
    assert path.exists()

    c2 = {"lowers": 0, "compiles": 0}
    cache2 = sc.SearchCache(path)                   # fresh process analogue
    ev2 = make_evaluator(cache2, c2)
    res2 = run_ga(len(cards), ev2.evaluate, cfg, evaluate_batch=ev2)
    assert c2["compiles"] == 0                      # warm: zero fresh traces
    assert c2["lowers"] == 0
    assert res2.best_genes == res1.best_genes
    assert cache2.stats.disk_hits > 0
    assert cache2.stats.hit_rate == 1.0


def test_corrupted_disk_cache_falls_back_to_retrace(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{ not json !!")
    counter = {"lowers": 0, "compiles": 0}
    ev = make_evaluator(sc.SearchCache(path), counter)
    evs = ev([genes_with()])
    assert evs[0].correct and counter["compiles"] == 1
    # the retrace repaired the file in place
    assert sc.SearchCache(path).lookup(
        (("test",), Plan.from_genes(list(genes_with())).structural_key())
    ) is not None


def test_stale_disk_entries_are_ignored(tmp_path):
    path = tmp_path / "cache.json"
    key = (("test",), Plan.from_genes(list(genes_with())).structural_key())
    h = sc.hash_key(key)
    # wrong version: whole file ignored
    path.write_text(json.dumps({"version": -1, "entries": {
        h: {"analysis": {"flops": 1.0, "bytes": 1.0,
                         "collective_bytes": 0.0}, "compile_s": 0.1}}}))
    assert sc.SearchCache(path).lookup(key) is None
    # right version + runtime, malformed payloads: only those entries drop
    path.write_text(json.dumps({"version": sc.CACHE_VERSION,
                                "runtime": sc.runtime_fingerprint(),
                                "entries": {
        h: {"analysis": {"flops": "NaN-ish"}},
        "other": ["not", "a", "payload"]}}))
    cache = sc.SearchCache(path)
    assert cache.lookup(key) is None
    counter = {"lowers": 0, "compiles": 0}
    evs = make_evaluator(cache, counter)([genes_with()])
    assert evs[0].correct and counter["compiles"] == 1


def test_disk_cache_from_other_runtime_reads_cold(tmp_path):
    """A file written by another torch/CUDA/card must not serve stale
    rooflines — the whole disk layer reads as cold."""
    path = tmp_path / "cache.json"
    counter = {"lowers": 0, "compiles": 0}
    make_evaluator(sc.SearchCache(path), counter)([genes_with()])
    assert counter["compiles"] == 1
    raw = json.loads(path.read_text())
    assert raw["runtime"] == sc.runtime_fingerprint()
    raw["runtime"] = "torch-0.0.0-cuda-0.0-NVIDIA Other"
    path.write_text(json.dumps(raw))
    c2 = {"lowers": 0, "compiles": 0}
    make_evaluator(sc.SearchCache(path), c2)([genes_with()])
    assert c2["compiles"] == 1                   # retraced, no stale hit


def test_runtime_fingerprint_names_torch_and_the_device():
    fp = sc.runtime_fingerprint()
    assert fp.startswith(f"torch-{torch.__version__}-")
    if torch.cuda.is_available():
        assert fp.endswith(torch.cuda.get_device_name(0))
        assert f"-cuda-{torch.version.cuda}-" in fp
    else:
        assert fp.endswith("-cpu")


def test_artifact_layer_is_bounded():
    cache = sc.SearchCache(artifact_capacity=2)
    for i in range(5):
        cache.put_compiled(("k", i), CountingArtifact())
    assert len(cache._compiled) == 2
    assert cache.get_compiled(("k", 4)) is not None
    assert cache.get_compiled(("k", 0)) is None  # evicted FIFO


def test_trace_failure_is_memoized_not_cached_to_disk(tmp_path):
    path = tmp_path / "cache.json"
    cache = sc.SearchCache(path)
    calls = {"n": 0}

    def broken_trace_plan(plan):
        calls["n"] += 1
        raise RuntimeError("tracing exploded")

    ev = sc.make_cached_batch_evaluator(
        broken_trace_plan, CompiledCostRunner(n_chips=1), cache,
        key_extra=("test",))
    evs = ev([genes_with(), genes_with(pipeline_schedule="one_f_one_b")])
    assert calls["n"] == 1                       # one failure per key
    assert all(not e.correct for e in evs)
    assert "tracing exploded" in evs[0].info["error"]
    # same generation again: served from the failure memo, no retry storm
    ev([genes_with()])
    assert calls["n"] == 1
    # the disk layer never persists failures
    fresh = sc.SearchCache(path)
    key = (("test",), Plan.from_genes(list(genes_with())).structural_key())
    assert fresh.lookup(key) is None


def test_failure_evicts_an_earlier_success():
    cache = sc.SearchCache()
    cache.put(("k",), {"flops": 1.0, "bytes": 1.0, "collective_bytes": 0.0},
              0.1)
    assert "analysis" in cache.lookup(("k",))
    cache.put_failure(("k",), "proven wrong")
    assert cache.lookup(("k",)) == {"error": "proven wrong"}


# ------------------------------------------------------ analysis memoization
def test_analyze_artifact_memoizes_per_artifact():
    c = CountingArtifact()
    a1 = sc.analyze_artifact(c)
    a2 = sc.analyze_artifact(c)
    assert c.analyze_calls == 1
    assert a1 is a2
    assert a1["flops"] == pytest.approx(2.0 * 64 * 64 * 64)
    other = CountingArtifact()
    sc.analyze_artifact(other)
    assert other.analyze_calls == 1


def test_score_artifact_walks_once_across_rescoring():
    runner = CompiledCostRunner(n_chips=1)
    c = CountingArtifact()
    e1 = runner.score_artifact(c, bubble_fraction=0.0)
    e2 = runner.score_artifact(c, bubble_fraction=0.5)   # re-score: free
    assert c.analyze_calls == 1
    assert e1.correct and e2.correct
    assert e2.time_s == pytest.approx(e1.time_s * 2.0)


def test_score_analysis_matches_score_artifact():
    runner = CompiledCostRunner(n_chips=1)
    c = CountingArtifact()
    via_artifact = runner.score_artifact(c, 0.25, bubble_fraction=0.25)
    via_analysis = runner.score_analysis(sc.analyze_artifact(c), 0.25,
                                         bubble_fraction=0.25)
    assert via_analysis.time_s == pytest.approx(via_artifact.time_s)
    assert via_analysis.info["roofline"] == via_artifact.info["roofline"]


# ------------------------------------------------------------ key plumbing
def test_hash_key_stable_across_processes_and_orderings():
    k1 = (("a", 1), {"x": 1, "y": 2})
    k2 = (("a", 1), {"y": 2, "x": 1})       # dict order must not matter
    assert sc.hash_key(k1) == sc.hash_key(k2)
    assert sc.hash_key(k1) != sc.hash_key((("a", 2), {"x": 1, "y": 2}))


@pytest.mark.parametrize("key", [
    (("a", 1), {"x": 1, "y": 2}),
    ("serve", "xla_dp", "3mm", None, ()),
    [1.5, True, None, "s", {"n": [1, 2, (3, 4)]}],
    (("arch", "granite-3-2b"), ("mesh", (("data", 1), ("model", 1)))),
])
def test_hash_key_is_the_jax_digest(key):
    assert sc.canonical_key(key) == jax_sc.canonical_key(key)
    assert sc.hash_key(key) == jax_sc.hash_key(key)


def test_plan_keys_hash_as_in_the_jax_package():
    for genes in (genes_with(), genes_with(remat="full"),
                  genes_with(pipeline_schedule="interleaved",
                             virtual_stages=2)):
        mine = Plan.from_genes(list(genes)).structural_key()
        theirs = JaxPlan.from_genes(list(genes)).structural_key()
        assert sc.hash_key((("test",), mine)) == \
            jax_sc.hash_key((("test",), theirs))


def test_mesh_fingerprint_as_in_the_jax_package():
    from repro_torch.dist.bridge import LocalMesh
    assert sc.mesh_fingerprint(LocalMesh()) == (("data", 1), ("model", 1))
    assert sc.mesh_fingerprint(None) == jax_sc.mesh_fingerprint(None)


def test_loop_ga_reuses_identical_choice_measurements():
    """Paper-side structural dedupe: gene strings that build the same
    offload pattern (nest without the destination impl) measure once."""
    from repro_torch.backends.builtin import MANY_CORE
    from repro_torch.core.ga import Evaluation
    from repro_torch.core.loop_offload import ga_search

    class Nest:
        def __init__(self, name, impls):
            self.name = name
            self.impls = impls

    class App:
        name = "dedupe-app"
        nests = [Nest("a", {"dp": None, "seq": None}),
                 Nest("b", {"seq": None})]        # no dp impl -> "seq"

        def build(self, choice):
            return dict(choice)

    class CountingRunner:
        def __init__(self):
            self.calls = []

        def measure(self, fn, inputs, ref_out):
            self.calls.append(fn)
            return Evaluation(time_s=1.0 + 0.1 * len(self.calls),
                              correct=True)

    runner = CountingRunner()
    res = ga_search(App(), MANY_CORE, runner, inputs=None, ref_out=None,
                    ga_cfg=GAConfig(population=4, generations=4, seed=0))
    # 2 binary genes -> 4 gene strings but only 2 distinct patterns
    assert res.cache_stats["measured"] == len(runner.calls)
    assert res.cache_stats["measured"] <= 2
    assert res.cache_stats["reused"] >= 1
    assert res.n_measurements >= res.cache_stats["measured"]
