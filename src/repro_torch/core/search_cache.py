"""Structure-keyed search cache: plan search at O(unique artifacts), the port
of ``repro.core.search_cache`` with the trace in the place of
lower + compile.

Many candidates of a plan search share the *identical* traced artifact (the
model-only pipeline-schedule genes differ only in the modeled bubble term,
see ``repro_torch.dist.plan.Gene.structural``), and repeated invocations
retrace artifacts an earlier run already analysed.  Three layers collapse
the per-candidate cost to per-unique-artifact cost:

  * an in-memory **artifact layer** (``get_compiled`` / ``put_compiled``)
    holding live :class:`~repro_torch.core.trace_analysis.TracedArtifact` s
    for the current process, FIFO-bounded;
  * a memory + on-disk **analysis layer** (``lookup`` / ``put``): a JSON
    file mapping ``sha256(structural key + run identity)`` to the analysis
    dict, the trace seconds it cost (``compile_s``, the reference's name)
    and caller extras — a warm cache scores candidates with pure roofline
    arithmetic, zero traces;
  * a per-artifact analysis memo (:func:`analyze_artifact`), so one
    artifact's op list is walked at most once however many policies /
    bubble fractions re-score it.

:func:`make_cached_batch_evaluator` packages the layers as a
``run_ga(evaluate_batch=...)`` callback: a generation is linted and
deduped by ``Plan.structural_key()`` *before* tracing, the unique missing
keys are traced on a thread pool (traces on a mesh take turns, see
``trace_analysis.trace``), and every candidate is scored from the shared
analysis with its own ``bubble_fraction``.

Disk entries that are corrupted, truncated, from an incompatible cache
version or from another runtime (:func:`runtime_fingerprint`) are ignored
(the key retraces); a cache failure is never an error.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

CACHE_VERSION = 1
# an analysis payload must feed cost_model.roofline_from_analysis
REQUIRED_ANALYSIS_KEYS = ("flops", "bytes", "collective_bytes")


# --------------------------------------------------------------------- keys
def _jsonable(obj):
    if isinstance(obj, (list, tuple)):
        return [_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def canonical_key(key) -> str:
    """Stable JSON string for an arbitrarily nested key structure."""
    return json.dumps(_jsonable(key), sort_keys=True, separators=(",", ":"))


def hash_key(key) -> str:
    return hashlib.sha256(canonical_key(key).encode()).hexdigest()[:32]


def runtime_fingerprint() -> str:
    """Tracer identity stamped into the disk layer.

    An analysis payload describes what *this* torch decomposed on *this*
    device — another torch, CUDA or card traces other ops, so a file
    written by another runtime must read as cold, not as hits serving
    stale rooflines.
    """
    import torch
    if not torch.cuda.is_available():
        return f"torch-{torch.__version__}-cpu"
    return (f"torch-{torch.__version__}-cuda-{torch.version.cuda}-"
            f"{torch.cuda.get_device_name(0)}")


def mesh_fingerprint(mesh) -> tuple:
    """Cache-key identity of a mesh: axis names/sizes.

    Structural keys must distinguish artifacts traced for different meshes;
    the axis layout is what the sharding sees.
    """
    if mesh is None:
        return ("nomesh",)
    try:
        return tuple((str(a), int(s)) for a, s in mesh.shape.items())
    except Exception:
        return (repr(mesh),)


# -------------------------------------------------------------- statistics
@dataclass
class CacheStats:
    """Counters for search observability (hit/miss are per candidate)."""
    candidates: int = 0      # candidates scored through the cache
    hits: int = 0            # scored without a fresh trace
    disk_hits: int = 0       # subset of hits served by the on-disk layer
    misses: int = 0          # fresh traces (== unique artifacts)
    compile_s: float = 0.0   # wall seconds spent in fresh traces
    # hot-path reads through lookup() (repro_torch.core.plan_lookup): after
    # warm-up these grow while ``misses`` stays flat — the trace-free
    # scoring guarantee is exactly that invariant
    lookups: int = 0
    # candidates rejected by the static lint before any trace (the router
    # counts an endpoint it prunes for a request here)
    static_pruned: int = 0

    @property
    def unique_compiles(self) -> int:
        return self.misses

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def to_dict(self) -> dict:
        return {"candidates": self.candidates, "hits": self.hits,
                "disk_hits": self.disk_hits,
                "unique_compiles": self.unique_compiles,
                "hit_rate": round(self.hit_rate, 4),
                "compile_s": round(self.compile_s, 3),
                "static_pruned": self.static_pruned,
                "lookups": self.lookups}


# ------------------------------------------------------------------- cache
class SearchCache:
    """Two-layer structure-keyed cache (see module docstring).

    ``path=None`` keeps everything in memory; with a path, valid entries
    are loaded eagerly and every ``put`` autosaves (atomic replace), so
    concurrent / aborted runs leave at worst a complete older file.
    """

    def __init__(self, path: Optional[os.PathLike] = None, *,
                 autosave: bool = True, artifact_capacity: int = 16):
        self.path = Path(path) if path is not None else None
        self.autosave = autosave
        self.artifact_capacity = artifact_capacity
        self._lock = threading.RLock()
        self._entries: Dict[str, dict] = {}
        self._from_disk: set = set()
        self._failed: Dict[str, dict] = {}      # memory-only failure memo
        # memory-only artifacts, FIFO-bounded: the analysis layer is all
        # that scoring ever needs again
        self._compiled: Dict[str, Any] = {}
        self.stats = CacheStats()
        if self.path is not None:
            self._load()

    # ---------------------------------------------------------- disk layer
    @staticmethod
    def valid_payload(payload) -> bool:
        """True iff a payload can score candidates without retracing."""
        if not isinstance(payload, dict):
            return False
        analysis = payload.get("analysis")
        if not isinstance(analysis, dict):
            return False
        return all(isinstance(analysis.get(k), (int, float))
                   for k in REQUIRED_ANALYSIS_KEYS)

    def _load(self):
        try:
            raw = json.loads(self.path.read_text())
        except Exception:
            return                   # missing/corrupted file == cold cache
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
            return
        if raw.get("runtime") != runtime_fingerprint():
            return             # another torch/CUDA/card wrote this file
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            return
        for h, payload in entries.items():
            if self.valid_payload(payload):      # stale/partial entry: skip
                self._entries[h] = payload
                self._from_disk.add(h)

    def save(self):
        if self.path is None:
            return
        with self._lock:
            data = {"version": CACHE_VERSION,
                    "runtime": runtime_fingerprint(),
                    "entries": self._entries}
            self.path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(data, f)
                os.replace(tmp, self.path)
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # ------------------------------------------------------ analysis layer
    def lookup(self, key, *, count: bool = True) -> Optional[dict]:
        """Analysis payload for ``key`` or None (a miss is not counted —
        the subsequent :meth:`put` / :meth:`put_failure` counts it)."""
        h = hash_key(key)
        with self._lock:
            payload = self._entries.get(h)
            if payload is None:
                payload = self._failed.get(h)
            if count:
                self.stats.lookups += 1
            if payload is not None and count:
                self.stats.hits += 1
                if h in self._from_disk:
                    self.stats.disk_hits += 1
            return payload

    def put(self, key, analysis: Dict[str, float], compile_s: float,
            extra: Optional[dict] = None) -> dict:
        payload = {"analysis": {k: float(v) for k, v in analysis.items()},
                   "compile_s": float(compile_s)}
        if extra:
            payload["extra"] = extra
        with self._lock:
            self._entries[hash_key(key)] = payload
            self.stats.misses += 1
            self.stats.compile_s += float(compile_s)
        if self.autosave:
            self.save()
        return payload

    def put_failure(self, key, error: str) -> dict:
        """Memoize a trace failure (memory only: a failure may be
        environmental, so it must not poison the disk layer).

        A failure supersedes any earlier success for the same key — the
        latest verification verdict wins, so a lookup can never dispatch to
        a destination the planner has since proven wrong."""
        payload = {"error": error}
        h = hash_key(key)
        with self._lock:
            self._entries.pop(h, None)
            self._from_disk.discard(h)
            self._failed[h] = payload
            self.stats.misses += 1
        return payload

    def from_disk(self, key) -> bool:
        return hash_key(key) in self._from_disk

    # ------------------------------------------------------ artifact layer
    def get_compiled(self, key):
        return self._compiled.get(hash_key(key))

    def put_compiled(self, key, artifact):
        with self._lock:
            while len(self._compiled) >= max(self.artifact_capacity, 1):
                self._compiled.pop(next(iter(self._compiled)))
            self._compiled[hash_key(key)] = artifact


# ------------------------------------------------- analysis memoization
_analysis_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def analyze_artifact(artifact) -> Dict[str, float]:
    """Memoized ``artifact.analyze()`` (the reference's
    ``analyze_compiled``): the op walk runs at most once per artifact, so
    re-scoring the same artifact under a different bubble fraction or
    selection policy is free."""
    analysis = _analysis_memo.get(artifact)
    if analysis is None:
        analysis = _analysis_memo[artifact] = artifact.analyze()
    return analysis


# ------------------------------------------------------- batch evaluator
def make_cached_batch_evaluator(
        trace_plan: Callable[[Any], Any],
        runner,
        cache: Optional[SearchCache] = None,
        *,
        key_extra: Sequence = (),
        pipe_ranks: int = 1,
        workers: int = 4,
        from_genes: Optional[Callable[[Tuple[int, ...]], Any]] = None,
        lint: Optional[Callable[[Any], Sequence]] = None,
) -> Callable[[List[Tuple[int, ...]]], List[Any]]:
    """Build a ``run_ga(evaluate_batch=...)`` callback over the cache.

    ``trace_plan(plan)`` (the reference's ``lower_plan``) returns a
    :class:`~repro_torch.core.trace_analysis.Traceable` for one candidate
    (``from_genes(genes)``, by default ``repro_torch.dist.plan.Plan.
    from_genes``); it runs on the worker pool with the trace, so building
    a candidate is no serial prefix of the generation.  ``runner`` is a
    :class:`repro_torch.core.measure.CompiledCostRunner`; ``key_extra``
    names the run identity ((arch, shape, mesh fingerprint, ...)) baked
    into every cache key; ``pipe_ranks`` sizes the pipeline axis the
    model-only schedule genes are charged against.

    Per generation: candidates are deduped by ``plan.structural_key()``
    *before* any tracing, the unique missing keys are traced and analysed
    on a pool of ``workers`` threads (each trace installs its own
    ``FakeTensorMode``, recorder and work sink, all per thread; traces on
    a mesh take turns, ``trace_analysis.trace``), and each candidate is
    scored from its key's analysis with its own bubble fraction — at most
    one trace per unique structural key, ever.  A worker's ``compile``
    span has no parent (spans nest per thread).  The callback exposes
    ``.cache`` (the :class:`SearchCache`) and ``.evaluate`` (a
    per-individual fallback for ``run_ga``).

    ``lint(plan)`` (e.g. a closure over
    :func:`repro_torch.analysis.lint_plan`) returns static findings for one
    candidate; an error-severity finding rejects it with the GA penalty
    *before* tracing: it never reaches the pool, ``stats.static_pruned``
    counts it, and it is neither a hit nor a miss.  Lint verdicts are
    memoized per gene tuple (findings may depend on model-only genes).
    """
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core import cost_model
    from repro_torch.core.ga import Evaluation
    from repro_torch.obs import get_tracer

    if cache is None:
        cache = SearchCache()
    if from_genes is None:
        from repro_torch.dist.plan import Plan

        def from_genes(genes):
            return Plan.from_genes(list(genes))

    key_prefix = tuple(key_extra)
    lint_memo: Dict[Tuple[int, ...], list] = {}

    def build(item) -> dict:
        key, plan = item
        with get_tracer().span("compile", cat="search",
                               track="search") as csp:
            try:
                t0 = time.perf_counter()
                artifact = trace_plan(plan).trace()
                dt = time.perf_counter() - t0
                analysis = analyze_artifact(artifact)
                cache.put_compiled(key, artifact)
                csp.set(ok=True, compile_s=dt)
                return cache.put(key, analysis, dt)
            except Exception as e:  # a trace error == conversion fails
                csp.set(ok=False)
                return cache.put_failure(key, repr(e)[:500])

    def evaluate_batch(generation: List[Tuple[int, ...]]) -> List[Any]:
        gen_span = get_tracer().span("evaluate_batch", cat="search",
                                     track="search",
                                     candidates=len(generation))
        plans = [from_genes(g) for g in generation]
        keys = [(key_prefix, p.structural_key()) for p in plans]
        hashes = [hash_key(k) for k in keys]
        cache.stats.candidates += len(generation)

        # static pruning before the pool: the memo key is the whole
        # individual, not the structural key
        pruned: Dict[int, list] = {}             # generation idx -> findings
        if lint is not None:
            for i, (genes, plan) in enumerate(zip(generation, plans)):
                gk = tuple(genes)
                findings = lint_memo.get(gk)
                if findings is None:
                    findings = lint_memo[gk] = list(lint(plan) or ())
                if any(getattr(f, "severity", None) == "error"
                       for f in findings):
                    pruned[i] = findings
            cache.stats.static_pruned += len(pruned)

        payloads: Dict[str, dict] = {}
        todo: Dict[str, tuple] = {}              # hash -> (key, plan)
        for i, (h, key, plan) in enumerate(zip(hashes, keys, plans)):
            if i in pruned or h in payloads or h in todo:
                continue
            payload = cache.lookup(key, count=False)
            if payload is not None:
                payloads[h] = payload
            else:
                todo[h] = (key, plan)
        if todo:
            n = max(1, min(workers, len(todo)))
            with ThreadPoolExecutor(max_workers=n) as ex:
                for h, payload in zip(todo, ex.map(build, todo.values())):
                    payloads[h] = payload
        # per-candidate accounting: every unpruned candidate that did not
        # pay for its own trace is a hit (put/put_failure counted the
        # misses; pruned candidates never enter the cache)
        hits = len(generation) - len(pruned) - len(todo)
        cache.stats.hits += hits
        for i, (h, key) in enumerate(zip(hashes, keys)):
            if i not in pruned and h not in todo and cache.from_disk(key):
                cache.stats.disk_hits += 1

        out = []
        for i, (h, plan) in enumerate(zip(hashes, plans)):
            if i in pruned:
                out.append(Evaluation(
                    time_s=float("inf"), correct=False,
                    info={"static_pruned": True,
                          "static_findings": [
                              f.to_dict() if hasattr(f, "to_dict") else f
                              for f in pruned[i]]}))
                continue
            payload = payloads[h]
            if "error" in payload:
                out.append(Evaluation(time_s=float("inf"), correct=False,
                                      info={"error": payload["error"]}))
                continue
            bubble = cost_model.plan_bubble_fraction(plan, pipe_ranks)
            fresh = h in todo
            out.append(runner.score_analysis(
                payload["analysis"],
                payload.get("compile_s", 0.0) if fresh else 0.0,
                bubble_fraction=bubble, cache_hit=not fresh))
        gen_span.set(n_pruned=len(pruned), compiles=len(todo),
                     n_fresh=len(todo), hits=hits)
        gen_span.finish()
        return out

    def evaluate(genes):
        return evaluate_batch([genes])[0]

    evaluate_batch.cache = cache
    evaluate_batch.evaluate = evaluate
    return evaluate_batch
