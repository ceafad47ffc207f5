"""Plan lookup: the hot read side of the planner, split from plan search;
a copy of the JAX package's ``plan_lookup``.

``plan_offload`` (repro_torch.core.planner) is the *write* side: it
searches, measures, traces and mesh-verifies candidates — seconds to
minutes of work, amortized by
:class:`~repro_torch.core.search_cache.SearchCache`.  Nothing on a request
path can afford any of that.  This module is the *read* side: a
:class:`PlanLookup` holds warm analysis payloads (the same dicts the search
cache persists) and scores them with pure roofline arithmetic
(:meth:`CompiledCostRunner.score_analysis`), so a serve-time router answers
"how fast / how many watts is this backend for this request" in
microseconds, provably without tracing.

The split contract:

  * **slow path** (offline): ``plan_offload(..., publish=lookup)`` registers
    every mesh-verified record's analysis under
    ``serve_key(backend, app)`` — including *failures* for incorrect
    records, so the hot path can refuse a destination the verification
    environment proved wrong without re-measuring it.
  * **hot path** (request): :meth:`PlanLookup.lookup` /
    :meth:`PlanLookup.score` never trace; a payload miss is a miss (the
    caller skips the backend), never a trace.

``CacheStats.lookups`` counts hot-path reads; ``CacheStats.misses`` (the
trace counter) must stay flat across any number of them.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

from repro_torch.core.cost_model import FLOPS_KEY_PREFIX
from repro_torch.core.measure import CompiledCostRunner
from repro_torch.core.search_cache import SearchCache


def serve_key(backend_name: str, arch: str, plan=None,
              extra: Sequence = ()) -> Tuple:
    """Cache identity of one (backend, arch[, plan]) serving artifact.

    ``plan`` (a :class:`repro_torch.dist.plan.Plan`) folds its
    ``structural_key``
    in, so two endpoints serving the same arch under different serving
    plans (e.g. ``kv_cache_quant`` on/off) hold distinct warm entries.
    """
    pk = plan.structural_key() if plan is not None else None
    return ("serve", str(backend_name), str(arch), pk, tuple(extra))


def analysis_from_roofline(rl) -> Optional[dict]:
    """Recover the cacheable analysis dict from a ``Roofline`` (or its
    ``to_dict()`` form, e.g. ``VerificationRecord.mesh_info["roofline"]``).

    The per-device flops (with their dtype split)/bytes/collective terms
    are exactly what ``roofline_from_analysis`` consumes, so a record the
    planner already mesh-verified warms the lookup without keeping the
    artifact around.
    """
    def term(name):
        v = rl.get(name) if isinstance(rl, Mapping) else getattr(rl, name,
                                                                 None)
        return None if v is None else float(v)

    flops = term("flops_per_device")
    byts = term("bytes_per_device")
    coll = term("collective_bytes_per_device")
    if flops is None or byts is None:
        return None
    split = (rl.get("flops_by_dtype") if isinstance(rl, Mapping)
             else getattr(rl, "flops_by_dtype", None)) or {}
    return {"flops": flops, "bytes": byts,
            "collective_bytes": coll if coll is not None else 0.0,
            **{FLOPS_KEY_PREFIX + d: float(v) for d, v in split.items()}}


class PlanLookup:
    """Warm plan-analysis table with trace/compile-free scoring.

    Thin, deliberately boring wrapper over a :class:`SearchCache` analysis
    layer: registration is the only path that may cost anything; every
    read is dict lookup + roofline arithmetic.
    """

    def __init__(self, cache: Optional[SearchCache] = None):
        self.cache = cache if cache is not None else SearchCache()

    # ------------------------------------------------------------ slow side
    def register(self, key, analysis: Mapping[str, float], *,
                 compile_s: float = 0.0, extra: Optional[dict] = None):
        """Publish a warm analysis payload (offline / search-time only)."""
        return self.cache.put(key, dict(analysis), compile_s, extra=extra)

    def register_failure(self, key, error: str):
        """Publish a verification failure: the hot path must *refuse* this
        key, not retry it (an incorrect record is never dispatched to)."""
        return self.cache.put_failure(key, error)

    # ------------------------------------------------------------- hot side
    def lookup(self, key) -> Optional[dict]:
        """Warm payload for ``key`` or None.  Never traces."""
        return self.cache.lookup(key)

    def usable(self, payload) -> bool:
        """True iff a payload can score a request (warm and not a recorded
        failure)."""
        return bool(payload) and "error" not in payload \
            and isinstance(payload.get("analysis"), dict)

    def score(self, key, *, n_chips: int = 1, model_flops: float = 0.0,
              bubble_fraction: float = 0.0):
        """Roofline :class:`~repro_torch.core.ga.Evaluation` for a warm
        key, or None on a miss / recorded failure.  Pure arithmetic."""
        payload = self.lookup(key)
        if not self.usable(payload):
            return None
        runner = CompiledCostRunner(n_chips=n_chips, model_flops=model_flops)
        return runner.score_analysis(payload["analysis"],
                                     bubble_fraction=bubble_fraction,
                                     cache_hit=True)

    @property
    def stats(self):
        return self.cache.stats


def analysis_from_time(time_s: float) -> Optional[dict]:
    """Synthetic analysis whose roofline reproduces a host-measured time.

    Destinations verified without a mesh bridge have no traced roofline;
    the fallback mirrors ``energy_for_record``'s convention — the
    destination is assumed compute-busy for the measured seconds (flops =
    time × the fp32 peak, the price of FLOPs without a dtype split), so
    ``score_analysis`` at ``n_chips=1`` returns ``time_s`` and full
    compute utilization.
    """
    if not (time_s > 0.0) or time_s == float("inf"):
        return None
    from repro_torch.core.cost_model import PEAK_FLOPS
    return {"flops": time_s * PEAK_FLOPS, "bytes": 0.0,
            "collective_bytes": 0.0}


def publish_record(lookup: Optional[PlanLookup], record, backend,
                   app_name: str) -> bool:
    """Planner-side publish rule (the write half of the search/lookup
    split): a correct record warms ``serve_key(backend, app)`` — from its
    mesh roofline when the bridge recorded one, from the host time
    otherwise (:func:`analysis_from_time`); an incorrect one records a
    failure so the router can statically refuse the destination.  Returns
    True when something was published.
    """
    if lookup is None:
        return False
    key = serve_key(backend.name, app_name)
    if not getattr(record, "correct", False):
        # a backend runs several verifications (FB, loop) against one key:
        # only refuse the destination when nothing has succeeded — one
        # correct verification is a serveable destination even if another
        # method's pattern was wrong
        if not lookup.usable(lookup.cache.lookup(key, count=False)):
            lookup.register_failure(key, record.note or "incorrect result")
            return True
        return False
    rl = (record.mesh_info or {}).get("roofline")
    analysis = analysis_from_roofline(rl) if rl else None
    source = "roofline"
    if analysis is None:
        analysis = analysis_from_time(getattr(record, "best_time_s",
                                              float("inf")))
        source = "host-time"
    if analysis is None:
        return False
    lookup.register(key, analysis,
                    compile_s=getattr(record, "verify_elapsed_s", 0.0),
                    extra={"destination": backend.name,
                           "paper_analogue": backend.paper_analogue,
                           "source": source})
    return True
