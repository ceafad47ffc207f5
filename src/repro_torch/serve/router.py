"""Online request router: the paper's destination choice, per request.

The offline planner (``plan_offload``) verifies destinations once per
application; at serve time the same decision repeats per request, so every
ingredient must already be warm:

  * each live :class:`Endpoint`'s plan analysis is published into a
    :class:`~repro_torch.core.plan_lookup.PlanLookup` (by ``plan_offload(...,
    publish=...)`` or directly at endpoint registration);
  * routing a request is then: static lint prune
    (``lint_plan(serve=...)``, the prune-before-trace contract) →
    warm payload lookup (a recorded verification *failure* refuses the
    endpoint outright) → pure-arithmetic roofline scoring
    (``score_analysis``) scaled to the request's token work →
    :class:`~repro_torch.power.EnergyModel` watts/joules → ranking under the
    router's :class:`~repro_torch.backends.SelectionPolicy` with admission
    control from the aggregate ``power_budget_w``.

Nothing on this path traces, captures or launches: after warm-up, routing
N requests moves only ``CacheStats.lookups`` — ``CacheStats.misses`` (the
trace counter) stays flat, pinned by tests/test_torch_serve_router.py.
Routing holds no tensor, so it runs wherever the lookup was published.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.backends import SelectionPolicy, get_policy
from repro_torch.core.candidates import Candidate
from repro_torch.core.plan_lookup import PlanLookup, serve_key
from repro_torch.dist.plan import Plan
from repro_torch.obs import get_tracer
from repro_torch.serve.health import (DEGRADED, PROBING, QUARANTINED,
                                      EndpointHealth, HealthConfig)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request


@dataclass
class Endpoint:
    """One live serving destination: a backend's machine running one arch
    under one serving plan, with a fixed continuous-batching slot pool."""
    name: str
    backend: object                 # repro_torch.backends.Backend (duck-typed)
    arch: str
    n_chips: int = 1
    n_slots: int = 4
    cache_len: int = 256
    plan: object = None             # repro_torch.dist.plan.Plan (serving genes)
    cfg: object = None              # ModelConfig (for the static lint)
    engine: object = None           # optional ContinuousBatcher
    # live state the router maintains
    in_flight: int = 0
    draining: bool = False          # no new dispatches; in-flight completes

    @property
    def free_slots(self) -> int:
        return max(self.n_slots - self.in_flight, 0)

    def lookup_key(self):
        return serve_key(getattr(self.backend, "name", self.name),
                         self.arch, self.plan)


@dataclass
class RoutingDecision:
    rid: str
    endpoint: Optional[Endpoint]            # None == rejected
    reason: str = ""                        # rejection reason / "ok"
    service_time_s: Optional[float] = None  # modeled prefill+decode seconds
    energy_j: Optional[float] = None
    avg_watts: Optional[float] = None
    considered: int = 0                     # endpoints that survived pruning

    @property
    def accepted(self) -> bool:
        return self.endpoint is not None


class Router:
    """Score-and-dispatch over live endpoints (see module docstring).

    ``power_budget_w`` is the *fleet* budget: admission subtracts the draw
    of requests already in flight, so a request is rejected when the
    marginal endpoint draw no longer fits — the serve-time form of the
    power follow-up's "within allowed power" selection.
    """

    def __init__(self, endpoints: List[Endpoint], lookup: PlanLookup, *,
                 policy=None, power_budget_w: Optional[float] = None,
                 metrics: Optional[ServeMetrics] = None,
                 health_cfg: Optional[HealthConfig] = None):
        if not endpoints:
            raise ValueError("router needs at least one endpoint")
        names = [e.name for e in endpoints]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate endpoint names: {names}")
        self.endpoints = list(endpoints)
        self.lookup = lookup
        self.policy: SelectionPolicy = get_policy(policy)
        self.power_budget_w = power_budget_w
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.health_cfg = health_cfg if health_cfg is not None \
            else HealthConfig()
        # per-endpoint health state machines (repro_torch.serve.health): pure
        # arithmetic, fed from the admission ledger on complete/fail
        self.health: Dict[str, EndpointHealth] = {
            e.name: EndpointHealth(e.name, self.health_cfg)
            for e in endpoints}
        # draw currently admitted per endpoint (watts, modeled at routing)
        self._draw_w: Dict[str, float] = {e.name: 0.0 for e in endpoints}
        # endpoints removed while requests were still in flight: their
        # ledger entries stay completable (draw released on complete),
        # never orphaned — the entry is dropped once the last one drains
        self._removed: Dict[str, Endpoint] = {}
        # admission ledger: rid -> (endpoint name, admitted draw, probe).
        # The slot/draw accounting releases exactly what dispatch charged,
        # once — a double complete (or completing a never-dispatched
        # decision) must not leak negative draw into admission headroom.
        self._admitted: Dict[str, Tuple[str, float, bool]] = {}

    # ------------------------------------------------------------- state
    @property
    def fleet_draw_w(self) -> float:
        from repro_torch.power import fleet_draw_w
        return fleet_draw_w(self._draw_w.values())

    def endpoint(self, name: str) -> Optional[Endpoint]:
        """Live endpoint by name (None when absent or already removed)."""
        for ep in self.endpoints:
            if ep.name == name:
                return ep
        return None

    def in_flight_of(self, name: str) -> int:
        """Admitted-but-uncompleted requests on ``name`` per the ledger
        (authoritative — survives endpoint removal)."""
        return sum(1 for n, _, _ in self._admitted.values() if n == name)

    # ------------------------------------------------- endpoint lifecycle
    def add_endpoint(self, ep: Endpoint):
        """Register a new live endpoint (elastic grow / re-admission)."""
        if self.endpoint(ep.name) is not None or ep.name in self._removed:
            raise ValueError(f"endpoint {ep.name!r} already registered")
        self.endpoints.append(ep)
        self._draw_w.setdefault(ep.name, 0.0)
        self.health[ep.name] = EndpointHealth(ep.name, self.health_cfg)

    def drain(self, name: str) -> Endpoint:
        """Stop dispatching to ``name``; in-flight requests keep their
        slots and complete normally.  The migration primitive: drain, wait
        for :meth:`drained`, then :meth:`remove_endpoint`."""
        ep = self.endpoint(name)
        if ep is None:
            raise ValueError(f"unknown endpoint {name!r}")
        ep.draining = True
        return ep

    def drained(self, name: str) -> bool:
        """True once ``name`` has no admitted request left in the ledger."""
        return self.in_flight_of(name) == 0

    def remove_endpoint(self, name: str) -> Endpoint:
        """Take ``name`` out of routing entirely.  With requests still in
        flight its ledger entries remain completable — draw and slot
        accounting release on ``complete`` exactly as if it were live —
        and the draw entry is dropped only once fully drained."""
        ep = self.endpoint(name)
        if ep is None:
            raise ValueError(f"unknown endpoint {name!r}")
        self.endpoints = [e for e in self.endpoints if e.name != name]
        if self.in_flight_of(name) > 0:
            self._removed[name] = ep
        else:
            self._draw_w.pop(name, None)
        return ep

    # ---------------------------------------------------------- dispatch
    def dispatch(self, decision: "RoutingDecision"):
        """Commit an accepted decision: occupy a slot, add its draw."""
        ep = decision.endpoint
        if ep is None:
            raise ValueError(f"cannot dispatch rejected request "
                             f"{decision.rid}")
        if decision.rid in self._admitted:
            raise ValueError(f"request {decision.rid} is already dispatched")
        ep.in_flight += 1
        draw = decision.avg_watts if decision.avg_watts is not None else 0.0
        self._draw_w[ep.name] = self._draw_w.get(ep.name, 0.0) + draw
        health = self.health.get(ep.name)
        probe = health is not None and health.state == PROBING
        if probe:
            health.on_probe_dispatch()
        self._admitted[decision.rid] = (ep.name, draw, probe)
        self.metrics.on_dispatch(decision.rid, ep.name)

    def complete(self, decision: "RoutingDecision", *,
                 latency_s: Optional[float] = None, ok: bool = True,
                 error: str = "", now_s: Optional[float] = None) -> bool:
        """Release an admitted request's slot and draw.  Returns True when
        the request was in flight; completing a rejected, never-dispatched
        or already-completed decision is a no-op (the ledger guarantees
        ``fleet_draw_w``/``in_flight`` can never go negative).

        The optional observation feeds the endpoint's health state
        machine: ``latency_s`` is the observed service latency, ``ok``
        False reports a failure (``error`` its reason — see :meth:`fail`),
        ``now_s`` stamps the finish time into the metrics."""
        admitted = self._admitted.pop(decision.rid, None)
        if admitted is None:
            return False
        name, draw, probe = admitted
        ep = self.endpoint(name) or self._removed.get(name)
        if ep is not None:
            ep.in_flight = max(ep.in_flight - 1, 0)
        if name in self._draw_w:
            self._draw_w[name] = max(self._draw_w[name] - draw, 0.0)
        if name in self._removed and self.in_flight_of(name) == 0:
            self._removed.pop(name)
            self._draw_w.pop(name, None)
        health = self.health.get(name)
        if health is not None:
            if ok:
                if latency_s is not None:
                    health.observe_latency(latency_s)
                health.observe_success(probe=probe)
            else:
                health.observe_error(error or "error", probe=probe)
        if ok:
            energy = None
            if decision.avg_watts is not None and latency_s is not None:
                energy = decision.avg_watts * latency_s
            self.metrics.on_complete(decision.rid, latency_s=latency_s,
                                     energy_j=energy, t=now_s)
        return True

    def fail(self, decision: "RoutingDecision", reason: str = "error",
             now_s: Optional[float] = None) -> bool:
        """Report a failed request: releases the ledger entry and feeds an
        error to the endpoint's circuit breaker.  The caller owns the
        retry (the request was not served)."""
        return self.complete(decision, ok=False, error=reason, now_s=now_s)

    # ----------------------------------------------------------- scoring
    def _score_endpoint(self, ep: Endpoint, req: Request
                        ) -> Tuple[Optional[Candidate], str]:
        """Warm-path score of one endpoint for one request: ``(candidate,
        verdict)``.  The candidate is None — and the verdict names why —
        when the endpoint cannot serve it: ``lint-pruned`` (static lint
        error), ``cold-lookup`` (nothing published), ``failure-verdict``
        (a recorded verification failure).  Pure arithmetic — no trace."""
        from repro_torch.analysis import lint_plan
        if ep.plan is not None or ep.cfg is not None:
            findings = lint_plan(
                ep.plan if ep.plan is not None else Plan(),
                cfg=ep.cfg,
                serve={"n_slots": ep.n_slots, "cache_len": ep.cache_len,
                       "prompt_len": req.prompt_len,
                       "max_gen": req.max_gen})
            if any(f.severity == "error" for f in findings):
                self.lookup.stats.static_pruned += 1
                return None, "lint-pruned"
        payload = self.lookup.lookup(ep.lookup_key())
        if not self.lookup.usable(payload):
            return None, ("cold-lookup" if payload is None
                          else "failure-verdict")
        # the warm analysis describes one decode step; the request costs
        # max_gen steps plus a prefill charged as prompt work at step rate
        return Candidate.from_analysis(
            payload["analysis"], backend=ep.backend, arch=ep.arch,
            n_chips=ep.n_chips,
            scale=req.max_gen + req.prompt_len / 8.0,
            plan_key=ep.plan.structural_key() if ep.plan is not None
            else None,
            ref=ep), "scored"

    # ----------------------------------------------------------- routing
    def route(self, req: Request) -> RoutingDecision:
        """Choose an endpoint for one request (does not dispatch — call
        :meth:`dispatch` on an accepted decision to commit it).

        Health gating: quarantined (and draining) endpoints are skipped
        outright; a probing endpoint is considered only while its
        half-open probe quota has room; a degraded endpoint stays rankable
        but its candidate is penalized by ``HealthConfig.degraded_penalty``
        — traffic shifts away gradually instead of falling off a cliff.

        When a tracer is enabled, each decision records one ``serve/route``
        span carrying a per-endpoint *explain* record — the selection
        rationale as data (lint-pruned / cold-lookup / quarantined /
        draining / scored-with-time)."""
        with get_tracer().span("route", cat="serve", track="router",
                               rid=req.rid) as span:
            decision, explain = self._route(req)
            span.set(reason=decision.reason,
                     endpoint=decision.endpoint.name
                     if decision.endpoint is not None else None,
                     considered=decision.considered,
                     service_time_s=decision.service_time_s,
                     explain=explain)
        return decision

    def _route(self, req: Request
               ) -> Tuple[RoutingDecision, List[Dict]]:
        self.metrics.on_submit(req.rid, req.arrival_s, arch=req.arch)
        cands = []
        explain: List[Dict] = []
        unavailable = 0
        for ep in self.endpoints:
            health = self.health.get(ep.name)
            if ep.draining or (health is not None and not health.available):
                unavailable += 1
                verdict = "draining" if ep.draining else \
                    ("quarantined" if health.state == QUARANTINED
                     else "probe-quota")
                explain.append({"endpoint": ep.name, "verdict": verdict})
                continue
            cand, verdict = self._score_endpoint(ep, req)
            if cand is None:
                explain.append({"endpoint": ep.name, "verdict": verdict})
                continue
            if health is not None and health.state == DEGRADED:
                pen = health.penalty
                cand.best_time_s *= pen
                if cand.mesh_time_s is not None:
                    cand.mesh_time_s *= pen
                if cand.energy_j is not None:
                    cand.energy_j *= pen
                cand.info["health"] = DEGRADED
                verdict = "scored-degraded"
            explain.append({"endpoint": ep.name, "verdict": verdict,
                            "time_s": cand.best_time_s,
                            "watts": cand.avg_watts})
            cands.append(cand)
        if not cands:
            reason = "endpoint quarantined" \
                if unavailable == len(self.endpoints) and unavailable > 0 \
                else "no feasible endpoint"
            self.metrics.on_reject(req.rid, reason)
            return RoutingDecision(req.rid, None, reason=reason), explain
        headroom = None
        if self.power_budget_w is not None:
            headroom = self.power_budget_w - self.fleet_draw_w
        ranked = self.policy.rank(cands, power_budget_w=headroom)
        ranked_eps = {c.ref.name for c in ranked}
        for ex in explain:
            if ex["verdict"].startswith("scored") \
                    and ex["endpoint"] not in ranked_eps:
                ex["verdict"] = "over-budget"
        if not ranked:
            self.metrics.on_reject(req.rid, "power budget saturated")
            return RoutingDecision(req.rid, None,
                                   reason="power budget saturated",
                                   considered=len(cands)), explain
        if req.deadline_s is not None:
            slow = [c for c in ranked if c.best_time_s > req.deadline_s]
            slow_eps = {c.ref.name for c in slow}
            for ex in explain:
                if ex["endpoint"] in slow_eps \
                        and ex["verdict"].startswith("scored"):
                    ex["verdict"] = "slo-infeasible"
            ranked = [c for c in ranked if c.best_time_s <= req.deadline_s]
            if not ranked:
                self.metrics.on_reject(req.rid, "SLO infeasible")
                return RoutingDecision(req.rid, None,
                                       reason="SLO infeasible",
                                       considered=len(cands)), explain
        for cand in ranked:
            if cand.ref.free_slots > 0:
                for ex in explain:
                    if ex["endpoint"] == cand.ref.name:
                        ex["verdict"] = "chosen"
                return RoutingDecision(
                    req.rid, cand.ref, reason="ok",
                    service_time_s=cand.best_time_s,
                    energy_j=cand.energy_j, avg_watts=cand.avg_watts,
                    considered=len(cands)), explain
        self.metrics.on_reject(req.rid, "all slots busy")
        return RoutingDecision(req.rid, None, reason="all slots busy",
                               considered=len(cands)), explain
