"""Online fleet control: close the plan -> serve -> observe -> replan loop.

The source paper verifies an offload destination once, offline; the
mixed-destination environment it targets keeps changing after selection —
machines die, slow down, or start returning wrong results.  This module is
the controller that keeps the serve-time system honest:

  * :class:`Fault` / :class:`FaultInjector` — pluggable fault plans on the
    same virtual tick clock the engine uses (``ContinuousBatcher.tick_s``),
    so chaos scenarios are byte-for-byte reproducible: an endpoint dies at
    tick T, runs kx slower for a window, returns a wrong result (the
    online form of a verification failure), or spikes its power draw.
  * :class:`FleetController` — folds observed per-arch load and realized
    draw from :class:`~repro_torch.serve.ServeMetrics` back into the
    :class:`~repro_torch.fleet.FleetApp` estimates, calls
    :meth:`~repro_torch.fleet.FleetPlanner.replan` on quarantine / degradation /
    elastic-resize events, and migrates by *draining* endpoints through
    the Router's admission ledger — in-flight requests always complete,
    pinned by test: zero dropped, zero double-completed across a
    migration, ``fleet_draw_w`` never negative.
  * :class:`ControlLoop` — a deterministic tick simulator wiring Router,
    FaultInjector and FleetController together; the substrate of
    ``tests/test_torch_control.py`` and ``chip_smoke.py``'s fleet phase.

The whole loop re-scores through :class:`~repro_torch.core.plan_lookup.PlanLookup`
+ :meth:`Candidate.from_analysis <repro_torch.core.candidates.Candidate
.from_analysis>` only — zero new traces or launches, pinned by a
trace-poisoned test exactly like the router's and the fleet planner's.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.fleet.placement import (FleetApp, FleetPlanner, Placement,
                                         observed_apps)
from repro_torch.obs import get_tracer
from repro_torch.serve.batching import DEFAULT_TICK_S
from repro_torch.serve.health import DEGRADED, HEALTHY, QUARANTINED
from repro_torch.serve.request import Request
from repro_torch.serve.router import Endpoint, Router, RoutingDecision

KILL = "kill"
LATENCY = "latency"
WRONG_RESULT = "wrong_result"
POWER_SPIKE = "power_spike"

FAULT_KINDS = (KILL, LATENCY, WRONG_RESULT, POWER_SPIKE)


@dataclass(frozen=True)
class Fault:
    """One planned fault: ``endpoint`` misbehaves as ``kind`` from
    ``at_tick`` (inclusive) to ``until_tick`` (exclusive; None = forever).

    ``factor`` is the latency multiplier for ``latency`` faults and the
    added watts for ``power_spike`` faults; ignored otherwise.
    """
    kind: str
    endpoint: str
    at_tick: int
    until_tick: Optional[int] = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.until_tick is not None and self.until_tick <= self.at_tick:
            raise ValueError(f"empty fault window "
                             f"[{self.at_tick}, {self.until_tick})")

    def active(self, tick: int) -> bool:
        return tick >= self.at_tick and \
            (self.until_tick is None or tick < self.until_tick)


class FaultInjector:
    """Pure function of (endpoint, tick) -> fault effects.

    Holds a static fault plan; queries never mutate state, so any chaos
    scenario replays identically from the same plan and trace.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = list(faults)

    def add(self, fault: Fault) -> "FaultInjector":
        self.faults.append(fault)
        return self

    def _active(self, endpoint: str, tick: int, kind: str):
        for f in self.faults:
            if f.kind == kind and f.endpoint == endpoint and f.active(tick):
                yield f

    def is_dead(self, endpoint: str, tick: int) -> bool:
        """Requests in flight on a dead endpoint fail; new ones will too."""
        return any(True for _ in self._active(endpoint, tick, KILL))

    def latency_factor(self, endpoint: str, tick: int) -> float:
        """Multiplier on service time (overlapping windows compound)."""
        out = 1.0
        for f in self._active(endpoint, tick, LATENCY):
            out *= f.factor
        return out

    def wrong_result(self, endpoint: str, tick: int) -> bool:
        """The endpoint completes but its output fails verification."""
        return any(True for _ in self._active(endpoint, tick, WRONG_RESULT))

    def power_spike_w(self, endpoint: str, tick: int) -> float:
        """Extra observed watts beyond the modeled draw."""
        return sum(f.factor for f in self._active(endpoint, tick,
                                                  POWER_SPIKE))


class FleetController:
    """Fold serve-time observations back into fleet placement.

    Owns three feedback paths, all on the deterministic tick clock:

      * **observe** — :meth:`on_complete` accumulates per-arch completed
        counts; :meth:`observed_apps` rewrites the declared
        ``FleetApp.load_rps`` estimates with observed requests/s (via
        :func:`repro_torch.fleet.observed_apps`) before every replan.
      * **replan** — :meth:`step` watches every endpoint's health
        transitions; a new quarantine triggers
        :meth:`FleetPlanner.replan` with that endpoint's pool backend
        failed (survivors stay pinned), a degradation or an elastic
        resize triggers a full re-plan over the currently usable pool.
      * **migrate** — when a replan stops using a pool backend the
        previous placement used, its healthy endpoints are *drained*
        (:meth:`Router.drain`): no new dispatches, in-flight requests
        complete through the admission ledger, and :meth:`step` removes
        the endpoint only once :meth:`Router.drained` reports the ledger
        empty.  Quarantined endpoints are never drained — their half-open
        probes are the path back into service.
    """

    def __init__(self, router: Router, planner: FleetPlanner,
                 apps: Sequence[FleetApp], *,
                 placement: Optional[Placement] = None,
                 tick_s: float = DEFAULT_TICK_S,
                 pool_name_of: Optional[Callable[[Endpoint], str]] = None):
        self.router = router
        self.planner = planner
        self.apps = list(apps)
        self.placement = placement
        self.tick_s = float(tick_s)
        self.pool_name_of = pool_name_of if pool_name_of is not None \
            else (lambda ep: getattr(ep.backend, "name", ep.name))
        self.events: List[Dict] = []
        self.replans = 0
        # per-arch completion observations: n requests over [first, last]
        self._obs: Dict[str, Dict[str, float]] = {}
        # realized energy per completed request (arch -> joules, count)
        self._seen_transitions: Dict[str, int] = {}
        self._prev_used: Optional[set] = \
            set(placement.by_app.values()) if placement is not None else None

    # ------------------------------------------------------------- observe
    def on_complete(self, req: Request, endpoint: str, latency_s: float,
                    tick: int):
        """One request finished service: feed the per-arch load estimate."""
        rec = self._obs.setdefault(
            req.arch, {"n": 0.0, "first": float(tick), "last": float(tick)})
        rec["n"] += 1.0
        rec["last"] = float(tick)

    def observed_load_rps(self) -> Dict[str, float]:
        """Observed requests/s per arch over each arch's completion span."""
        loads: Dict[str, float] = {}
        for arch, rec in self._obs.items():
            span_s = max(rec["last"] - rec["first"], 1.0) * self.tick_s
            loads[arch] = rec["n"] / span_s
        return loads

    def observed_apps(self) -> List[FleetApp]:
        """The declared apps with observed load folded in (estimates stand
        in where nothing completed yet)."""
        return observed_apps(self.apps, self.observed_load_rps())

    # -------------------------------------------------------------- replan
    def _usable_mask(self) -> List[bool]:
        """Pool backends that currently have at least one endpoint neither
        quarantined nor draining (backends with no endpoint at all stay
        usable: standby capacity the planner may call up)."""
        state: Dict[str, bool] = {}
        for ep in self.router.endpoints:
            pool = self.pool_name_of(ep)
            h = self.router.health.get(ep.name)
            ok = not ep.draining and \
                (h is None or h.state != QUARANTINED)
            state[pool] = state.get(pool, False) or ok
        return [state.get(pb.name, True) for pb in self.planner.pool]

    def replan(self, tick: int, failed: Optional[str] = None) -> Placement:
        """Re-place the fleet from observed load.  ``failed`` names a pool
        backend that just dropped: survivors stay pinned
        (:meth:`FleetPlanner.replan`); otherwise a full plan runs over the
        usable pool.  Always followed by drain-based migration."""
        with get_tracer().span("replan", cat="control", track="control",
                               tick=tick, failed=failed) as span:
            apps = self.observed_apps()
            # verdicts may have changed since the last plan (a wrong result
            # published a failure): the planner's memo must not outlive them
            self.planner._cand_cache.clear()
            pool_names = {pb.name for pb in self.planner.pool}
            if failed is not None and failed in pool_names \
                    and self.placement is not None:
                placement = self.planner.replan(apps, self.placement,
                                                failed)
            else:
                placement = self.planner.plan(apps,
                                              usable=self._usable_mask())
            self.replans += 1
            self.events.append({"tick": tick, "event": "replan",
                                "failed": failed,
                                "feasible": placement.feasible,
                                "by_app": dict(placement.by_app),
                                "fleet_draw_w": placement.fleet_draw_w})
            self._migrate(tick, placement)
            self.placement = placement
            self._prev_used = set(placement.by_app.values())
            span.set(feasible=placement.feasible,
                     by_app=dict(placement.by_app),
                     fleet_draw_w=placement.fleet_draw_w)
        return placement

    def _migrate(self, tick: int, placement: Placement):
        """Drain healthy endpoints on pool backends the previous placement
        used but the new one does not.  Never drains quarantined or
        probing endpoints (recovery owns those) and never drops in-flight
        work — the ledger keeps every admitted request completable."""
        if self._prev_used is None:
            return
        freed = self._prev_used - set(placement.by_app.values())
        for ep in list(self.router.endpoints):
            if self.pool_name_of(ep) not in freed or ep.draining:
                continue
            h = self.router.health.get(ep.name)
            if h is not None and h.state not in (HEALTHY, DEGRADED):
                continue
            self.router.drain(ep.name)
            in_flight = self.router.in_flight_of(ep.name)
            self.events.append({"tick": tick, "event": "drain",
                                "endpoint": ep.name,
                                "in_flight": in_flight})
            get_tracer().event("drain", cat="control", track="control",
                               tick=tick, endpoint=ep.name,
                               in_flight=in_flight)

    # ---------------------------------------------------------------- step
    def step(self, tick: int):
        """One control tick: advance every circuit timer, react to new
        health transitions, finalize completed drains."""
        for h in self.router.health.values():
            h.on_tick(tick)
        quarantined: List[str] = []
        degraded = False
        for name in list(self.router.health):
            h = self.router.health[name]
            seen = self._seen_transitions.get(name, 0)
            for tr in h.transitions[seen:]:
                self.events.append({"tick": tick, "event": "health",
                                    "endpoint": name, **tr})
                if tr["to"] == QUARANTINED:
                    quarantined.append(name)
                elif tr["to"] == DEGRADED:
                    degraded = True
            self._seen_transitions[name] = len(h.transitions)
        for name in quarantined:
            ep = self.router.endpoint(name)
            pool = self.pool_name_of(ep) if ep is not None else None
            self.replan(tick, failed=pool)
        if degraded and not quarantined:
            self.replan(tick)
        for ep in list(self.router.endpoints):
            if ep.draining and self.router.drained(ep.name):
                self.router.remove_endpoint(ep.name)
                self.events.append({"tick": tick, "event": "removed",
                                    "endpoint": ep.name})
                get_tracer().event("migrated", cat="control",
                                   track="control", tick=tick,
                                   endpoint=ep.name)

    # -------------------------------------------------------------- resize
    def on_resize(self, event) -> Placement:
        """An elastic capacity change (:class:`repro_torch.runtime.elastic
        .ResizeEvent`): log it and re-plan over the usable pool."""
        self.events.append({"tick": event.tick, "event": "resize",
                            "n_before": event.n_before,
                            "n_after": event.n_after})
        return self.replan(event.tick)


class ControlLoop:
    """Deterministic tick simulator closing route -> dispatch -> observe.

    Each tick, in a fixed order so runs replay exactly:

      1. **arrivals** — requests whose arrival tick passed join the queue;
      2. **failures** — in-flight requests on endpoints the
         :class:`FaultInjector` declares dead fail now
         (:meth:`Router.fail` feeds the circuit breaker) and re-queue
         (up to ``max_retries``, then they count as *dropped*);
      3. **completions** — in-flight requests whose service time elapsed
         complete; a ``wrong_result`` fault turns the completion into a
         failure *and* publishes the failure verdict into the lookup
         (``register_failure``), so every later scoring pass — router and
         fleet planner alike — statically refuses that destination;
      4. **routing** — queued requests route and dispatch; the modeled
         service time (stretched by any active latency fault) schedules
         the completion tick.  Refused requests stay queued;
      5. **control** — ``controller.step`` (or bare health ``on_tick``):
         circuit timers, replans, drain finalization.

    ``summary()`` reports completions, drops, double completions (must be
    zero — the ledger is idempotent), refusal counts, the fleet-draw
    trace, and per-endpoint dispatch counts.
    """

    def __init__(self, router: Router, requests: Sequence[Request], *,
                 controller: Optional[FleetController] = None,
                 injector: Optional[FaultInjector] = None,
                 tick_s: float = DEFAULT_TICK_S, max_retries: int = 3,
                 max_ticks: int = 10_000):
        self.router = router
        self.controller = controller
        self.injector = injector if injector is not None else FaultInjector()
        self.tick_s = float(tick_s)
        self.max_retries = int(max_retries)
        self.max_ticks = int(max_ticks)
        self._pending: List[Request] = sorted(
            requests, key=lambda r: (r.arrival_s, r.rid))
        self.queue: Deque[Request] = deque()
        # rid -> (decision, dispatch tick, completion tick, request)
        self.inflight: Dict[str, Tuple[RoutingDecision, int, int, Request]]\
            = {}
        self.completed_ok = 0
        self.failed = 0
        self.dropped: List[str] = []
        self.double_completed = 0
        self.dispatches: Dict[str, int] = {}
        self.dispatch_log: List[Tuple[int, str, str]] = []
        self.draw_trace: List[float] = []
        self.ticks_run = 0

    # ------------------------------------------------------------ plumbing
    def _requeue(self, req: Request):
        req.retries += 1
        if req.retries > self.max_retries:
            self.dropped.append(req.rid)
        else:
            self.queue.appendleft(req)      # retries route before new work

    def _fail(self, rid: str, tick: int, reason: str):
        decision, t0, _, req = self.inflight.pop(rid)
        self.failed += 1
        get_tracer().complete_span(
            "request", t0 * self.tick_s, tick * self.tick_s, cat="serve",
            track=f"endpoint:{decision.endpoint.name}", rid=rid, ok=False,
            reason=reason, retries=req.retries)
        self.router.fail(decision, reason=reason, now_s=tick * self.tick_s)
        self._requeue(req)

    # ---------------------------------------------------------------- tick
    def _tick(self, tick: int):
        # pin the tracer to the virtual clock: every record this tick
        # emits — health transitions, replans, GA generations inside a
        # replan — is stamped with the tick time, so a replayed scenario
        # produces a byte-identical event log
        get_tracer().set_time(tick * self.tick_s)
        # 1. arrivals
        while self._pending and \
                self._pending[0].arrival_s <= tick * self.tick_s + 1e-12:
            self.queue.append(self._pending.pop(0))
        # 2. failures: endpoints that are dead right now kill their flight
        for rid in list(self.inflight):
            name = self.inflight[rid][0].endpoint.name
            if self.injector.is_dead(name, tick):
                self._fail(rid, tick, "endpoint died")
        # 3. completions
        for rid in list(self.inflight):
            decision, t0, t1, req = self.inflight[rid]
            if t1 > tick:
                continue
            name = decision.endpoint.name
            if self.injector.wrong_result(name, tick):
                # the online analogue of a verification failure: fail the
                # request AND publish the verdict so every later scoring
                # pass refuses this destination statically
                self.router.lookup.register_failure(
                    decision.endpoint.lookup_key(),
                    f"wrong result observed at tick {tick}")
                self._fail(rid, tick, "wrong result")
                continue
            del self.inflight[rid]
            latency_s = (tick - t0) * self.tick_s
            if not self.router.complete(decision, latency_s=latency_s,
                                        now_s=tick * self.tick_s):
                self.double_completed += 1
                continue
            self.completed_ok += 1
            get_tracer().complete_span(
                "request", t0 * self.tick_s, tick * self.tick_s,
                cat="serve", track=f"endpoint:{name}", rid=rid, ok=True,
                latency_s=latency_s, energy_j=decision.energy_j)
            if self.controller is not None:
                self.controller.on_complete(req, name, latency_s, tick)
        # 4. routing
        still_queued: List[Request] = []
        while self.queue:
            req = self.queue.popleft()
            decision = self.router.route(req)
            if not decision.accepted:
                still_queued.append(req)    # wait; circuit may close later
                continue
            self.router.dispatch(decision)
            name = decision.endpoint.name
            stretch = self.injector.latency_factor(name, tick)
            service = (decision.service_time_s or self.tick_s) * stretch
            n_ticks = max(int(math.ceil(service / self.tick_s)), 1)
            self.inflight[req.rid] = (decision, tick, tick + n_ticks, req)
            self.dispatches[name] = self.dispatches.get(name, 0) + 1
            self.dispatch_log.append((tick, req.rid, name))
        self.queue.extend(still_queued)
        # 5. observe draw (modeled admitted draw + any injected spike)
        spike = sum(self.injector.power_spike_w(ep.name, tick)
                    for ep in self.router.endpoints)
        self.draw_trace.append(self.router.fleet_draw_w + spike)
        # 6. control
        if self.controller is not None:
            self.controller.step(tick)
        else:
            for h in self.router.health.values():
                h.on_tick(tick)
        # one instant per tick with the cumulative counters the post-mortem
        # trends on (cache hit-rate, joules/request, fleet draw)
        stats = self.router.lookup.stats
        get_tracer().event(
            "tick", cat="loop", track="loop", tick=tick,
            completed=self.completed_ok, failed=self.failed,
            queued=len(self.queue), inflight=len(self.inflight),
            draw_w=self.draw_trace[-1],
            energy_j=self.router.metrics.total_energy_j,
            lookups=stats.lookups, lookup_hits=stats.hits)

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        for tick in range(self.max_ticks):
            self._tick(tick)
            self.ticks_run = tick + 1
            if not self._pending and not self.inflight and not self.queue:
                break
            # queued requests with everything quarantined keep waiting:
            # the circuit's half-open probes are their way back in, and
            # max_ticks bounds the wait deterministically
        return self.summary()

    def summary(self) -> dict:
        return {
            "ticks": self.ticks_run,
            "completed": self.completed_ok,
            "failed": self.failed,
            "dropped": list(self.dropped),
            "double_completed": self.double_completed,
            "unrouted": len(self.queue),
            "dispatches": dict(self.dispatches),
            "refusals": dict(self.router.metrics.refusals),
            "fleet_draw_w_max": max(self.draw_trace, default=0.0),
            "fleet_draw_w_min": min(self.draw_trace, default=0.0),
            "events": list(self.controller.events)
            if self.controller is not None else [],
        }
