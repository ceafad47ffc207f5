"""Fleet placement: N applications across one shared destination pool.

The source paper places one application on one destination; the
mixed-destination study (arXiv 2010.08009) and the power follow-up (arXiv
2110.11520) frame the operator's real problem as many applications sharing
one heterogeneous pool under a datacenter power cap.  This module is that
planner:

  * the **genome** is the assignment vector — one gene per app, whose
    value is an index into the backend pool (searched by the same
    ``run_ga`` the offload planner uses, with a greedy bin-packing seed
    so the GA starts from a feasible solution instead of rediscovering
    one);
  * every (app, backend) pair is scored **entirely from warm state**: the
    :class:`~repro_torch.core.plan_lookup.PlanLookup` payload that
    ``plan_offload(..., publish=lookup)`` published, lifted through
    :meth:`Candidate.from_analysis
    <repro_torch.core.candidates.Candidate.from_analysis>` — roofline
    arithmetic plus an :class:`~repro_torch.power.EnergyModel` charge, zero new
    traces or launches (pinned by a trace-poisoned test, like the router's);
  * a published verification **failure** makes the pair infeasible — the
    planner can never place an app on a destination the verification
    environment proved wrong;
  * **capacity** is enforced per backend (slot-equivalents of offered
    load, resident memory bytes) and globally (``power_budget_w`` over the
    summed utilization-weighted draw — :func:`repro_torch.power.fleet_draw_w`,
    the same summation the Router's admission headroom uses);
  * :meth:`FleetPlanner.replan` is the fault path: when a backend drops,
    apps placed elsewhere stay pinned and only the displaced apps are
    re-placed (greedy first, full GA re-plan when greedy cannot fit
    them) — the placement-level analogue of
    ``repro_torch.runtime.fault_tolerance``'s degrade-and-continue contract.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.backends import get_policy
from repro_torch.core.candidates import Candidate
from repro_torch.core.ga import Evaluation, GAConfig, run_ga
from repro_torch.core.plan_lookup import PlanLookup, serve_key
from repro_torch.obs import get_tracer
from repro_torch.power import fleet_draw_w


@dataclass(frozen=True)
class FleetApp:
    """One application to place: its offered load and working-set size."""
    name: str
    arch: str                       # lookup identity (the app/model name)
    load_rps: float = 1.0           # offered requests per second
    tokens_per_request: float = 32.0  # decode steps per request (scale)
    memory_bytes: float = 0.0       # resident bytes while placed
    plan: object = None             # optional serving Plan (folds into key)


@dataclass(frozen=True)
class PoolBackend:
    """One pooled destination: a backend's machine with fixed capacity."""
    name: str
    backend: object                 # repro_torch.backends.Backend (duck-typed)
    n_chips: int = 1
    slots: float = 4.0              # slot-equivalents of concurrent load
    memory_bytes: float = float("inf")

    def lookup_key(self, app: FleetApp):
        return serve_key(getattr(self.backend, "name", self.name),
                         app.arch, app.plan)


@dataclass
class Placement:
    """One evaluated assignment of every app to a pool backend."""
    assignment: Tuple[int, ...]             # app index -> pool index
    by_app: Dict[str, str]                  # app name -> backend name
    feasible: bool
    objective: float                        # policy score, load-weighted
    fleet_draw_w: float                     # summed utilization-weighted W
    joules_per_request: float               # load-weighted mean energy_j
    violations: List[str] = field(default_factory=list)
    candidates: Dict[str, Candidate] = field(default_factory=dict)
    info: Dict = field(default_factory=dict)


class FleetPlanner:
    """Assign apps to pooled backends from warm lookup state only.

    ``policy`` ranks each (app, backend) Candidate exactly as every other
    selection site does; the placement objective is the load-weighted sum
    of the policy's per-app scores (for the ``power`` policy that is
    joules/request x requests/s = fleet watts).
    """

    def __init__(self, pool: Sequence[PoolBackend], lookup: PlanLookup, *,
                 policy=None, power_budget_w: Optional[float] = None,
                 ga_cfg: Optional[GAConfig] = None):
        if not pool:
            raise ValueError("fleet planner needs at least one backend")
        names = [b.name for b in pool]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pool backend names: {names}")
        self.pool = list(pool)
        self.lookup = lookup
        self.policy = get_policy(policy)
        self.power_budget_w = power_budget_w
        self.ga_cfg = ga_cfg
        self._cand_cache: Dict[Tuple, Optional[Candidate]] = {}

    # ------------------------------------------------------------ scoring
    def candidate(self, app: FleetApp,
                  pb: PoolBackend) -> Optional[Candidate]:
        """The warm Candidate for placing ``app`` on ``pb``, or None when
        the pair is unplaceable (cold lookup or a published verification
        failure).  Pure arithmetic — memoized per (app, backend)."""
        key = (app.name, pb.name)
        if key not in self._cand_cache:
            payload = self.lookup.lookup(pb.lookup_key(app))
            if not self.lookup.usable(payload):
                self._cand_cache[key] = None
            else:
                self._cand_cache[key] = Candidate.from_analysis(
                    payload["analysis"], backend=pb.backend, arch=app.arch,
                    n_chips=pb.n_chips, scale=app.tokens_per_request,
                    plan_key=app.plan.structural_key()
                    if app.plan is not None else None,
                    ref=(app, pb))
        return self._cand_cache[key]

    @staticmethod
    def _utilization(app: FleetApp, cand: Candidate) -> float:
        """Slot-equivalents of offered load: requests/s x service seconds
        (>1 means the app alone needs more than one slot's worth)."""
        return app.load_rps * cand.best_time_s

    @staticmethod
    def _draw_w(app: FleetApp, cand: Candidate) -> Optional[float]:
        """Utilization-weighted modeled draw: the backend serves this app
        for ``min(u, slots)`` slot-equivalents, each at ``avg_watts``."""
        if cand.avg_watts is None:
            return None
        return cand.avg_watts * min(
            FleetPlanner._utilization(app, cand), 1.0)

    # --------------------------------------------------------- evaluation
    def evaluate(self, apps: Sequence[FleetApp],
                 genes: Tuple[int, ...],
                 usable: Optional[Sequence[bool]] = None) -> Placement:
        """Score one assignment vector.  Infeasibility (unplaceable pair,
        slot/memory overflow, power-cap breach, masked backend) is recorded
        in ``violations`` — the GA sees it as an incorrect individual."""
        violations: List[str] = []
        cands: Dict[str, Candidate] = {}
        by_app: Dict[str, str] = {}
        slot_load: Dict[str, float] = {b.name: 0.0 for b in self.pool}
        mem_load: Dict[str, float] = {b.name: 0.0 for b in self.pool}
        draws: List[Optional[float]] = []
        objective = 0.0
        joules = 0.0
        load = 0.0
        for i, app in enumerate(apps):
            pb = self.pool[genes[i]]
            by_app[app.name] = pb.name
            if usable is not None and not usable[genes[i]]:
                violations.append(f"{app.name}: backend {pb.name} is down")
                continue
            cand = self.candidate(app, pb)
            if cand is None:
                violations.append(
                    f"{app.name}: no warm verified plan on {pb.name} "
                    f"(cold or published failure)")
                continue
            cands[app.name] = cand
            slot_load[pb.name] += self._utilization(app, cand)
            mem_load[pb.name] += app.memory_bytes
            draws.append(self._draw_w(app, cand))
            objective += app.load_rps * self.policy.score_candidate(cand)
            if cand.energy_j is not None:
                joules += app.load_rps * cand.energy_j
            load += app.load_rps
        for pb in self.pool:
            if slot_load[pb.name] > pb.slots + 1e-9:
                violations.append(
                    f"{pb.name}: offered load {slot_load[pb.name]:.2f} "
                    f"slot-equivalents > {pb.slots:g} slots")
            if mem_load[pb.name] > pb.memory_bytes:
                violations.append(
                    f"{pb.name}: resident {mem_load[pb.name]:.3g} B "
                    f"> {pb.memory_bytes:.3g} B")
        draw = fleet_draw_w(draws)
        if self.power_budget_w is not None and draw > self.power_budget_w:
            violations.append(f"fleet draw {draw:.1f} W > budget "
                              f"{self.power_budget_w:g} W")
        return Placement(
            assignment=tuple(genes), by_app=by_app,
            feasible=not violations, objective=objective,
            fleet_draw_w=draw,
            joules_per_request=joules / load if load > 0 else 0.0,
            violations=violations, candidates=cands,
            info={"slot_load": slot_load, "mem_load": mem_load})

    # ------------------------------------------------------------- greedy
    def greedy(self, apps: Sequence[FleetApp],
               usable: Optional[Sequence[bool]] = None,
               pinned: Optional[Dict[int, int]] = None
               ) -> Optional[Tuple[int, ...]]:
        """Greedy bin-packing seed: biggest apps first (by offered work),
        each onto the best-scoring backend that still fits it.  ``pinned``
        maps app index -> pool index for apps that must stay put (the
        replan path).  Returns None when some app fits nowhere."""
        pinned = pinned or {}
        genes: Dict[int, int] = dict(pinned)
        slot_left = {b.name: b.slots for b in self.pool}
        mem_left = {b.name: b.memory_bytes for b in self.pool}
        draw = 0.0
        order: List[Tuple[float, int]] = []
        for i, app in enumerate(apps):
            work = [self._utilization(app, c)
                    for c in (self.candidate(app, b) for b in self.pool)
                    if c is not None]
            order.append((max(work) if work else 0.0, i))

        def commit(i: int, j: int) -> bool:
            nonlocal draw
            app, pb = apps[i], self.pool[j]
            cand = self.candidate(app, pb)
            if cand is None:
                return False
            u = self._utilization(app, cand)
            if u > slot_left[pb.name] + 1e-9:
                return False
            if app.memory_bytes > mem_left[pb.name]:
                return False
            d = self._draw_w(app, cand) or 0.0
            if self.power_budget_w is not None \
                    and draw + d > self.power_budget_w:
                return False
            slot_left[pb.name] -= u
            mem_left[pb.name] -= app.memory_bytes
            draw += d
            return True

        for i, j in pinned.items():
            if not commit(i, j):
                return None
        for _, i in sorted(order, reverse=True):
            if i in genes:
                continue
            choices = []
            for j, pb in enumerate(self.pool):
                if usable is not None and not usable[j]:
                    continue
                cand = self.candidate(apps[i], pb)
                if cand is None:
                    continue
                choices.append((self.policy.score_candidate(cand), j))
            placed = False
            for _, j in sorted(choices):
                if commit(i, j):
                    genes[i] = j
                    placed = True
                    break
            if not placed:
                return None
        return tuple(genes[i] for i in range(len(apps)))

    # --------------------------------------------------------------- plan
    def plan(self, apps: Sequence[FleetApp],
             usable: Optional[Sequence[bool]] = None) -> Placement:
        """Place every app: GA over assignment vectors, seeded with the
        greedy solution.  Zero traces — every fitness call is lookup +
        roofline arithmetic."""
        if not apps:
            raise ValueError("nothing to place")
        with get_tracer().span("plan", cat="fleet", track="fleet",
                               n_apps=len(apps),
                               n_pool=len(self.pool)) as span:
            seed = self.greedy(apps, usable=usable)
            import dataclasses
            cfg = self.ga_cfg or GAConfig.for_gene_length(max(len(apps), 2))
            # the genome is always one pool index per app — the planner
            # owns the cardinalities whatever the caller's cfg says
            cfg = dataclasses.replace(
                cfg, cardinalities=[len(self.pool)] * len(apps))

            def fitness(genes: Tuple[int, ...]) -> Evaluation:
                p = self.evaluate(apps, genes, usable=usable)
                if not p.feasible:
                    return Evaluation(time_s=cfg.penalty_s, correct=False,
                                      info={"violations": p.violations})
                return Evaluation(time_s=max(p.objective, 1e-12),
                                  correct=True, info={"placement": p})

            res = run_ga(len(apps), fitness, cfg,
                         seed_population=[seed] if seed is not None
                         else None)
            best = self.evaluate(apps, res.best_genes, usable=usable)
            best.info["ga"] = {"n_measurements": res.n_measurements,
                               "generations": len(res.history)}
            if seed is not None:
                greedy_p = self.evaluate(apps, seed, usable=usable)
                best.info["greedy"] = {"assignment": seed,
                                       "objective": greedy_p.objective}
            span.set(feasible=best.feasible, objective=best.objective,
                     fleet_draw_w=best.fleet_draw_w,
                     by_app=dict(best.by_app))
        return best

    # ------------------------------------------------------------- replan
    def replan(self, apps: Sequence[FleetApp], placement: Placement,
               failed_backend: str) -> Placement:
        """Degrade-and-continue after ``failed_backend`` drops: apps placed
        elsewhere stay pinned, the displaced apps are greedily re-placed
        over the surviving pool; when greedy cannot fit them the whole
        fleet is re-planned (GA) over the surviving backends.  Mirrors
        ``repro_torch.runtime.fault_tolerance``: shrink, keep serving, never
        hand back a placement that uses the dead destination."""
        idx = {b.name: j for j, b in enumerate(self.pool)}
        if failed_backend not in idx:
            raise ValueError(f"unknown backend {failed_backend!r}")
        with get_tracer().span("replan", cat="fleet", track="fleet",
                               failed=failed_backend,
                               n_apps=len(apps)) as span:
            usable = [b.name != failed_backend for b in self.pool]
            pinned = {i: placement.assignment[i]
                      for i, app in enumerate(apps)
                      if placement.by_app.get(app.name) != failed_backend}
            seed = self.greedy(apps, usable=usable, pinned=pinned)
            if seed is not None:
                out = self.evaluate(apps, seed, usable=usable)
                if out.feasible:
                    out.info["replan"] = {"mode": "pinned-greedy",
                                          "failed": failed_backend}
                    span.set(mode="pinned-greedy", feasible=True,
                             by_app=dict(out.by_app))
                    return out
            out = self.plan(apps, usable=usable)
            out.info["replan"] = {"mode": "full", "failed": failed_backend}
            span.set(mode="full", feasible=out.feasible,
                     by_app=dict(out.by_app))
        return out


def observed_apps(apps: Sequence[FleetApp],
                  loads: Dict[str, float]) -> List[FleetApp]:
    """Fold observed per-arch load back into the fleet's app estimates:
    each app whose ``arch`` appears in ``loads`` gets the observed
    requests/s, split evenly across the apps sharing that arch (the
    router does not attribute requests to apps, only to archs).  Apps
    with no observation keep their declared estimate — the controller's
    plan→serve→observe→replan loop calls this before every replan."""
    import dataclasses
    share: Dict[str, int] = {}
    for app in apps:
        share[app.arch] = share.get(app.arch, 0) + 1
    out: List[FleetApp] = []
    for app in apps:
        if app.arch in loads:
            out.append(dataclasses.replace(
                app, load_rps=loads[app.arch] / share[app.arch]))
        else:
            out.append(app)
    return out


def round_robin(apps: Sequence[FleetApp],
                pool: Sequence[PoolBackend]) -> Tuple[int, ...]:
    """The static baseline the benchmark compares against: app i on
    backend i mod P, capacity- and verdict-blind."""
    return tuple(i % len(pool) for i in range(len(apps)))
