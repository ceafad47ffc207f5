"""Mixed-offloading-destination planner (paper §II.C) — the paper's main
contribution, on top of the pluggable backend API (repro_torch.backends);
the port of ``repro.core.planner``.

The planner does not know the destinations: it iterates the verification
order a :class:`~repro_torch.backends.BackendRegistry` derives from each
backend's declared ``verify_time`` / ``methods`` (for the built-in registry this is
exactly the paper's six verifications:
  ① FB→many-core  ② FB→GPU  ③ FB→FPGA  ④ loops→many-core  ⑤ loops→GPU
  ⑥ loops→FPGA),
delegates each verification to ``backend.search(app, ctx, method)``, and
keeps:
  * early stop as soon as a pattern meets the user's performance and price
    targets,
  * the residual rule — once a function block is offloaded, the loop
    verifications search only the remaining nests.

Final selection is a pluggable :class:`~repro_torch.backends.SelectionPolicy`
(``policy=``): ``host-time`` reproduces the paper's fastest-correct-pattern
rule; ``modeled`` ranks by the mesh-verified roofline time a ``cost_runner``
records (host time where none was recorded); ``price-weighted`` weights by
the destination's relative price; ``power`` / ``edp`` rank by the modeled
energy the planner charges each correct record (repro_torch.power: the
roofline's utilization, or envelope × host-time).  ``power_budget_w`` /
``max_slowdown`` constrain any policy's selection — the power follow-up's
"fastest within the power budget" and "lowest energy within the allowed
slowdown" evaluations.  ``publish`` writes every verdict into a
:class:`~repro_torch.core.plan_lookup.PlanLookup` (the write half of the
search/lookup split).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from repro_torch import device as _device
from repro_torch.backends import (BackendRegistry, SearchContext,
                                  SelectionPolicy, default_registry,
                                  get_policy)
from repro_torch.core import function_blocks
from repro_torch.core.candidates import candidates_from_records, unwrap
from repro_torch.core.ga import GAConfig
from repro_torch.core.measure import TimedRunner
from repro_torch.core.plan_lookup import publish_record
from repro_torch.obs import get_tracer
from repro_torch.power import energy_for_record, envelope_for


@dataclass
class UserTarget:
    target_speedup: Optional[float] = None     # vs single-core reference
    target_time_s: Optional[float] = None
    max_price: Optional[float] = None

    def met(self, time_s: float, ref_time_s: float, price: float) -> bool:
        perf_ok = True
        if self.target_speedup is not None:
            perf_ok = perf_ok and (ref_time_s / max(time_s, 1e-12)
                                   >= self.target_speedup)
        if self.target_time_s is not None:
            perf_ok = perf_ok and time_s <= self.target_time_s
        if self.target_speedup is None and self.target_time_s is None:
            perf_ok = False     # nothing requested => never early-stop
        price_ok = self.max_price is None or price <= self.max_price
        return perf_ok and price_ok


@dataclass
class VerificationRecord:
    order: int
    destination: str
    paper_analogue: str
    method: str                     # function_block | loop
    best_time_s: float
    improvement: float              # ref_time / best_time
    price: float
    n_measurements: int
    verify_elapsed_s: float
    met_target: bool
    choice: Dict[str, str] = field(default_factory=dict)
    note: str = ""
    # False: best_time_s is the configured penalty for a wrong result /
    # timeout — kept as evidence but never pinned, selected or early-stopped
    correct: bool = True
    # set when a mesh verification records the modeled step time under the
    # destination's sharding (plan_offload(cost_runner=...)); its roofline
    # and trace details in mesh_info
    mesh_time_s: Optional[float] = None
    mesh_info: Dict = field(default_factory=dict)
    # verification-cost counters from the search (e.g. the loop GA's
    # choice-keyed measurement memo: measured / reused)
    cache_stats: Dict = field(default_factory=dict)
    # modeled energy of this destination's step (repro_torch.power): from
    # the mesh roofline, else envelope × host-time; None on incorrect /
    # infinite records
    energy_j: Optional[float] = None
    avg_watts: Optional[float] = None
    energy_info: Dict = field(default_factory=dict)


@dataclass
class PlanReport:
    app: str
    ref_time_s: float
    records: List[VerificationRecord]
    selected: Optional[VerificationRecord]
    early_stopped: bool
    policy: str = "host-time"       # name of the selection policy applied

    def summary_rows(self):
        rows = []
        for r in self.records:
            rows.append({
                "app": self.app, "order": r.order,
                "destination": r.paper_analogue, "method": r.method,
                "time_s": round(r.best_time_s, 6),
                "mesh_time_s": (None if r.mesh_time_s is None
                                else round(r.mesh_time_s, 6)),
                "improvement": round(r.improvement, 2),
                "price": r.price, "n_meas": r.n_measurements,
                "correct": r.correct,
                "energy_j": (None if r.energy_j is None
                             else round(r.energy_j, 6)),
                "avg_watts": (None if r.avg_watts is None
                              else round(r.avg_watts, 3)),
                "selected": self.selected is r,
            })
        return rows


def _pin_best_fb(records: List[VerificationRecord],
                 ref_time: float) -> Dict[str, str]:
    """Residual rule state: the winning FB pattern, or {} if none won."""
    fb_recs = [r for r in records
               if r.method == "function_block" and r.correct
               and r.best_time_s < float("inf")]
    if not fb_recs:
        return {}
    best_fb = min(fb_recs, key=lambda r: r.best_time_s)
    if best_fb.best_time_s < ref_time:
        return dict(best_fb.choice)
    return {}


def plan_offload(app, targets: UserTarget, *, seed: int = 0,
                 runner: Optional[TimedRunner] = None,
                 ga_cfg: Optional[GAConfig] = None,
                 small_state=None, inputs=None,
                 registry=None, cost_runner=None,
                 backends: Optional[BackendRegistry] = None,
                 policy: Union[str, SelectionPolicy, None] = None,
                 power_budget_w: Optional[float] = None,
                 max_slowdown: Optional[float] = None,
                 lint_choice=None,
                 publish=None,
                 device=None,
                 ) -> PlanReport:
    """Run the registry's verifications and select a destination.

    ``device`` is where the app runs (default ``cuda``; raises when there
    is no card — pass ``device="cpu"`` to run on the CPU, where the
    FPGA-analogue nests take the kernels' plain versions).  ``inputs`` and
    ``small_state`` default to ``app.make_inputs`` on that device; given
    ones must already live there.  On a card the CUDA kernels are built
    before the reference run, so no measurement pays for ``nvcc``.

    ``backends`` (a :class:`repro_torch.backends.BackendRegistry`) supplies
    the destinations and their search strategies; the default registry
    holds the paper's three.  ``registry`` stays the *function-block*
    registry (paper's DB).

    ``cost_runner`` (a :class:`repro_torch.core.measure.CompiledCostRunner`)
    additionally traces each correct dp / tp winner for the runner's mesh
    (each backend's ``mesh_verify`` hook, :mod:`repro_torch.dist.bridge`)
    and records the modeled step time on the VerificationRecord
    (``mesh_time_s``, ``mesh_info["roofline"]``) — the mixed-destination
    decision then sees the roofline beside the host time.

    ``policy`` names the :class:`~repro_torch.backends.SelectionPolicy`
    ranking the verified destinations (default ``host-time``, the paper's
    rule; ``modeled`` consumes the recorded ``mesh_time_s``; ``power`` /
    ``edp`` the modeled ``energy_j`` charged to every correct record).
    ``power_budget_w`` restricts selection to destinations whose modeled
    average draw fits the budget; ``max_slowdown`` restricts it to
    destinations within the factor of the fastest correct one.

    ``publish`` (a :class:`repro_torch.core.plan_lookup.PlanLookup`) is the
    write half of the search/lookup split: every verification verdict is
    registered under ``serve_key(backend, app)`` — a correct record's
    roofline analysis (its host time where none was recorded), an
    incorrect one as a failure — so a lookup scores destinations without
    ever tracing.

    ``lint_choice`` (repro_torch.analysis) rejects loop-offload choices
    before any measurement: a callable mapping a choice dict to a list of
    :class:`~repro_torch.analysis.Finding`; a choice with an
    error-severity finding is charged the penalty unmeasured.
    """
    dev = _device.resolve(device)
    runner = runner or TimedRunner()
    backends = backends if backends is not None else default_registry()
    pol = get_policy(policy)
    if inputs is None:
        inputs = app.make_inputs(seed=seed, device=dev)
    if small_state is None:
        small_state = app.make_inputs(seed=seed, small=True, device=dev)
    for what, state in (("inputs", inputs), ("small_state", small_state)):
        where = _device.state_device(state)
        if where is not None and (where.type != dev.type or (
                dev.index is not None and where.index != dev.index)):
            raise ValueError(f"plan_offload: {what} live on {where}, the "
                             f"planner runs on {dev}")
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()

    # single-core reference (paper's "processing time by a single core");
    # the measurement already ran the function — reuse its output instead of
    # executing the reference a second time
    ref_fn = app.reference_fn()
    ref_eval = runner.measure(ref_fn, inputs, None)
    ref_out = ref_eval.info.get("output")
    if ref_out is None:
        ref_out = ref_fn(inputs)
    ref_time = ref_eval.time_s

    # FB discovery once (name match + similarity), per paper [41]
    matches = function_blocks.detect(
        app, small_state, registry=registry or function_blocks.REGISTRY)

    ctx = SearchContext(
        runner=runner, inputs=inputs, ref_out=ref_out,
        small_state=small_state, ga_cfg=ga_cfg,
        # one penalty scale for every verification in this run (GA-internal
        # evaluations get it via run_ga; direct measurements get it stamped)
        penalty_s=ga_cfg.penalty_s if ga_cfg is not None else None,
        seed=seed, fb_matches=matches, lint_choice=lint_choice)

    records: List[VerificationRecord] = []
    fb_pinned = False                   # residual rule state
    early = False
    plan_span = get_tracer().span("offload", cat="plan", track="planner",
                                  app=app.name, ref_time_s=ref_time)

    for order, (backend, method) in enumerate(backends.verification_order(),
                                              start=1):
        # residual rule: before the FIRST loop verification, pin the best
        # FB pattern found by the FB verifications — regardless of how they
        # exited (a no-match FPGA FB verification must not skip the pinning
        # of a many-core / GPU FB win).
        if method == "loop" and not fb_pinned:
            fb_pinned = True
            ctx.fixed_choice = _pin_best_fb(records, ref_time)

        with get_tracer().span("verify", cat="plan",
                               track=f"backend:{backend.name}",
                               backend=backend.name, method=method,
                               order=order) as vspan:
            res = backend.search(app, ctx, method=method)
            rec = VerificationRecord(
                order=order, destination=backend.name,
                paper_analogue=backend.paper_analogue, method=method,
                best_time_s=res.best_time_s,
                improvement=ref_time / max(res.best_time_s, 1e-12)
                if res.best_time_s < float("inf") else 0.0,
                price=backend.price, n_measurements=res.n_measurements,
                verify_elapsed_s=res.verify_elapsed_s,
                met_target=res.best_correct and targets.met(
                    res.best_time_s, ref_time, backend.price),
                correct=res.best_correct,
                choice=dict(res.best_choice), note=res.note,
                cache_stats=dict(getattr(res, "cache_stats", {}) or {}))
            records.append(rec)

            # mesh bridge: trace the winner for the cost runner's mesh
            # through the backend's hook and record the modeled (roofline)
            # step time next to the host timing
            if (cost_runner is not None and rec.correct
                    and rec.best_time_s < float("inf")):
                mesh_ev = backend.mesh_verify(
                    cost_runner, app.build(dict(rec.choice)), inputs)
                if mesh_ev is not None and mesh_ev.correct:
                    rec.mesh_time_s = mesh_ev.time_s
                    rec.mesh_info = dict(mesh_ev.info)

            # energy charge (repro_torch.power): every correct finite record
            # gets the modeled joules/watts the power/edp policies and the
            # power_budget_w constraint consume — from the mesh roofline
            # when the bridge recorded one, envelope × host-time otherwise
            if rec.correct and rec.best_time_s < float("inf"):
                e_rep = energy_for_record(rec, envelope_for(backend))
                if e_rep is not None:
                    rec.energy_j = e_rep.energy_j
                    rec.avg_watts = e_rep.avg_watts
                    rec.energy_info = e_rep.to_dict()

            # search/lookup split: publish this verification into the
            # lookup (correct records warm it; incorrect ones are recorded
            # failures a lookup refuses)
            if publish is not None:
                publish_record(publish, rec, backend, app.name)

            stats = rec.cache_stats
            vspan.set(best_time_s=rec.best_time_s, correct=rec.correct,
                      compile_s=float(stats.get("compile_s",
                                                rec.verify_elapsed_s)),
                      cache_hit=bool(stats.get("reused")
                                     or stats.get("hits")
                                     or stats.get("disk_hits")),
                      energy_j=rec.energy_j,
                      n_measurements=rec.n_measurements,
                      met_target=rec.met_target)

        if rec.met_target:
            early = True
            break

    # selection: delegated to the policy via the Candidate contract
    # (repro_torch.core.candidates); every policy ranks correct patterns
    # only — a penalized wrong result is never the chosen destination (it
    # stays in records as evidence).  unwrap() maps the winner back to the
    # actual VerificationRecord (PlanReport.summary_rows compares by
    # identity).
    cands = candidates_from_records(records, arch=app.name)
    selected = unwrap(pol.select(cands, power_budget_w=power_budget_w,
                                 max_slowdown=max_slowdown))
    plan_span.set(policy=pol.name, early_stopped=early,
                  n_verifications=len(records),
                  selected=selected.destination
                  if selected is not None else None)
    plan_span.finish()
    return PlanReport(app=app.name, ref_time_s=ref_time, records=records,
                      selected=selected, early_stopped=early,
                      policy=pol.name)
