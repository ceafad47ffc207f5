"""Offload-backend protocol: one object per destination bundling identity,
search strategy and mesh-verification hook (paper §II.C made pluggable);
the port of ``repro.backends.base``.

A :class:`Backend` is everything the planner needs to know about one offload
destination:

  * identity — ``key`` (impl key inside ``LoopNest.impls``), ``name``,
    ``paper_analogue``, ``price`` and ``verify_time`` (the paper's relative
    price / verification-cost orderings), ``mesh_role`` (read by the
    mesh bridge, :mod:`repro_torch.dist.bridge`);
  * ``search(app, ctx, method)`` — the verification strategy for this
    destination: a generic function-block apply+measure for
    ``method="function_block"`` and a destination-specific loop search
    (GA, intensity narrowing, …) for ``method="loop"``;
  * ``mesh_verify(cost_runner, fn, inputs)`` — optional hook tracing the
    winning candidate for the cost runner's mesh and returning a modeled
    :class:`~repro_torch.core.ga.Evaluation` (default:
    :func:`repro_torch.dist.bridge.mesh_verify`).

New destinations are *registered* (``BackendRegistry.register``), not added
to a hardcoded enum — the planner iterates whatever order the registry
derives from the declared ``verify_time`` values
(repro_torch.backends.registry).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

METHOD_FUNCTION_BLOCK = "function_block"
METHOD_LOOP = "loop"
# FB verifications run before loop verifications (paper §II.C: an FB match,
# when one exists, is usually the faster pattern and enables early stop).
METHOD_ORDER: Tuple[str, ...] = (METHOD_FUNCTION_BLOCK, METHOD_LOOP)


@dataclass
class SearchResult:
    """Outcome of one verification."""
    destination: str
    best_choice: Dict[str, str]
    best_time_s: float
    n_measurements: int
    verify_elapsed_s: float
    history: List[dict] = field(default_factory=list)
    note: str = ""
    best_correct: bool = True     # False: best_time_s is a penalty, not a
                                  # usable pattern (planner must not select)
    # verification-cost counters ({"measured": ..., "reused": ...} for the
    # loop GA's choice-keyed measurement memo; search-cache stats for
    # compiled paths) — observability only, never selection input
    cache_stats: Dict = field(default_factory=dict)


@dataclass
class SearchContext:
    """Verification-environment state shared by every backend in one
    ``plan_offload`` run."""
    runner: Any                            # TimedRunner-like
    inputs: Any
    ref_out: Any
    small_state: Any = None
    fixed_choice: Dict[str, str] = field(default_factory=dict)  # residual rule
    ga_cfg: Any = None                     # GAConfig | None
    penalty_s: Optional[float] = None
    seed: int = 0
    fb_matches: list = field(default_factory=list)   # function-block matches
    # static choice linter (repro_torch.analysis): (choice dict) -> findings.
    # The loop searches charge a choice with an error-severity finding the
    # penalty without building or measuring it (prune before measuring).
    lint_choice: Optional[Callable[[Dict[str, str]], list]] = None

    def measure(self, app, choice: Dict[str, str]):
        """Measure one choice dict, stamping the run's penalty scale."""
        ev = self.runner.measure(app.build(choice), self.inputs, self.ref_out)
        if self.penalty_s is not None:
            ev.penalty_s = self.penalty_s
        return ev


def generic_fb_search(backend: "Backend", app, ctx: SearchContext
                      ) -> SearchResult:
    """Default function-block strategy: apply the registry matches for this
    backend's impl key and measure the resulting pattern (paper [41])."""
    from repro_torch.core import function_blocks

    t0 = time.perf_counter()
    choice = function_blocks.apply_matches(app, ctx.fb_matches, backend.key)
    if choice is None:
        return SearchResult(
            destination=backend.name, best_choice={},
            best_time_s=float("inf"), n_measurements=0,
            verify_elapsed_s=time.perf_counter() - t0,
            note="no offloadable function block")
    ev = ctx.measure(app, choice)
    note = "; ".join(f"{m.entry.name}@{m.nest.name}({m.method}"
                     f":{m.score:.2f})" for m in ctx.fb_matches)
    return SearchResult(
        destination=backend.name, best_choice=dict(choice),
        best_time_s=ev.effective_time, n_measurements=1,
        verify_elapsed_s=time.perf_counter() - t0, note=note,
        best_correct=ev.correct)


def bridge_mesh_verify(backend: "Backend", cost_runner, fn, inputs):
    """Default mesh hook: the planner<->mesh bridge."""
    from repro_torch.dist import bridge
    return bridge.mesh_verify(cost_runner, backend, fn, inputs)


@dataclass(frozen=True)
class Backend:
    """One offload destination: identity + search strategy + mesh hook."""
    key: str              # impl key inside LoopNest.impls
    name: str
    paper_analogue: str
    price: float          # relative $ (paper ordering: GPU < many-core < FPGA)
    verify_time: float    # relative verification cost (CPU < GPU < FPGA);
                          # the registry derives the paper's order from it
    # mesh analogue read by the mesh bridge: "data" verifications
    # trace data-parallel, "model" tensor-parallel, "" has no mesh bridge
    # (the FPGA analogue is a kernel substitution, not a sharding).
    mesh_role: str = ""
    # power envelope (repro_torch.power.PowerEnvelope) the planner charges
    # this destination's energy against; None resolves through
    # repro_torch.power.envelope_for (built-in calibration by paper_analogue,
    # generic fallback)
    power: Optional[Any] = None
    # which verification methods this backend participates in
    methods: Tuple[str, ...] = METHOD_ORDER
    # strategies; (backend, app, ctx) -> SearchResult.  fb_search_fn defaults
    # to the generic registry apply+measure; search_fn has no default — a
    # loop-capable backend must declare how it searches.
    search_fn: Optional[Callable] = None
    fb_search_fn: Callable = generic_fb_search
    # (backend, cost_runner, fn, inputs) -> Evaluation | None
    mesh_verify_fn: Callable = bridge_mesh_verify

    def search(self, app, ctx: SearchContext,
               method: str = METHOD_LOOP) -> SearchResult:
        if method == METHOD_FUNCTION_BLOCK:
            return self.fb_search_fn(self, app, ctx)
        if method == METHOD_LOOP:
            if self.search_fn is None:
                raise NotImplementedError(
                    f"backend {self.name!r} declares no loop search strategy")
            return self.search_fn(self, app, ctx)
        raise ValueError(f"unknown verification method {method!r}")

    def mesh_verify(self, cost_runner, fn, inputs):
        if self.mesh_verify_fn is None:
            return None
        return self.mesh_verify_fn(self, cost_runner, fn, inputs)

    def with_(self, **changes) -> "Backend":
        """Frozen-dataclass convenience: a copy with fields replaced."""
        return replace(self, **changes)

