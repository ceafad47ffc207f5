"""Loop-statement offloading: GA search over per-nest offload genes for one
destination (paper §II.B.1/2/3), the port of ``repro.core.loop_offload``.

For the many-core-CPU and GPU analogues the full GA runs (M, T <= gene
length).  For the FPGA analogue the candidate set is first narrowed by
arithmetic intensity / resources (repro_torch.core.intensity) and only ~4
patterns are measured, exactly the paper's protocol.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from repro_torch.backends.base import Backend, SearchResult
from repro_torch.core import ga as ga_mod, intensity
from repro_torch.core.ga import Evaluation, GAConfig, GAResult
from repro_torch.core.measure import TimedRunner
from repro_torch.core.offloadable import OffloadableApp


def _measure_choice(app, choice, runner, inputs, ref_out,
                    penalty_s: Optional[float] = None) -> Evaluation:
    ev = runner.measure(app.build(choice), inputs, ref_out)
    if penalty_s is not None:
        ev.penalty_s = penalty_s      # one penalty scale per planner run
    return ev


def _lint_findings(lint_choice, choice) -> Optional[list]:
    """Error-severity findings for a choice, or None when it may run."""
    if lint_choice is None:
        return None
    findings = list(lint_choice(choice) or ())
    if any(getattr(f, "severity", None) == "error" for f in findings):
        return findings
    return None


def _pruned_evaluation(findings) -> Evaluation:
    return Evaluation(
        time_s=float("inf"), correct=False,
        info={"static_pruned": True,
              "static_findings": [f.to_dict() if hasattr(f, "to_dict")
                                  else f for f in findings]})


def ga_search(app: OffloadableApp, dest: Backend, runner: TimedRunner,
              inputs, ref_out, fixed_choice: Optional[Dict[str, str]] = None,
              ga_cfg: Optional[GAConfig] = None,
              seed: int = 0, lint_choice=None) -> SearchResult:
    """Full GA over the app's nests for one destination.

    ``fixed_choice`` pins nests already offloaded as function blocks (the
    paper's residual rule); their genes are excluded from the search.
    ``lint_choice(choice)`` (see :class:`repro_torch.backends.SearchContext`)
    rejects a choice with an error-severity finding for the penalty: no
    build, no measurement (the paper's structure analysis inside the GA
    loop).
    """
    fixed_choice = dict(fixed_choice or {})
    free_nests = [n for n in app.nests if n.name not in fixed_choice]
    gene_len = len(free_nests)
    cfg = ga_cfg or GAConfig.for_gene_length(gene_len, seed=seed)
    if gene_len == 0:
        ev = _measure_choice(app, fixed_choice, runner, inputs, ref_out,
                             penalty_s=cfg.penalty_s)
        return SearchResult(dest.name, fixed_choice, ev.effective_time,
                            1, 0.0, note="no free loops",
                            best_correct=ev.correct)

    # distinct gene strings can build the *same* offload pattern (a gene set
    # on a nest without this destination's impl falls back to "seq"), and
    # measuring one pattern twice is pure verification cost — memoize
    # Evaluations by the canonical choice dict
    measured: Dict[Tuple[Tuple[str, str], ...], Evaluation] = {}
    reused = [0]
    pruned = [0]

    def evaluate(genes: Tuple[int, ...]) -> Evaluation:
        choice = dict(fixed_choice)
        for nest, g in zip(free_nests, genes):
            choice[nest.name] = dest.key if (g and dest.key in nest.impls) \
                else "seq"
        ckey = tuple(sorted(choice.items()))
        if ckey in measured:
            reused[0] += 1
            return measured[ckey]
        findings = _lint_findings(lint_choice, choice)
        if findings is not None:
            pruned[0] += 1
            ev = _pruned_evaluation(findings)
        else:
            ev = _measure_choice(app, choice, runner, inputs, ref_out)
        measured[ckey] = ev
        return ev

    t0 = time.perf_counter()
    res: GAResult = ga_mod.run_ga(gene_len, evaluate, cfg)
    elapsed = time.perf_counter() - t0
    best_choice = dict(fixed_choice)
    for nest, g in zip(free_nests, res.best_genes):
        best_choice[nest.name] = dest.key if (g and dest.key in nest.impls) \
            else "seq"
    return SearchResult(
        destination=dest.name, best_choice=best_choice,
        best_time_s=res.best_eval.effective_time,
        n_measurements=res.n_measurements, verify_elapsed_s=elapsed,
        history=res.history, best_correct=res.best_eval.correct,
        cache_stats={"measured": len(measured) - pruned[0],
                     "reused": reused[0], "static_pruned": pruned[0]})


def fpga_search(app: OffloadableApp, dest: Backend, runner: TimedRunner,
                inputs, ref_out, small_state,
                fixed_choice: Optional[Dict[str, str]] = None,
                penalty_s: Optional[float] = None,
                lint_choice=None) -> SearchResult:
    """Narrow-then-measure protocol (<= 4 measured patterns).

    With ``lint_choice`` the linter narrows before the measured budget is
    spent: a pattern with an error-severity finding is dropped unmeasured
    and the next pattern by intensity takes its slot, so each of the <= 4
    measurements goes to a statically feasible pattern.
    """
    fixed_choice = dict(fixed_choice or {})
    t0 = time.perf_counter()
    candidates = [p for p in intensity.narrow(app, small_state)
                  if p.nest.name not in fixed_choice
                  and dest.key in p.nest.impls]
    n_pruned = 0
    singles = []
    for p in candidates:
        if len(singles) >= 3:
            break
        choice = dict(fixed_choice)
        choice[p.nest.name] = dest.key
        if _lint_findings(lint_choice, choice) is not None:
            n_pruned += 1
            continue
        ev = _measure_choice(app, choice, runner, inputs, ref_out,
                             penalty_s=penalty_s)
        singles.append((p.nest.name, ev))
    results = list(singles)
    good = [s for s in singles if s[1].correct]
    good.sort(key=lambda s: s[1].effective_time)
    if len(good) >= 2:
        choice = dict(fixed_choice)
        choice[good[0][0]] = dest.key
        choice[good[1][0]] = dest.key
        # two feasible patterns may still be infeasible together
        if _lint_findings(lint_choice, choice) is not None:
            n_pruned += 1
        else:
            ev = _measure_choice(app, choice, runner, inputs, ref_out,
                                 penalty_s=penalty_s)
            results.append((f"{good[0][0]}+{good[1][0]}", ev))
    elapsed = time.perf_counter() - t0

    if not results:
        ev = _measure_choice(app, fixed_choice, runner, inputs, ref_out,
                             penalty_s=penalty_s)
        note = "no pallas-capable nests" if not candidates else \
            "all candidate patterns statically pruned"
        return SearchResult(dest.name, fixed_choice, ev.effective_time,
                            1, elapsed, note=note, best_correct=ev.correct,
                            cache_stats={"static_pruned": n_pruned})
    # as in run_ga: a wrong result never wins the search outright
    correct_results = [r for r in results if r[1].correct]
    best_name, best_ev = min(correct_results or results,
                             key=lambda r: r[1].effective_time)
    best_choice = dict(fixed_choice)
    if best_ev.correct:
        for nm in best_name.split("+"):
            best_choice[nm] = dest.key
    history = [{"pattern": nm, "time_s": e.effective_time,
                "correct": e.correct} for nm, e in results]
    return SearchResult(
        destination=dest.name, best_choice=best_choice,
        best_time_s=best_ev.effective_time, n_measurements=len(results),
        verify_elapsed_s=elapsed, history=history,
        best_correct=best_ev.correct,
        cache_stats={"static_pruned": n_pruned})
