"""Paper-exact genetic algorithm for offload-pattern search (§II.B.1, §III.A).

Encoding: one gene per loop statement; 1 = offload/parallelize, 0 = keep on
the single-core path.  A copy of ``repro.core.ga``: pure Python, seeded
with ``random.Random(seed)``.

Paper-faithful settings:
  * goodness of fit = (processing time)^(-1/2)
  * timeout or wrong calculation result  =>  time := 1000 s
  * selection: roulette + 1-elite; crossover Pc = 0.9; mutation Pm = 0.05
  * individuals M and generations T no more than the gene length
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PENALTY_TIME_S = 1000.0


@dataclass
class GAConfig:
    population: int
    generations: int
    crossover_rate: float = 0.9
    mutation_rate: float = 0.05
    timeout_s: float = 180.0
    penalty_s: float = PENALTY_TIME_S
    seed: int = 0
    # cardinality per gene; default binary
    cardinalities: Optional[Sequence[int]] = None

    @classmethod
    def for_gene_length(cls, n: int, **kw) -> "GAConfig":
        """Paper rule: M, T <= gene length (paper used 16/16, 20/20, 6/6)."""
        m = min(max(n, 2), 20)
        return cls(population=m, generations=m, **kw)


@dataclass
class Evaluation:
    time_s: float
    correct: bool
    timed_out: bool = False
    info: dict = field(default_factory=dict)
    # paper's "wrong result or timeout => 1000 s"; configurable through
    # GAConfig.penalty_s (run_ga stamps it onto every evaluation it makes)
    penalty_s: float = PENALTY_TIME_S

    @property
    def effective_time(self) -> float:
        if not self.correct or self.timed_out:
            return self.penalty_s
        return self.time_s

    @property
    def fitness(self) -> float:
        return self.effective_time ** -0.5


@dataclass
class GAResult:
    best_genes: Tuple[int, ...]
    best_eval: Evaluation
    history: List[dict]                     # per-generation stats
    evaluations: Dict[Tuple[int, ...], Evaluation]

    @property
    def n_measurements(self) -> int:
        return len(self.evaluations)


def run_ga(gene_length: int,
           evaluate: Callable[[Tuple[int, ...]], Evaluation],
           cfg: GAConfig,
           evaluate_batch: Optional[
               Callable[[List[Tuple[int, ...]]], List[Evaluation]]] = None,
           seed_population: Optional[Sequence[Tuple[int, ...]]] = None
           ) -> GAResult:
    """``evaluate_batch``, when given, scores a whole generation's unseen
    individuals in one call (e.g. batching compilation across
    the population); ``evaluate`` remains the per-individual fallback.

    ``seed_population`` injects known-good individuals ahead of the random
    fill (after the all-zeros baseline) — e.g. a greedy bin-packing
    solution the GA should start from rather than rediscover.  Individuals
    beyond ``cfg.population`` are ignored; omitted -> identical behavior
    to before the parameter existed."""
    rng = random.Random(cfg.seed)
    cards = list(cfg.cardinalities or [2] * gene_length)
    assert len(cards) == gene_length

    def rand_genes() -> Tuple[int, ...]:
        return tuple(rng.randrange(c) for c in cards)

    cache: Dict[Tuple[int, ...], Evaluation] = {}

    def ev(genes: Tuple[int, ...]) -> Evaluation:
        if genes not in cache:
            e = evaluate(genes)
            e.penalty_s = cfg.penalty_s
            cache[genes] = e
        return cache[genes]

    def ev_population(pop: List[Tuple[int, ...]]
                      ) -> Tuple[List[Evaluation], int]:
        """Evaluations for pop plus how many were fresh (not yet cached) —
        the per-generation verification cost, recorded in history."""
        fresh = [g for g in dict.fromkeys(pop) if g not in cache]
        if fresh and evaluate_batch is not None:
            evs = evaluate_batch(fresh)
            assert len(evs) == len(fresh), \
                "evaluate_batch must return one Evaluation per individual"
            for g, e in zip(fresh, evs):
                e.penalty_s = cfg.penalty_s
                cache[g] = e
        return [ev(g) for g in pop], len(fresh)

    # initial population: all-zeros (the no-offload baseline is always a
    # candidate) + caller-seeded individuals + random fill, de-duplicated
    # when possible
    pop: List[Tuple[int, ...]] = [tuple([0] * gene_length)]
    for g in (seed_population or ()):
        g = tuple(int(v) for v in g)
        assert len(g) == gene_length, \
            f"seed individual has {len(g)} genes, expected {gene_length}"
        if g not in pop and len(pop) < cfg.population:
            pop.append(g)
    guard = 0
    while len(pop) < cfg.population:
        g = rand_genes()
        guard += 1
        if g not in pop or guard > 50 * cfg.population:
            pop.append(g)

    from repro_torch.obs import get_tracer

    history: List[dict] = []
    for gen in range(cfg.generations):
        evals, n_fresh = ev_population(pop)
        fits = [e.fitness for e in evals]
        best_i = max(range(len(pop)), key=lambda i: fits[i])
        history.append({
            "generation": gen,
            "best_time_s": evals[best_i].effective_time,
            "best_genes": pop[best_i],
            "mean_fitness": sum(fits) / len(fits),
            "n_correct": sum(e.correct for e in evals),
            "n_fresh": n_fresh,
            # individuals a static linter rejected without any measurement
            # (repro_torch.analysis via the batch evaluator / loop-GA lint
            # hooks)
            "n_pruned": sum(bool(e.info.get("static_pruned"))
                            for e in evals),
        })
        row = history[-1]
        get_tracer().event(
            "generation", cat="ga", track="search", generation=gen,
            best_time_s=row["best_time_s"],
            mean_fitness=row["mean_fitness"], n_correct=row["n_correct"],
            n_fresh=row["n_fresh"], n_pruned=row["n_pruned"])

        if gen == cfg.generations - 1:
            break

        # --- next generation ---
        new_pop: List[Tuple[int, ...]] = [pop[best_i]]        # elite
        total_fit = sum(fits)

        def roulette() -> Tuple[int, ...]:
            r = rng.uniform(0, total_fit)
            acc = 0.0
            for g, f in zip(pop, fits):
                acc += f
                if acc >= r:
                    return g
            return pop[-1]

        while len(new_pop) < cfg.population:
            p1, p2 = roulette(), roulette()
            if rng.random() < cfg.crossover_rate and gene_length > 1:
                cut = rng.randrange(1, gene_length)
                c1 = p1[:cut] + p2[cut:]
                c2 = p2[:cut] + p1[cut:]
            else:
                c1, c2 = p1, p2
            for child in (c1, c2):
                child = tuple(
                    (rng.randrange(cards[i]) if rng.random() < cfg.mutation_rate
                     else v)
                    for i, v in enumerate(child))
                new_pop.append(child)
                if len(new_pop) >= cfg.population:
                    break
        pop = new_pop

    # final selection: a wrong result must never *win* the search, no
    # matter how small the configured penalty is — the penalty shapes
    # selection pressure inside the GA, not the returned pattern.  Fall
    # back to raw effective_time only when nothing was correct.
    valid = [kv for kv in cache.items()
             if kv[1].correct and not kv[1].timed_out]
    pool = valid or list(cache.items())
    best = min(pool, key=lambda kv: kv[1].effective_time)
    return GAResult(best_genes=best[0], best_eval=best[1], history=history,
                    evaluations=cache)
