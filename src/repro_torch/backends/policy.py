"""Selection policies: how the planner ranks verified destinations, the port
of ``repro.backends.policy``.

The paper selects the fastest correct pattern by measured host wall-clock
(``host-time``).  Yamato's follow-ups change the *objective* without
changing the pipeline, so the objective is a pluggable
:class:`SelectionPolicy`:

  * ``host-time``       — min measured ``best_time_s``.
  * ``modeled``         — min ``mesh_time_s`` when a mesh verification
    recorded one, host time as fallback.
  * ``price-weighted``  — min ``best_time_s × price``.
  * ``power``           — min modeled joules per step (repro_torch.power).
  * ``edp``             — min energy-delay product (``energy_j × time``).

Every consumer builds :class:`~repro_torch.core.candidates.Candidate`
objects and calls one entry point, :meth:`SelectionPolicy.rank`;
:meth:`SelectionPolicy.score_candidate` is the one ranking key a policy
implements.  ``power_budget_w`` / ``max_slowdown`` constrain any policy.
Every policy ranks only *correct, finite* candidates — a penalized wrong
result can never be the chosen destination, whatever the objective.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union


def _modeled_or_host(cand) -> float:
    m = getattr(cand, "mesh_time_s", None)
    return m if m is not None else cand.best_time_s


class SelectionPolicy:
    """Rank candidates; lower ``score_candidate`` wins."""

    name: str = "base"

    def score_candidate(self, cand) -> float:
        """Ranking key for one :class:`~repro_torch.core.candidates.
        Candidate` (or anything with its duck fields)."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement score_candidate")

    def rank(self, candidates: List, *,
             power_budget_w: Optional[float] = None,
             max_slowdown: Optional[float] = None) -> List:
        """Surviving candidates, best first (possibly empty).

        ``power_budget_w`` keeps only candidates whose modeled
        ``avg_watts`` fits the budget (a candidate without a modeled draw
        is over budget by definition).  ``max_slowdown`` keeps only
        candidates within the factor of the fastest surviving correct
        candidate's time.
        """
        done = [c for c in candidates
                if c.correct and c.best_time_s < float("inf")]
        if power_budget_w is not None:
            done = [c for c in done
                    if getattr(c, "avg_watts", None) is not None
                    and c.avg_watts <= power_budget_w]
        if max_slowdown is not None and done:
            fastest = min(c.best_time_s for c in done)
            done = [c for c in done
                    if c.best_time_s <= max_slowdown * fastest]
        return sorted(done, key=self.score_candidate)

    def select(self, candidates: List, *,
               power_budget_w: Optional[float] = None,
               max_slowdown: Optional[float] = None):
        """The winning candidate, or None (``rank(...)[0]``)."""
        ranked = self.rank(candidates, power_budget_w=power_budget_w,
                           max_slowdown=max_slowdown)
        return ranked[0] if ranked else None


class HostTimePolicy(SelectionPolicy):
    name = "host-time"

    def score_candidate(self, cand):
        return cand.best_time_s


class ModeledPolicy(SelectionPolicy):
    name = "modeled"

    def score_candidate(self, cand):
        return _modeled_or_host(cand)


class PriceWeightedPolicy(SelectionPolicy):
    name = "price-weighted"

    def score_candidate(self, cand):
        return cand.best_time_s * getattr(cand, "price", 1.0)


class PowerPolicy(SelectionPolicy):
    """Rank by modeled joules per step (repro_torch.power.EnergyModel)."""

    name = "power"

    @staticmethod
    def _fallback_joules(cand) -> float:
        """Joule-scale charge for a candidate nothing charged: the generic
        envelope at peak over the modeled-or-host time (a seconds-scale
        proxy would let every unknown draw outrank every modeled one)."""
        from repro_torch.power import GENERIC
        return GENERIC.peak_w * _modeled_or_host(cand)

    def score_candidate(self, cand):
        e = getattr(cand, "energy_j", None)
        return e if e is not None else self._fallback_joules(cand)


class EdpPolicy(SelectionPolicy):
    """Rank by the energy-delay product (joules × seconds per step)."""

    name = "edp"

    def score_candidate(self, cand):
        e = getattr(cand, "energy_j", None)
        if e is None:
            e = PowerPolicy._fallback_joules(cand)
        return e * _modeled_or_host(cand)


POLICIES: Dict[str, SelectionPolicy] = {}


def register_policy(policy: SelectionPolicy) -> SelectionPolicy:
    POLICIES[policy.name] = policy
    return policy


for _p in (HostTimePolicy(), ModeledPolicy(), PriceWeightedPolicy(),
           PowerPolicy(), EdpPolicy()):
    register_policy(_p)

DEFAULT_POLICY = "host-time"


def get_policy(policy: Union[str, SelectionPolicy, None]) -> SelectionPolicy:
    """Resolve a policy name (or pass an instance through)."""
    if policy is None:
        return POLICIES[DEFAULT_POLICY]
    if isinstance(policy, SelectionPolicy):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown selection policy {policy!r}; "
            f"known: {sorted(POLICIES)}") from None
