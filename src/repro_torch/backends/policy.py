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
implements.  The pre-Candidate faces (``score`` / ``score_parts`` /
``score_cell``) survive as thin shims, and a custom policy written against
them keeps working: ``score_candidate``'s default bridges to whichever
legacy face the subclass overrode (a Candidate carries a record's fields,
so the old arithmetic ranks it unchanged).
``power_budget_w`` / ``max_slowdown`` constrain any policy.
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
        Candidate` (or anything with its duck fields).

        Built-in policies override this; the default bridges a legacy
        subclass, one that overrode ``score`` or ``score_parts``, through
        its old face.
        """
        cls = type(self)
        if cls.score is not SelectionPolicy.score:
            return cls.score(self, cand)
        if cls.score_parts is not SelectionPolicy.score_parts:
            return cls.score_parts(self, cand.best_time_s,
                                   getattr(cand, "price", 1.0),
                                   getattr(cand, "mesh_time_s", None))
        raise NotImplementedError(
            f"{cls.__name__} must implement score_candidate "
            f"(or a legacy score/score_parts face)")

    def score(self, record) -> float:
        """Shim (pre-Candidate face): rank one planner
        ``VerificationRecord``, which carries the Candidate fields."""
        return self.score_candidate(record)

    def score_parts(self, time_s: float, price: float = 1.0,
                    modeled_s: Optional[float] = None) -> float:
        """Shim (pre-Candidate face): rank from raw parts."""
        from repro_torch.core.candidates import Candidate
        return self.score_candidate(Candidate(
            best_time_s=time_s, price=price, mesh_time_s=modeled_s,
            source="parts"))

    def score_cell(self, step_time_s: float, price: float = 1.0,
                   energy: Optional[Dict] = None) -> float:
        """Shim (pre-Candidate face): rank one modeled mesh cell
        (``Candidate.from_cell`` replaces it)."""
        from repro_torch.core.candidates import Candidate
        return self.score_candidate(Candidate.from_cell(
            step_time_s, n_chips=price, energy=energy))

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

    def score_parts(self, time_s, price=1.0, modeled_s=None):
        # shim; keeps the price scaling (a machine-size stand-in) of the
        # uncharged joule-scale fallback
        from repro_torch.power import GENERIC
        t = modeled_s if modeled_s is not None else time_s
        return GENERIC.peak_w * t * price

    def score_cell(self, step_time_s, price=1.0, energy=None):
        if energy is not None:
            return super().score_cell(step_time_s, price, energy)
        # shim, uncharged cell: the fallback's unit rule scaled by the
        # cell's price (chip count), so an unmodelled big slice cannot
        # under-score a modeled one
        from repro_torch.power import GENERIC
        return GENERIC.peak_w * step_time_s * price


class EdpPolicy(SelectionPolicy):
    """Rank by the energy-delay product (joules × seconds per step)."""

    name = "edp"

    def score_candidate(self, cand):
        e = getattr(cand, "energy_j", None)
        if e is None:
            e = PowerPolicy._fallback_joules(cand)
        return e * _modeled_or_host(cand)

    def score_parts(self, time_s, price=1.0, modeled_s=None):
        # shim; see PowerPolicy.score_parts
        from repro_torch.power import GENERIC
        t = modeled_s if modeled_s is not None else time_s
        return GENERIC.peak_w * t * t * price

    def score_cell(self, step_time_s, price=1.0, energy=None):
        if energy is not None:
            return energy["edp"]
        # shim, uncharged cell; see PowerPolicy.score_cell
        from repro_torch.power import GENERIC
        return GENERIC.peak_w * step_time_s * step_time_s * price


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
