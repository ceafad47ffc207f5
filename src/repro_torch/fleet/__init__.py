"""repro_torch.fleet — many apps, one shared destination pool, one power
cap; the port of ``repro.fleet``.

Public surface:

  * :class:`FleetApp` / :class:`PoolBackend` — the placement problem's
    two sides (offered load + working set vs. slots + memory + envelope).
  * :class:`FleetPlanner` — ``plan(apps)`` searches assignment vectors
    with the paper's GA (greedy bin-packing seed), scored entirely from
    warm :class:`~repro_torch.core.plan_lookup.PlanLookup` payloads through
    the :class:`~repro_torch.core.candidates.Candidate` contract — zero new
    traces; ``replan(apps, placement, failed_backend)`` degrades
    around a dead backend, keeping unaffected apps pinned.
  * :class:`Placement` — the evaluated result (feasibility, violations,
    fleet draw, joules-per-request).
  * :func:`round_robin` — the static capacity-blind baseline.
  * :func:`observed_apps` — fold observed per-arch load (from
    :class:`~repro_torch.serve.ServeMetrics`) back into the app estimates;
    the
    read side of the control loop's plan→serve→observe→replan cycle.
"""
from repro_torch.fleet.placement import (FleetApp, FleetPlanner, Placement,
                                         PoolBackend, observed_apps,
                                         round_robin)

__all__ = ["FleetApp", "PoolBackend", "FleetPlanner", "Placement",
           "round_robin", "observed_apps"]
