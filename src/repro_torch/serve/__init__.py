"""repro_torch.serve — online request router + continuous batching engine,
the port of ``repro.serve``.

  * :class:`Request` — one generation request (arch, prompt_len, max_gen,
    optional SLO deadline, arrival time).
  * :class:`Router` / :class:`Endpoint` — scores each request against warm
    :class:`~repro_torch.core.plan_lookup.PlanLookup` analyses for every
    live backend (``score_analysis`` + :class:`~repro_torch.power.
    EnergyModel`) and dispatches under the router's
    :class:`~repro_torch.backends.SelectionPolicy`, with admission control
    from an aggregate ``power_budget_w``.  The hot path is dict lookup +
    roofline arithmetic: no trace, capture or launch after warm-up.
  * :class:`ContinuousBatcher` — slot-based decode loop over
    ``LM.prefill`` / ``LM.decode_step``: requests join and leave the
    running batch at decode-step granularity over a fixed-shape slot pool.
  * :class:`ServeMetrics` — queue/TTFT/TPOT/tok-s counters, per-request
    joule charges, refusal-reason counts and per-endpoint latency
    percentiles.
  * :class:`EndpointHealth` / :class:`HealthConfig` — the per-endpoint
    health state machine (healthy → degraded → quarantined → probing →
    recovered) the Router consults on every route.  The online control
    loop that drives it lives in :mod:`repro_torch.runtime.control`.
"""
from repro_torch.serve.batching import ContinuousBatcher, synth_tokens
from repro_torch.serve.health import (DEGRADED, HEALTH_STATES, HEALTHY,
                                      PROBING, QUARANTINED, EndpointHealth,
                                      HealthConfig)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request
from repro_torch.serve.router import Endpoint, Router, RoutingDecision

__all__ = ["Request", "Router", "Endpoint", "RoutingDecision",
           "ContinuousBatcher", "ServeMetrics", "synth_tokens",
           "EndpointHealth", "HealthConfig", "HEALTH_STATES",
           "HEALTHY", "DEGRADED", "QUARANTINED", "PROBING"]
