"""repro_torch.serve — the continuous batching engine over the port's LM.

  * :class:`Request` — one generation request (arch, prompt_len, max_gen,
    optional SLO deadline, arrival time).
  * :class:`ContinuousBatcher` — slot-based decode loop over
    ``LM.prefill`` / ``LM.decode_step``: requests join and leave the
    running batch at decode-step granularity over a fixed-shape slot pool.
  * :class:`ServeMetrics` — queue/TTFT/TPOT/tok-s counters and per-request
    joule charges.

The router and the endpoint health machine come with a later slice (they
need the plan lookup of the modeled-cost path).
"""
from repro_torch.serve.batching import ContinuousBatcher, synth_tokens
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import Request

__all__ = ["Request", "ContinuousBatcher", "ServeMetrics", "synth_tokens"]
