"""repro_torch.obs — unified tracing, metrics and post-mortem reporting, the
port of ``repro.obs``.

One observability layer over plan -> publish -> serve -> control:

  * :class:`Tracer` / :class:`Span` — nested spans + instant events on
    caller-supplied clocks (wall for offline search, the virtual tick
    clock for serve/control via :meth:`Tracer.set_time`); the ambient
    tracer (:func:`get_tracer`) defaults to the no-op
    :data:`NULL_TRACER`, so instrumentation costs nothing when disabled;
  * :class:`MetricsRegistry` — counters/gauges/histograms plus adapters
    over the repo's existing ``CacheStats`` / ``ServeMetrics`` / health
    counters, behind one ``snapshot()``;
  * exporters — byte-stable JSONL (:func:`write_jsonl`), Perfetto-loadable
    Chrome trace JSON (:func:`write_chrome_trace`), text summary
    (:func:`text_summary`); and ``python -m repro_torch.obs.report`` rendering
    the post-mortem (see :mod:`repro_torch.obs.report`).

Zero dependencies: importing this package pulls in neither torch nor numpy.
"""
from repro_torch.obs.export import (chrome_trace, jsonl_line, read_jsonl,
                                    text_summary, write_chrome_trace,
                                    write_jsonl)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.tracer import (NULL_SPAN, NULL_TRACER, NullTracer, Span,
                                    Tracer, get_tracer, set_tracer,
                                    use_tracer)

__all__ = [
    "Tracer", "Span", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "get_tracer", "set_tracer", "use_tracer",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "write_jsonl", "read_jsonl", "jsonl_line",
    "chrome_trace", "write_chrome_trace", "text_summary",
]
