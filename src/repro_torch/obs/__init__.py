"""repro_torch.obs — the tracer the planner and GA record through."""
from repro_torch.obs.tracer import (NULL_SPAN, NULL_TRACER, NullTracer, Span,
                                    Tracer, get_tracer, use_tracer)

__all__ = ["Tracer", "Span", "NullTracer", "NULL_TRACER", "NULL_SPAN",
           "get_tracer", "use_tracer"]
