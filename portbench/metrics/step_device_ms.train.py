"""Device busy time per training step in the traced slice (profiler
trace)."""


def read(run):
    if run.traced is None:
        return None
    spans = run.traced.by_span("portbench.step")
    if not spans:
        return None
    return sum(run.traced.busy_ns(evs) for evs in spans.values()) / 1e6 \
        / len(spans)
