"""Device busy time per step of the work in the device-side span of the
port's ``train.optimizer`` range (profiler trace)."""


def read(run):
    if run.traced is None:
        return None
    steps = len(run.traced.by_span("portbench.step"))
    evs = run.traced.within("device:train.optimizer")
    if not steps or not evs:
        return None
    return run.traced.busy_ns(evs) / 1e6 / steps
