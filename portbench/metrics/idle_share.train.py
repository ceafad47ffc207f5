"""Share of a training step's time in which no operation ran on the
device: one less the step's device busy time in the traced slice (profiler
trace) over the wall time of a step after the profiler has stopped (the
profiler slows the host's launches, not the kernels)."""
from portbench import harness


def read(run):
    busy_ms = harness.reader("step_device_ms.train")(run)
    steps = getattr(run, "untraced_steps", 0)
    if busy_ms is None or not steps:
        return None
    return 100.0 * (1.0 - busy_ms / (1e3 * run.untraced_s / steps))
