"""Share of the device's span, in the traced run's window before its
profiler starts, that lies in neither an admission nor a decode step, each
between two CUDA events (spans around the program's calls; a device gap
inside an admission counts as busy)."""
from portbench import reduce


def read(run):
    return reduce.timed_idle_share(run)
