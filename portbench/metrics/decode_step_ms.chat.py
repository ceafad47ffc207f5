"""Mean device time of a decode step (the input copy and the replayed
graph), by CUDA events on the device's clock around each step of the
traced run's window before the profiler starts (under the profiler a
replayed graph runs slower)."""


def read(run):
    steps = getattr(run, "timed_steps", None)
    if not steps:
        return None
    return sum(ms for ms, _, _ in steps) / len(steps)
