"""Model FLOPs of the event-timed admissions' prefills and decode steps
over the device's span from the first to the last of them, at the bf16
peak (spans around the program's calls, before the traced run's profiler
starts)."""
from portbench import reduce
from portbench import yardstick as ys


def read(run):
    got = reduce.timed_ms(run)
    if got is None:
        return None
    flops = reduce.prefill_flops(run, [n for _, n in run.timed_admits]) + \
        reduce.decode_flops(run, run.timed_steps)
    return reduce.share(flops / ys.PEAK_BF16_FLOPS, got[2] / 1e3)
