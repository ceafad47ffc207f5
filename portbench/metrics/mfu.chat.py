"""Model FLOPs of the decode steps timed by CUDA events (the active slots'
tokens) over their device time at the bf16 peak."""
from portbench import reduce
from portbench import yardstick as ys


def read(run):
    steps = getattr(run, "timed_steps", None)
    if not steps:
        return None
    seconds = sum(ms for ms, _, _ in steps) / 1e3
    return reduce.share(reduce.decode_flops(run, steps) /
                        ys.PEAK_BF16_FLOPS, seconds)
