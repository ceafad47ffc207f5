"""Model FLOPs of the training steps (three forwards' worth) that a traced
run makes after its profiler has stopped, over their time on the host
clock, at the bf16 peak."""
from portbench import reduce
from portbench import yardstick as ys


def read(run):
    steps = getattr(run, "untraced_steps", 0)
    if not steps:
        return None
    cfg, mix = run.cfg, run.mix
    flops = steps * ys.train_flops(cfg, mix["batch"] * mix["seq"],
                                   mix["batch"] * ys.causal_pairs(mix["seq"]))
    return reduce.share(flops / ys.PEAK_BF16_FLOPS, run.untraced_s)
