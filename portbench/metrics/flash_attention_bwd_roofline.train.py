"""Least time of the traced steps' flash backward calls at the peaks (10
FLOP a causal pair and head dim) over the device time of the backward's
kernels (profiler trace)."""
from portbench import reduce
from portbench import yardstick as ys


def read(run):
    if run.traced is None:
        return None
    cfg, mix = run.cfg, run.mix
    steps = len(run.traced.by_span("portbench.step"))
    one = ys.least_seconds(*ys.flash_bwd_work(
        mix["batch"] * cfg["n_heads"], mix["seq"], cfg["d_head"],
        cfg["n_heads"] // cfg["n_kv_heads"])) * cfg["n_layers"]
    return reduce.share(steps * one, reduce.kernel_s(run, reduce.FLASH_BWD))
