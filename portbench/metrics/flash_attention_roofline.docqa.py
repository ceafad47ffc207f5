"""Least time of the traced prefills' flash-attention calls at the peaks
(4 FLOP a causal pair and head dim) over the flash forward kernels'
device time (profiler trace)."""
from portbench import reduce


def read(run):
    if run.traced is None:
        return None
    return reduce.share(reduce.flash_fwd_bound_s(run),
                        reduce.kernel_s(run, reduce.FLASH_FWD))
