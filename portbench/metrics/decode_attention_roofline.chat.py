"""Least time of the traced decode-attention calls at the peaks (the valid
cache rows of every slot read once) over the device time of the decode
kernels (profiler trace)."""
from portbench import reduce


def read(run):
    if run.traced is None:
        return None
    return reduce.share(reduce.decode_bound_s(run),
                        reduce.kernel_s(run, reduce.DECODE))
