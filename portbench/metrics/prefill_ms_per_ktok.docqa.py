"""Device time of the admissions (prefill and slot insert) per thousand
prompt tokens, each admission between two CUDA events on the device, in
the traced run's window before its profiler starts (a span around the
program's call)."""
from portbench import reduce


def read(run):
    return reduce.timed_prefill_ms_per_ktok(run)
