"""95th percentile of every gap between consecutive tokens of a request
whose later token came in the window (host clock)."""
from portbench import reduce, yardstick


def read(run):
    if not getattr(run, "requests", None):
        return None
    return reduce.ms(yardstick.percentile(reduce.itl_s(run), 95))
