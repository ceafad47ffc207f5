"""Prompt tokens prefilled and output tokens produced in the window, over
the window's seconds (host clock)."""
from portbench import reduce


def read(run):
    if not getattr(run, "requests", None):
        return None
    n = 0
    for q in run.requests.values():
        t = q.get("times") or []
        if t and reduce.in_window(run, t[0]):
            n += q["prompt_len"]
        n += sum(1 for x in t if reduce.in_window(run, x))
    return n / (run.window[1] - run.window[0])
