"""Set-up: from process start to the window's start, the lead-in
included (host clock)."""


def read(run):
    return run.setup_s
