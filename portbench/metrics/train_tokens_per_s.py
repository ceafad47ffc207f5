"""Tokens of the steps run in the window, over the window's seconds (host
clock)."""


def read(run):
    if not getattr(run, "train_steps", 0):
        return None
    return run.train_steps * run.train_tokens / (run.window[1]
                                                 - run.window[0])
