"""Evaluation throughput: every scene the window's batches evaluated, over
the window's host-clock seconds."""


def read(run):
    if run.mode != "eval" or run.window_s <= 0:
        return None
    return run.scenes / run.window_s
