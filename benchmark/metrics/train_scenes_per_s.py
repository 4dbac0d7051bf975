"""Training throughput: every scene the window's steps took, over the
window's host-clock seconds (the device drained at its close)."""


def read(run):
    if run.mode != "train" or run.window_s <= 0:
        return None
    return run.scenes / run.window_s
