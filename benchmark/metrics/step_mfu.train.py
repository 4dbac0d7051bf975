"""The whole train step's share of the chip's bf16 peak: the operations the
window's scenes need, counted from the configuration's widths, over the
window's host-clock seconds."""

from benchmark.harness.readers import step_mfu


def read(run):
    return step_mfu(run, "train")
