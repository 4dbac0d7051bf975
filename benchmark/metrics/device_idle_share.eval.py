"""The share of the traced evaluation steps in which the device ran
nothing: one minus the union of its kernels, copies and sets over the
segment, both from the device's own trace of it."""

from benchmark.harness.readers import idle_share


def read(run):
    return idle_share(run, "eval")
