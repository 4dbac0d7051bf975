"""The grounding evaluator's host time: the benchmark's host-clock span
around `evaluate` (its hits on the device and their one copy back), mean
over every batch of the window."""

from benchmark.harness.readers import host_ms


def read(run):
    return host_ms(run, "evaluate", "eval")
