"""The port's kernels (K1-K8) over the traced evaluation steps: their
functions' least time at the launched shapes over the device time of the
kernels that implement them."""

from benchmark.harness.readers import kernels_roofline


def read(run):
    return kernels_roofline(run, "eval")
