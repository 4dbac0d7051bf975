"""Set-up: the host-clock seconds from the start of the process to the
start of the window (imports, the kernels' build where the checkout has
none yet, the data pool, the weights, the trainer, the checked steps and
the warm-up)."""


def read(run):
    return run.setup_s
