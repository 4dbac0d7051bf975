"""The eval step's host time: the benchmark's host-clock span from the
call of `Trainer.eval_step` to its return (with the loss, to the return of
the losses' read-back, which waits for the forward), mean over every
batch of the window."""

from benchmark.harness.readers import host_ms


def read(run):
    return host_ms(run, "step", "eval")
