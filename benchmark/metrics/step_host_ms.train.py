"""The train step's host time: the benchmark's host-clock span from the
call of `Trainer.train_step_on_device` to its return, mean over every call of
the window."""

from benchmark.harness.readers import host_ms


def read(run):
    return host_ms(run, "step", "train")
