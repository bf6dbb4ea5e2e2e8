"""Device milliseconds per traced update of the kernels launched while the
port's ``train.forward`` span was open: the step's draws and each
micro-batch's loss (the model's forward), on any thread."""

from portbench.harness.phases import device_seconds, per_update_ms


def read(ctx):
    return per_update_ms(ctx, device_seconds, "train.forward")
