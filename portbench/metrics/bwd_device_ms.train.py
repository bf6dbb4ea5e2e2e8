"""Device milliseconds per traced update of the kernels launched while the
port's ``train.backward`` span was open: each micro-batch's
``loss.backward()``, launched from the autograd engine's thread while the
step's thread waits in the span."""

from portbench.harness.phases import device_seconds, per_update_ms


def read(ctx):
    return per_update_ms(ctx, device_seconds, "train.backward")
