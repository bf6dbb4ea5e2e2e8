"""Device milliseconds per traced update of the kernels launched while the
port's ``train.update`` span was open: the clip norm, AdamW and the EMA
(under a mesh the placed update with its all-reduce)."""

from portbench.harness.phases import device_seconds, per_update_ms


def read(ctx):
    return per_update_ms(ctx, device_seconds, "train.update")
