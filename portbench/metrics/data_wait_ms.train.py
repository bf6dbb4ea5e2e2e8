"""Host milliseconds per traced update inside the port's
``train.data_wait`` span: the loop's pull of the next batch from
``device_prefetch`` (the device cache's gather and dequantize, a host
batch's pinned copy, the ring's event wait), on the loop's thread."""

from portbench.harness.phases import host_seconds, per_update_ms


def read(ctx):
    return per_update_ms(ctx, host_seconds, "train.data_wait")
