"""Device milliseconds per traced update of the kernels launched inside the
port's ``moe.route`` (the router, top-k, counts, sort and offsets),
``moe.dispatch`` (the gather into expert order) and ``moe.combine`` (the
weighted float32 sum back into token order) spans: the expert layer's
memory-bound glue in the forward.  Its backward runs under
``train.backward`` outside these spans.  None where a span never ran."""

from portbench.harness.phases import device_seconds

SPANS = ()
GLUE_SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(ctx):
    n = ctx.layer.get("traced_updates")
    if ctx.trace is None or not n:
        return None
    times = [device_seconds(ctx.trace, s) for s in GLUE_SPANS]
    if any(t is None for t in times):
        return None
    return 1e3 * sum(times) / n
