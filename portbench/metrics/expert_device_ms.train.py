"""Device milliseconds per traced update of the kernels launched inside the
port's ``moe.experts`` (the routed experts' grouped forward) and
``moe.experts.bwd`` (its backward) spans: the mechanism's share of the
update's device time.  None where either span never ran."""

from portbench.harness.phases import device_seconds

SPANS = ()
EXPERT_SPANS = ("moe.experts", "moe.experts.bwd")


def read(ctx):
    n = ctx.layer.get("traced_updates")
    if ctx.trace is None or not n:
        return None
    times = [device_seconds(ctx.trace, s) for s in EXPERT_SPANS]
    if any(t is None for t in times):
        return None
    return 1e3 * sum(times) / n
