"""Device busy milliseconds per update in the traced slice: the union of
the kernel intervals over the updates traced."""


def read(ctx):
    if ctx.trace is None or not ctx.layer.get("traced_updates"):
        return None
    return 1e3 * ctx.trace.busy_s / ctx.layer["traced_updates"]
