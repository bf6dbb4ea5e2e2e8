"""Percent of the traced slice in which the card ran no kernel: one minus
the union of the device intervals over the slice's wall time, both from
the timeline pass (the device's activity alone).  CUPTI's launch hooks
slow the host in the slice, so a host-bound update reads more idle here
than untraced; the window's own rate is ``mfu`` and images/s.  A slice
whose busy time passes its wall time has counted something wrong and gives
nothing."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not 0 < tr.busy_s <= tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
