"""Milliseconds per traced update in which the card ran no kernel while the
host was in the port's ``train.update`` span: the gaps between device
intervals whose middle falls inside the span."""

from portbench.harness.phases import idle_seconds, per_update_ms


def read(ctx):
    return per_update_ms(ctx, idle_seconds, "train.update")
