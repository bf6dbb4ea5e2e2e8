"""Percent of the cards' dense bf16 peak (989 TFLOP/s each) that the
window's updates reach: ``train_step_flops`` of the global batch for every
update over the window's wall time."""


def read(ctx):
    L = ctx.layer
    if not L.get("window_updates") or L.get("window_s", 0) <= 0:
        return None
    flops = ctx.work.train_step_flops(ctx.model, L["batch"]) * L["window_updates"]
    peak = ctx.work.PEAK_FLOPS["bfloat16"] * ctx.chips
    return 100.0 * flops / (L["window_s"] * peak)
