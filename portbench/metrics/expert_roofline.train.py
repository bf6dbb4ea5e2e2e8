"""Percent of its roofline that the routed experts' grouped products reach
in the traced updates: their required operations, 18 k T H F a block and
update (T = batch * N tokens, k experts a token, F an expert's width; the
forward's gate+up and down products 6 k T H F, the backward's input and
weight gradients twice that) at 989 TFLOP/s, over the device time of the
kernels launched inside the port's ``moe.experts`` (the grouped forward)
and ``moe.experts.bwd`` (its backward) spans.  Operations bound the work:
its bytes, each read or written once, take about a third of the time at
3.35 TB/s.  Nothing to read for a model without the dropless router."""

from portbench.harness.phases import device_seconds

SPANS = ()
EXPERT_SPANS = ("moe.experts", "moe.experts.bwd")


def expert_train_flops(m: dict, batch: int) -> int:
    """The routed experts' operations in one update of ``batch`` images."""
    T = batch * (m["img_resolution"] // m["patch_size"]) ** 2
    H = m["hidden_size"]
    return 18 * m["experts_per_token"] * T * H * int(H * m["mlp_ratio"]) * m["depth"]


def read(ctx):
    n = ctx.layer.get("traced_updates")
    if ctx.trace is None or not n or ctx.model.get("moe_router") != "dropless":
        return None
    times = [device_seconds(ctx.trace, s) for s in EXPERT_SPANS]
    if any(t is None for t in times) or sum(times) <= 0:
        return None
    bound = (expert_train_flops(ctx.model, ctx.layer["batch"] // ctx.chips)
             / ctx.work.PEAK_FLOPS["bfloat16"])
    return 100.0 * bound * n / sum(times)
