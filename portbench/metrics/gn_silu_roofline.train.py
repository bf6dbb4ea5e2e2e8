"""Percent of its roofline that the GroupNorm+SiLU work of the traced
updates reaches: the least time of every forward and backward call the
configuration's shapes make (bytes at 3.35 TB/s, operations at 989
TFLOP/s, each byte read once), over the device time of the kernels
launched inside the port's GN+SiLU forward and backward entry points."""

SPANS = ["ddpm_diffusion_model_tpu_torch.ops.fused_norm:gn_silu_fwd",
         "ddpm_diffusion_model_tpu_torch.ops.fused_norm:gn_silu_bwd"]


def read(ctx):
    if ctx.trace is None or not ctx.layer.get("traced_updates"):
        return None
    times = [ctx.trace.span_seconds(s) for s in SPANS]
    if any(t is None for t in times) or sum(times) <= 0:
        return None
    bound = ctx.work.gn_bound_s(ctx.model, ctx.layer["batch"] // ctx.chips, backward=True)
    if bound <= 0:
        return None
    return 100.0 * bound * ctx.layer["traced_updates"] / sum(times)
