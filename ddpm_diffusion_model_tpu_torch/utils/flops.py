"""Analytic FLOP counts of the denoisers, the basis of model-FLOPs
utilization (MFU).

Counterpart of ``ddpm_diffusion_model_tpu/utils/flops.py``: the matmul and
conv FLOPs of one forward, counted from the architecture (the U-Net's
``level_plan``, the DiT's sequence length and blocks), so a measured step
or sampling time converts to a share of the card's peak.  The counts equal
the JAX package's as integers.

Conventions: one multiply-add is 2 FLOPs; a backward is about twice the
forward (the input and the weight gradients); elementwise and
normalization work is left out (it is bound by memory, not by the tensor
cores).  A MoE's capacity padding is counted as executed work.
"""

from __future__ import annotations

from ..models.unet import UNetConfig

__all__ = ["unet_fwd_flops", "dit_fwd_flops", "fwd_flops", "train_step_flops",
           "sampling_flops", "mfu", "PEAK_TFLOPS"]

#: dense bf16 peaks per card in TFLOP/s (NVIDIA data sheets)
PEAK_TFLOPS = {
    "h100": 989.0,  # H100 SXM, the port's card
    "a100": 312.0,  # the reference's CelebA-HQ hardware
}


def _conv(res: int, k: int, cin: int, cout: int, batch: int) -> int:
    return 2 * batch * res * res * k * k * cin * cout


def _resblock(res: int, cin: int, cout: int, time_dim: int, batch: int) -> int:
    f = _conv(res, 3, cin, cout, batch) + _conv(res, 3, cout, cout, batch)
    f += 2 * batch * time_dim * cout  # the time-bias Linear
    if cin != cout:
        f += _conv(res, 1, cin, cout, batch)  # the 1x1 skip
    return f


def _attn(res: int, ch: int, heads: int, head_dim: int, batch: int) -> int:
    n = res * res
    inner = heads * head_dim
    qkv = 2 * batch * n * ch * 3 * inner
    proj = 2 * batch * n * inner * ch
    scores = 2 * batch * heads * n * n * head_dim  # Q K^T
    out = 2 * batch * heads * n * n * head_dim     # P V
    return qkv + proj + scores + out


def unet_fwd_flops(cfg: UNetConfig, batch: int) -> int:
    """Matmul and conv FLOPs of one U-Net forward over ``batch`` images:
    one skip per level, a concatenating decoder ResBlock first, no decoder
    attention (``models/unet.py``)."""
    levels, bottleneck_res = cfg.level_plan()
    td = cfg.time_embed_dim
    f = 2 * batch * td * td * 2  # the time MLP, two td -> td Linears
    f += _conv(cfg.img_resolution, 3, cfg.in_channels, cfg.base_channels, batch)

    ch = cfg.base_channels
    for level in levels:
        res, out_ch = level["resolution"], level["out_ch"]
        for _ in range(cfg.num_res_blocks):
            f += _resblock(res, ch, out_ch, td, batch)
            ch = out_ch
            if level["use_attn"]:
                f += _attn(res, ch, cfg.num_heads, cfg.head_dim, batch)
        if level["downsample"]:
            f += _conv(res // 2, 3, ch, ch, batch)  # stride 2: the output is at res / 2

    mid_ch = levels[-1]["out_ch"]
    f += _resblock(bottleneck_res, ch, mid_ch, td, batch)
    if bottleneck_res in set(cfg.attn_resolutions):
        f += _attn(bottleneck_res, mid_ch, cfg.num_heads, cfg.head_dim, batch)
    f += _resblock(bottleneck_res, mid_ch, mid_ch, td, batch)

    ch = mid_ch
    for li, level in enumerate(reversed(levels)):
        res, out_ch = level["resolution"], level["out_ch"]
        if li > 0:
            f += _conv(res, 3, ch, ch, batch)  # the upsample conv at the target res
        f += _resblock(res, ch + out_ch, out_ch, td, batch)  # the level's skip joins
        ch = out_ch
        for _ in range(cfg.num_res_blocks):
            f += _resblock(res, ch, out_ch, td, batch)

    f += _conv(cfg.img_resolution, 3, ch, cfg.in_channels, batch)
    return int(f)


def dit_fwd_flops(cfg, batch: int) -> int:
    """Matmul FLOPs of one DiT forward over ``batch`` images.  A block: qkv
    6NH^2, attention 4N^2 H over the heads, proj 2NH^2, the MLP 4rNH^2 and
    the adaLN head 12H^2; plus the patch embedding and projection and the
    conditioning MLP.  A switch MoE's block counts its router, every
    expert's E * C slots (capacity padding included) and its dispatch and
    combine.  A dropless MoE (``moe_router="dropless"``) is counted the same
    way, as the benchmark's copy of this count (``portbench/harness/work.py``)
    counts it and its tests hold the two equal; its true count, the k routed
    SwiGLU rows and the shared row of each token, is its benchmark
    reference's ``fwd_flops`` (``portbench/reference/dit_moe.py``)."""
    N, H, L = cfg.seq_len, cfg.hidden_size, cfg.depth
    r = cfg.mlp_ratio
    pc = cfg.patch_size * cfg.patch_size * cfg.in_channels
    E = getattr(cfg, "num_experts", 0)
    if E:
        C = max(1, -(-int(N * cfg.capacity_factor) // E))
        mlp = 2 * N * H * E + 4 * r * H * H * E * C + 4 * N * E * C * H
    else:
        mlp = 4 * r * N * H * H
    per_block = 8 * N * H * H + mlp + 4 * N * N * H + 12 * H * H
    f = 2 * N * pc * H                         # patch embedding
    f += 2 * (cfg.time_embed_dim * H + H * H)  # conditioning MLP
    f += L * per_block
    f += 4 * H * H + 2 * N * H * pc            # final adaLN and projection
    return int(batch * f)


def fwd_flops(cfg, batch: int) -> int:
    """Forward FLOPs of either family's config."""
    if isinstance(cfg, UNetConfig):
        return unet_fwd_flops(cfg, batch)
    return dit_fwd_flops(cfg, batch)


def train_step_flops(cfg, batch: int) -> int:
    """Forward and backward (about twice the forward) of one optimizer step
    over ``batch`` images; gradient accumulation splits the total, it does
    not change it."""
    return 3 * fwd_flops(cfg, batch)


def sampling_flops(cfg, batch: int, steps: int) -> int:
    """The reverse process: one forward per timestep."""
    return steps * fwd_flops(cfg, batch)


def mfu(flops: int, seconds: float, peak_tflops: float = PEAK_TFLOPS["h100"]) -> float:
    """Model-FLOPs utilization in [0, 1] against ``peak_tflops`` (the H100's
    dense bf16 peak unless given)."""
    return (flops / seconds) / (peak_tflops * 1e12)
