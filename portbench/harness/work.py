"""The yardstick's arithmetic: operations and bytes of the work, computed
from a configuration's shapes, and the H100's peaks.

Copied from the port's ``utils/flops.py`` (the matmul and conv FLOPs of a
forward; a step is three forwards' worth) and from ``chip_smoke.py``'s
``gn_bytes_flops``, ``gn_bwd_bytes_flops``, ``flash_*_bytes_flops`` and
``bounds`` (each input byte read once, each output byte written once), so
that a later change to the program cannot move the yardstick.  Every
function takes the configuration as the benchmark's JSON holds it (the
``model`` mapping), never a config object of the program.

The counts of a configuration's work (``fwd_flops``, ``attn_calls``,
``gn_calls``) are its reference module's where that defines them (a
configuration brings its own as a new file); the U-Net's and the DiT's
here are the fallback for a reference that defines none.  What follows
from them (``train_step_flops``, ``flash_bound_s``, ``gn_bound_s``) takes
the same ``counts``; :func:`with_counts` binds them for a per-layer reader.
"""

from __future__ import annotations

import functools
import types
from typing import List, Tuple

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "fwd_flops", "train_step_flops",
           "gn_calls", "attn_calls", "gn_bytes_flops",
           "gn_bwd_bytes_flops", "flash_bytes_flops", "flash_dq_bytes_flops",
           "flash_dkv_bytes_flops", "bound_s", "gn_bound_s", "flash_bound_s",
           "unet_levels", "with_counts"]

#: dense peaks of one H100 SXM (NVIDIA's data sheet): FLOP/s by operand type
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: HBM3 bandwidth of one H100 SXM, bytes/s
HBM_BYTES_PER_S = 3.35e12


# --------------------------------------------------------------- FLOPs (MFU)

def unet_levels(m: dict) -> Tuple[List[dict], int]:
    """Per-level (resolution, out_ch, use_attn, downsample) and the
    bottleneck resolution: the resolution halves after every level but the
    last."""
    levels, res = [], m["img_resolution"]
    mults = list(m["channel_mults"])
    for i, mult in enumerate(mults):
        last = i == len(mults) - 1
        levels.append(dict(resolution=res, out_ch=m["base_channels"] * mult,
                           use_attn=res in set(m["attn_resolutions"]), downsample=not last))
        if not last:
            res //= 2
    return levels, res


def _conv(res, k, cin, cout, batch):
    return 2 * batch * res * res * k * k * cin * cout


def _resblock(res, cin, cout, td, batch):
    f = _conv(res, 3, cin, cout, batch) + _conv(res, 3, cout, cout, batch)
    f += 2 * batch * td * cout
    if cin != cout:
        f += _conv(res, 1, cin, cout, batch)
    return f


def _attn(res, ch, heads, head_dim, batch):
    n, inner = res * res, heads * head_dim
    return (2 * batch * n * ch * 3 * inner + 2 * batch * n * inner * ch
            + 4 * batch * heads * n * n * head_dim)


def unet_fwd_flops(m: dict, batch: int) -> int:
    levels, bres = unet_levels(m)
    td = m["time_embed_dim"]
    f = 2 * batch * td * td * 2
    f += _conv(m["img_resolution"], 3, m["in_channels"], m["base_channels"], batch)
    ch = m["base_channels"]
    for lv in levels:
        res, out = lv["resolution"], lv["out_ch"]
        for _ in range(m["num_res_blocks"]):
            f += _resblock(res, ch, out, td, batch)
            ch = out
            if lv["use_attn"]:
                f += _attn(res, ch, m["num_heads"], m["head_dim"], batch)
        if lv["downsample"]:
            f += _conv(res // 2, 3, ch, ch, batch)
    mid = levels[-1]["out_ch"]
    f += _resblock(bres, ch, mid, td, batch)
    if bres in set(m["attn_resolutions"]):
        f += _attn(bres, mid, m["num_heads"], m["head_dim"], batch)
    f += _resblock(bres, mid, mid, td, batch)
    ch = mid
    for li, lv in enumerate(reversed(levels)):
        res, out = lv["resolution"], lv["out_ch"]
        if li > 0:
            f += _conv(res, 3, ch, ch, batch)
        f += _resblock(res, ch + out, out, td, batch)
        ch = out
        for _ in range(m["num_res_blocks"]):
            f += _resblock(res, ch, out, td, batch)
    f += _conv(m["img_resolution"], 3, ch, m["in_channels"], batch)
    return int(f)


def dit_fwd_flops(m: dict, batch: int) -> int:
    N = (m["img_resolution"] // m["patch_size"]) ** 2
    H, L, r = m["hidden_size"], m["depth"], m["mlp_ratio"]
    pc = m["patch_size"] ** 2 * m["in_channels"]
    E = m.get("num_experts", 0)
    if E:
        C = max(1, -(-int(N * m.get("capacity_factor", 1.25)) // E))
        mlp = 2 * N * H * E + 4 * r * H * H * E * C + 4 * N * E * C * H
    else:
        mlp = 4 * r * N * H * H
    per_block = 8 * N * H * H + mlp + 4 * N * N * H + 12 * H * H
    f = 2 * N * pc * H + 2 * (m["time_embed_dim"] * H + H * H) + L * per_block
    f += 4 * H * H + 2 * N * H * pc
    return int(batch * f)


# ------------------------------------------------------------ the op work

def unet_gn_calls(m: dict, batch: int) -> List[Tuple[Tuple[int, int, int, int], bool]]:
    """A U-Net's: two per ResBlock, the second with the time bias, then the
    head's; the attention blocks' GroupNorm is a plain one and not in the
    list."""
    levels, bres = unet_levels(m)
    calls = []

    def res_block(res, cin, cout):
        calls.append(((batch, res, res, cin), False))
        calls.append(((batch, res, res, cout), True))

    ch = m["base_channels"]
    for lv in levels:
        for _ in range(m["num_res_blocks"]):
            res_block(lv["resolution"], ch, lv["out_ch"])
            ch = lv["out_ch"]
    res_block(bres, ch, ch)
    res_block(bres, ch, ch)
    for lv in reversed(levels):
        res_block(lv["resolution"], ch + lv["out_ch"], lv["out_ch"])
        ch = lv["out_ch"]
        for _ in range(m["num_res_blocks"]):
            res_block(lv["resolution"], ch, ch)
    calls.append(((batch, m["img_resolution"], m["img_resolution"], ch), False))
    return calls


def dit_gn_calls(m: dict, batch: int) -> list:
    """A DiT has none."""
    return []


def unet_attn_calls(m: dict, batch: int) -> List[Tuple[int, int, int]]:
    levels, bres = unet_levels(m)
    shape = lambda res: (batch * m["num_heads"], res * res, m["head_dim"])  # noqa: E731
    calls = [shape(lv["resolution"]) for lv in levels if lv["use_attn"]
             for _ in range(m["num_res_blocks"])]
    if bres in set(m["attn_resolutions"]):
        calls.append(shape(bres))
    return calls


def dit_attn_calls(m: dict, batch: int) -> List[Tuple[int, int, int]]:
    N = (m["img_resolution"] // m["patch_size"]) ** 2
    h = m["num_heads"]
    return [(batch * h, N, m["hidden_size"] // h)] * m["depth"]


# ---------------------------------------------- a configuration's counts

#: the counts of a configuration whose reference module defines none, by
#: its model's ``family`` (a DiT's; else the U-Net)
_FAMILY = {"dit": {"fwd_flops": dit_fwd_flops, "gn_calls": dit_gn_calls,
                   "attn_calls": dit_attn_calls},
           "unet": {"fwd_flops": unet_fwd_flops, "gn_calls": unet_gn_calls,
                    "attn_calls": unet_attn_calls}}


def _counted(m: dict, name: str, counts):
    """``counts.<name>`` where the reference module ``counts`` defines it,
    else the family's."""
    own = getattr(counts, name, None)
    if own is not None:
        return own
    return _FAMILY["dit" if m.get("family") == "dit" else "unet"][name]


def fwd_flops(m: dict, batch: int, counts=None) -> int:
    """Matmul and conv FLOPs of one forward of ``batch`` images."""
    return _counted(m, "fwd_flops", counts)(m, batch)


def train_step_flops(m: dict, batch: int, counts=None) -> int:
    """One update: the forward and a backward of about twice its work."""
    return 3 * fwd_flops(m, batch, counts)


def gn_calls(m: dict, batch: int, counts=None) -> List[Tuple[Tuple[int, int, int, int], bool]]:
    """Every GroupNorm+SiLU of one forward: ((B, H, W, C), with a time
    bias), in the forward's order."""
    return _counted(m, "gn_calls", counts)(m, batch)


def attn_calls(m: dict, batch: int, counts=None) -> List[Tuple[int, int, int]]:
    """Every attention of one forward as its (B * heads, N, head_dim)."""
    return _counted(m, "attn_calls", counts)(m, batch)


def gn_bytes_flops(shape, dtype_bytes, with_tb):
    """Forward: read x, write y; the (C,) affine, the (B, C) time bias and
    the (B, C) mean and rstd in fp32; ~10 flops per element."""
    B, H, W, C = shape
    n = B * H * W * C
    small = (2 * C + (B * C if with_tb else 0) + 2 * B * C) * 4
    return 2 * n * dtype_bytes + small, 10 * n


def gn_bwd_bytes_flops(shape, dtype_bytes, with_tb, want_dtb):
    """Backward: read x and dy, write dx; read the affine, the time bias,
    mean and rstd, write the two (B, C) partial sums and dtb, all fp32;
    ~30 flops per element over the two sweeps."""
    B, H, W, C = shape
    n = B * H * W * C
    small = (2 * C + (B * C if with_tb else 0) + 2 * B * C + 2 * B * C
             + (B * C if want_dtb else 0)) * 4
    return 3 * n * dtype_bytes + small, 30 * n


def flash_bytes_flops(shape, dtype_bytes):
    """Forward: read q, k, v, write O and the fp32 LSE; QK^T and PV."""
    BH, N, d = shape
    return 4 * BH * N * d * dtype_bytes + BH * N * 4, 4 * BH * N * N * d


def flash_dq_bytes_flops(shape, dtype_bytes):
    """dQ: read q, k, v, dO and the fp32 LSE and delta, write dQ; QK^T,
    dO V^T and dS K."""
    BH, N, d = shape
    return 5 * BH * N * d * dtype_bytes + 2 * BH * N * 4, 6 * BH * N * N * d


def flash_dkv_bytes_flops(shape, dtype_bytes):
    """dK, dV: read q, k, v, dO, LSE and delta, write dK and dV; QK^T,
    dO V^T, P^T dO and dS^T Q."""
    BH, N, d = shape
    return 6 * BH * N * d * dtype_bytes + 2 * BH * N * 4, 8 * BH * N * N * d


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time for the work: the larger of bytes over HBM bandwidth
    and operations over the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def gn_bound_s(m: dict, batch: int, backward: bool, dtype_bytes: int = 2,
               counts=None) -> float:
    """The least time of one forward's GroupNorm+SiLU work (with
    ``backward``, of its backward as well; every time bias takes a
    gradient)."""
    total = 0.0
    for shape, tb in gn_calls(m, batch, counts):
        total += bound_s(*gn_bytes_flops(shape, dtype_bytes, tb))
        if backward:
            total += bound_s(*gn_bwd_bytes_flops(shape, dtype_bytes, tb, tb))
    return total


def flash_bound_s(m: dict, batch: int, backward: bool, dtype_bytes: int = 2,
                  counts=None) -> float:
    """The least time of one forward's attention work (with ``backward``,
    of dQ and dK/dV as well)."""
    total = 0.0
    for shape in attn_calls(m, batch, counts):
        total += bound_s(*flash_bytes_flops(shape, dtype_bytes))
        if backward:
            total += bound_s(*flash_dq_bytes_flops(shape, dtype_bytes))
            total += bound_s(*flash_dkv_bytes_flops(shape, dtype_bytes))
    return total


def with_counts(counts) -> types.SimpleNamespace:
    """This module's names with the reference module ``counts`` bound into
    every function that takes it: what a per-layer reader gets as
    ``ctx.work``."""
    ns = {k: globals()[k] for k in __all__ if k != "with_counts"}
    for k in ("fwd_flops", "train_step_flops", "gn_calls", "attn_calls", "gn_bound_s",
              "flash_bound_s"):
        ns[k] = functools.partial(ns[k], counts=counts)
    return types.SimpleNamespace(**ns)
