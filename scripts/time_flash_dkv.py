"""The flash-attention backward kernels of the PyTorch port on one card,
dK/dV and dQ (``--ops dkv dq``): checks and times.

``--check``: the route ``_dkv_route`` names for each shape (the two
wrappers share it), then the kernel against the plain float32 version
(``flash_attn_bwd_dkv_reference``, ``flash_attn_bwd_dq_reference``) and
against the mma.sync kernel on the same inputs, as the largest error over
the largest |value| (at least 1; 0 where the two are bit-equal), each
output apart; a second call bit-equal.  ``--time``: CUDA-event
times of the mma.sync (``tc``) and wgmma routes in turns (tc, wgmma, wgmma,
tc), each over ``--iters`` back-to-back calls, with the operations bound
(8 * BH * N^2 * d flops for dK/dV, 6 * BH * N^2 * d for dQ, at 989
TFLOP/s); the wgmma route only at its head dim.  ``--yardsticks``: beside
them the plain version (in chunks of 48 heads, so its N x N buffers fit)
and the backward of PyTorch's SDPA on the same operands (dQ, dK and dV in
one call), as yardsticks only.  One JSON line per op and shape; the first
line names the card, its power limit, the versions and the registers and
wgmma warnings of ptxas.

    python3 scripts/time_flash_dkv.py --ops dq dkv --check --time \\
        --shapes 48x4096x64 384x4096x64 384x512x64 6144x256x64

Imports no JAX: it runs on the machine with the card.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ddpm_diffusion_model_tpu_torch.ops import cuda_build  # noqa: E402
from ddpm_diffusion_model_tpu_torch.ops import flash_attention as fa  # noqa: E402

PEAK_FLOPS = 989e12


def card():
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    return {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}


def registers():
    """The registers ptxas gave each kernel of the wgmma source, and its
    warnings and notes on wgmma (a serialized wgmma, an injected wait)."""
    log = cuda_build._target("flash_attn_bwd_sm90").with_suffix(".log").read_text()
    regs = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '(\w+)'.*?Used (\d+) registers", log, re.S)}
    return regs, [ln.strip() for ln in log.splitlines()
                  if any(w in ln.lower() for w in ("warning", "wgmma", "warpgroup"))]


# per op: the wrapper, its wgmma counter, the plain version and the flops of
# its products over BH * N^2 * d
OPS = {"dkv": (fa.flash_attn_bwd_dkv, "bwd_dkv_wgmma_launches",
               fa.flash_attn_bwd_dkv_reference, 8),
       "dq": (fa.flash_attn_bwd_dq, "bwd_dq_wgmma_launches", fa.flash_attn_bwd_dq_reference, 6)}


def run(op, args):
    """The op's outputs as a tuple."""
    out = OPS[op][0](*args)
    return out if isinstance(out, tuple) else (out,)


def inputs(shape, seed):
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = fa.flash_attn_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


def on_route(op, route, args):
    """The op's outputs by the named route (the wrapper's own choice
    overridden)."""
    keep = fa._dkv_route
    fa._dkv_route = lambda *a: route
    try:
        return run(op, args)
    finally:
        fa._dkv_route = keep


def err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1.0)


def check(op, shape, seed):
    args = inputs(shape, seed)
    aligned = all(t.data_ptr() % 16 == 0 for t in (*args,))
    _, counter, plain, _ = OPS[op]
    route = fa._dkv_route(torch.bfloat16, shape[1], shape[2], aligned)
    before = getattr(fa, counter)
    got = run(op, args)
    torch.cuda.synchronize()
    row = {"op": op, "shape": list(shape), "route": route,
           "wgmma_launches": getattr(fa, counter) - before}
    row["repeat_equal"] = all(torch.equal(a, b) for a, b in zip(got, run(op, args)))
    tc = on_route(op, "tc", args)
    row["vs_tc"] = [err(a, b) for a, b in zip(got, tc)]
    if shape[0] * shape[1] ** 2 <= 48 * 4096 ** 2:
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        row["vs_plain"] = [err(a, w) for a, w in zip(got, want)]
        row["tc_vs_plain"] = [err(a, w) for a, w in zip(tc, want)]
    return row


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_shape(op, shape, seed, iters, yardsticks=False):
    args = inputs(shape, seed)
    BH, N, d = shape
    bound_ms = OPS[op][3] * BH * N * N * d / PEAK_FLOPS * 1e3
    routes = ["tc", "wgmma"] if d == fa.WGMMA_HEAD_DIM else ["tc"]
    times = {r: [] for r in routes}
    order = routes + routes[::-1]
    for r in order:
        times[r].append(cuda_ms(lambda: on_route(op, r, args), iters))
    row = {"op": op, "shape": list(shape), "bound_ms": bound_ms}
    for r, ms in times.items():
        row[f"{r}_ms"] = ms
        row[f"{r}_bound_share"] = [bound_ms / m for m in ms]
    if yardsticks:
        plain = OPS[op][2]
        row["plain_ms"] = cuda_ms(lambda: [plain(
            *(t[i:i + 48] for t in args)) for i in range(0, BH, 48)], 2)
        q, k, v, do = (t.detach().reshape(1, BH, N, d).requires_grad_() for t in args[:4])
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        row["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out, (q, k, v), do.detach(), retain_graph=True), iters)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", nargs="+", choices=sorted(OPS), default=["dkv"])
    ap.add_argument("--shapes", nargs="+", default=["48x4096x64", "384x4096x64"])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--yardsticks", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20)
    a = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split("x")) for s in a.shapes]
    cuda_build.build_all()
    regs, warnings = registers()
    print(json.dumps({**card(), "registers": regs, "ptxas_warnings": warnings}), flush=True)
    for kernel in ("flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"):
        wg = [n for n in regs if kernel in n]
        if not wg or regs[wg[0]] != 168:
            # setmaxnreg moves registers within the block's launch allocation:
            # 384 threads x 168 = 128 x 24 + 256 x 240.  Anything else would stall.
            print(json.dumps({"error": f"{kernel} is not at 168 registers"}), flush=True)
            return 1
    for shape in shapes:
        for op in a.ops:
            if a.check:
                print(json.dumps({"check": check(op, shape, a.seed)}), flush=True)
            if a.time:
                print(json.dumps({"time": time_shape(op, shape, a.seed, a.iters,
                                                     a.yardsticks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
