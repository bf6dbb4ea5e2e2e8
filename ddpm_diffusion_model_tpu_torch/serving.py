"""Sampling service: an HTTP endpoint over a loaded U-Net, on one device.

Counterpart of ``ddpm_diffusion_model_tpu/serving.py`` for unconditional
DDIM and DPM-Solver++ sampling and image editing.  Stdlib-only
(``ThreadingHTTPServer``); device work serializes behind one lock.

    python -m ddpm_diffusion_model_tpu_torch.serving --ckpt x.pt [--device cuda]
    GET /healthz                 -> {"status": "ok", ...}
    GET /sample?n=4&steps=50&eta=0.0&seed=7&schedule=t_linear&format=png|npy
                &sampler=ddim|dpmpp
    POST /edit   {"image": <b64 PNG>, "mode": "img2img"|"inpaint", ...}
                 -> edited grid (SDEdit / RePaint, sampling/editing.py)
    GET /metrics                 -> counters, latency quantiles, kernel launches

Kept from the JAX service: steps snap to ``STEP_CHOICES``, n is capped at
``MAX_N``, the parameters actually used come back in ``X-Used-*`` headers,
and eta=0 and DPM-Solver++ requests are coalesced into one device batch
per sampler while each request's images depend only on its own seed.
``/edit`` snaps strength to ``STRENGTH_STEP`` and caps resamples at
``MAX_RESAMPLES``.  Dropped: the power-of-two row padding, which only
bounded XLA's compile cache (eager PyTorch compiles nothing per shape).
``guidance`` is clamped and snapped as the JAX service does it before it
is tested.  Not ported yet (400): ``sampler=cm``, ``class_id`` and a
guidance that does not snap to 1.0, ``POST /upsample`` and mesh serving.
``.pt`` checkpoints are the reference format that the JAX CLI's
``export-torch`` writes.
"""

from __future__ import annotations

import base64
import io
import json
import math
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .models.unet import UNetDenoiser
from .ops import flash_attention, fused_norm
from .ops.schedules import DiffusionSchedule, make_schedule
from .sampling.editing import box_mask, img2img_infer_sample, inpaint_infer_sample
from .sampling.inference import ddim_from_init, ddim_sample, dpmpp_from_init
from .sampling.loops import to_unit_interval
from .sampling.timesteps import build_ddim_schedule
from .utils.config import get_preset, preset_from_experiment
from .utils.device import resolve_device
from .utils.images import encode_png, load_image, make_grid
from .utils.interop import load_reference_checkpoint

__all__ = ["SamplerService", "make_server", "main"]

_NOT_PORTED = "is not ported yet"


class SamplerService:
    """A U-Net and its schedule on one device, with the coalescer of the
    deterministic samplers."""

    STEP_CHOICES = (1, 2, 5, 10, 25, 50, 100, 250, 1000)
    MAX_N = 64
    SCHEDULE_KINDS = ("t_linear", "linear", "cosine", "t_cosine", "karras",
                      "alpha_bar_cosine")
    # guidance is clamped to [0, MAX_GUIDANCE] and snapped to this grid
    GUIDANCE_STEP = 0.25
    MAX_GUIDANCE = 8.0
    COALESCE_WINDOW_S = 0.005
    # /edit: strength snaps to this grid (it sets the tail's length);
    # resamples is capped
    STRENGTH_STEP = 0.05
    MAX_RESAMPLES = 4
    _LAT_WINDOW = 256

    def __init__(self, model: UNetDenoiser, sched: DiffusionSchedule,
                 img_size: int, device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.sched = sched
        self.img_size = int(img_size)
        self._lock = threading.Lock()        # device work
        self._stats_lock = threading.Lock()  # counters, never held on device
        self._t_start = time.time()
        self._stats = {"requests": 0, "samples": 0, "errors": 0,
                       "client_errors": 0, "edits": 0, "coalesced_batches": 0,
                       "multi_request_batches": 0, "batch_size_hist": {}}
        self._latencies: list = []
        self._q_lock = threading.Lock()
        self._queues: dict = {}

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, preset: Optional[str] = None,
                        ema: bool = True, device: Union[str, torch.device] = "cuda"
                        ) -> "SamplerService":
        """Serve a reference-format ``.pt``.  The architecture comes from
        ``preset`` if given, else from the experiment ``export-torch``
        stored in the file, else ``celeba64_low`` (the JAX service's
        default)."""
        sd, extra = load_reference_checkpoint(ckpt_path, ema=ema)
        if preset is not None:
            p = get_preset(preset)
        elif extra.get("experiment"):
            p = preset_from_experiment(extra["experiment"])
        else:
            p = get_preset("celeba64_low")
        dev = resolve_device(device)
        model = UNetDenoiser(p.model, device=dev)
        model.load_state_dict(sd, strict=True)
        return cls(model, make_schedule(p.diffusion, device=dev), p.img_size,
                   device=dev)

    # ---------------------------------------------------------------- stats

    def record_error(self) -> None:
        with self._stats_lock:
            self._stats["errors"] += 1

    def record_client_error(self) -> None:
        with self._stats_lock:
            self._stats["client_errors"] += 1

    def metrics(self) -> dict:
        """The ``/metrics`` payload: counters, latency quantiles over the
        recent window, and the kernels' launch counts."""
        with self._stats_lock:
            lats = list(self._latencies)
            stats = dict(self._stats)
            stats["batch_size_hist"] = dict(stats["batch_size_hist"])
        out = {
            **stats,
            "uptime_s": round(time.time() - self._t_start, 1),
            "latency_window": len(lats),
            "device": str(self.device),
            "kernel_launches": {"gn_silu_fwd": fused_norm.launches,
                                "flash_attn_fwd": flash_attention.launches},
        }
        if lats:
            q = np.quantile(np.asarray(lats), [0.5, 0.95, 1.0])
            out.update(latency_p50_s=round(float(q[0]), 4),
                       latency_p95_s=round(float(q[1]), 4),
                       latency_max_s=round(float(q[2]), 4))
        return out

    # ------------------------------------------------------------- sampling

    def _snap_guidance(self, class_id, guidance: float) -> float:
        """Clamp and snap ``guidance`` before the test, as the JAX service
        does: a guidance within 0.125 of 1.0 is the unconditional request;
        anything else, or a class, is not ported yet."""
        if not math.isfinite(guidance):
            raise ValueError(f"guidance must be finite, got {guidance!r}")
        guidance = min(max(float(guidance), 0.0), self.MAX_GUIDANCE)
        guidance = round(guidance / self.GUIDANCE_STEP) * self.GUIDANCE_STEP
        if class_id is not None or guidance != 1.0:
            raise ValueError(f"class-conditional sampling {_NOT_PORTED}")
        return guidance

    def _snap_steps(self, steps: int) -> int:
        return min(self.STEP_CHOICES, key=lambda s: abs(s - int(steps)))

    def _record(self, n: int, t0: float, edit: bool = False) -> None:
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["edits"] += int(edit)
            self._stats["samples"] += n
            self._latencies.append(time.perf_counter() - t0)
            del self._latencies[:-self._LAT_WINDOW]

    def sample(self, n: int = 4, steps: int = 50, eta: float = 0.0,
               seed: int = 0, schedule_kind: str = "t_linear",
               sampler: str = "ddim", class_id=None, guidance: float = 1.0):
        """Returns ``(images, used)``: (n, H, W, C) float [0, 1] numpy and
        the parameters actually used after snapping.  Thread-safe.

        ``sampler="dpmpp"`` is deterministic (eta forced to 0).  eta=0 and
        DPM requests with the same (sampler, steps, schedule) landing within
        ``COALESCE_WINDOW_S`` run as ONE device batch; each request's rows
        depend only on its own seed's init noise (neither sampler adds
        in-loop noise), so its images do not depend on what it was batched
        with."""
        if sampler == "cm":
            raise ValueError(f"sampler={sampler} {_NOT_PORTED}")
        if sampler not in ("ddim", "dpmpp"):
            raise ValueError(f"sampler must be 'ddim' or 'dpmpp', got {sampler!r}")
        if schedule_kind not in self.SCHEDULE_KINDS:
            raise ValueError(f"schedule must be one of {self.SCHEDULE_KINDS}, "
                             f"got {schedule_kind!r}")
        guidance = self._snap_guidance(class_id, guidance)
        if not math.isfinite(eta):
            raise ValueError(f"eta must be finite, got {eta!r}")
        if sampler == "dpmpp":
            eta = 0.0  # deterministic; always coalesced
        n = max(1, min(int(n), self.MAX_N))
        steps = self._snap_steps(steps)
        used = {"n": n, "steps": int(steps), "eta": float(eta),
                "seed": int(seed), "schedule": schedule_kind, "sampler": sampler,
                "guidance": guidance}

        t0 = time.perf_counter()
        if eta == 0.0:
            out = self._sample_coalesced(n, steps, schedule_kind, int(seed), sampler)
        else:
            out = self._sample_direct(n, steps, float(eta), schedule_kind,
                                      int(seed))
        self._record(n, t0)
        return out, used

    def edit(self, image01: np.ndarray, mode: str = "img2img", n: int = 4,
             steps: int = 50, strength: float = 0.6, eta: float = 0.0,
             seed: int = 0, box=None, mask01: Optional[np.ndarray] = None,
             resamples: int = 1, class_id=None, guidance: float = 1.0):
        """Edit a real image (``/edit``): SDEdit ``img2img`` or RePaint-style
        ``inpaint`` with :meth:`sample`'s snapping, strength snapped to
        ``STRENGTH_STEP`` in (0, 1], resamples capped at ``MAX_RESAMPLES``
        and eta clamped to [0, 1].  ``image01``: (H, W, C) float [0, 1] at
        the service's resolution; inpaint takes exactly one of ``box``
        (x0, y0, x1, y1) and ``mask01`` (>= 0.5 = keep).  Returns
        ``(images01, used)``: n variations, each row with its own noise.
        Thread-safe; device work serializes."""
        if mode not in ("img2img", "inpaint"):
            raise ValueError(f"mode must be 'img2img'|'inpaint', got {mode!r}")
        if not math.isfinite(strength) or not math.isfinite(eta):
            raise ValueError("strength/eta must be finite")
        self._snap_guidance(class_id, guidance)
        S, C = self.img_size, self.model.config.in_channels
        img = np.asarray(image01, np.float32)
        if img.shape != (S, S, C):
            raise ValueError(f"image must be ({S}, {S}, {C}) in [0,1], got {img.shape}")
        n = max(1, min(int(n), self.MAX_N))
        steps = self._snap_steps(steps)
        strength = min(max(float(strength), self.STRENGTH_STEP), 1.0)
        strength = round(strength / self.STRENGTH_STEP) * self.STRENGTH_STEP
        resamples = max(1, min(int(resamples), self.MAX_RESAMPLES))
        eta = min(max(float(eta), 0.0), 1.0)
        used = {"mode": mode, "n": n, "steps": int(steps), "eta": eta,
                "seed": int(seed)}
        kw = dict(n=n, steps=steps, eta=eta, seed=int(seed), out_path=None,
                  device=self.device)
        init = img * 2.0 - 1.0
        t0 = time.perf_counter()
        if mode == "img2img":
            used["strength"] = strength
            with self._lock:
                out = img2img_infer_sample(self.model, None, self.sched, init,
                                           strength=strength, **kw)
        else:
            used["resamples"] = resamples
            if (box is None) == (mask01 is None):
                raise ValueError("inpaint needs exactly one of 'box' or 'mask'")
            if box is not None:
                try:
                    mask = box_mask(S, [int(v) for v in box])
                except TypeError as e:
                    raise ValueError(f"box must be 4 ints (x0,y0,x1,y1): {e}") from e
            else:
                m = np.asarray(mask01, np.float32)
                if m.shape[:2] != (S, S):
                    raise ValueError(f"mask must be ({S}, {S}[, 1]), got {m.shape}")
                mask = (m.reshape(S, S, -1)[..., :1] >= 0.5).astype(np.float32)
            with self._lock:
                out = inpaint_infer_sample(self.model, None, self.sched, init, mask,
                                           resamples=resamples, **kw)
        self._record(n, t0, edit=True)
        return out, used

    def _sample_direct(self, n, steps, eta, schedule_kind, seed):
        """One un-batched request: eta > 0 draws in-loop noise from the
        request's own generator, so merging would entangle seeds."""
        with self._lock:
            return ddim_sample(self.model, None, self.sched, n=n,
                               img_size=self.img_size, seed=seed, steps=steps,
                               eta=eta, schedule=schedule_kind,
                               device=self.device)

    def _init_noise(self, n: int, seed: int) -> torch.Tensor:
        """Request ``seed``'s x_T: the first draw of a generator seeded with
        it, as :func:`ddim_sample` draws it."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (n, self.img_size, self.img_size, self.model.config.in_channels)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32)

    def _sample_coalesced(self, n, steps, schedule_kind, seed, sampler="ddim"):
        """Enqueue; the first thread on an empty queue becomes the leader,
        waits ``COALESCE_WINDOW_S`` for company, takes the whole queue in
        one grab and serves it in <= MAX_N chunks."""
        req = {"n": n, "seed": seed, "event": threading.Event(),
               "out": None, "err": None}
        key = (sampler, steps, schedule_kind)
        with self._q_lock:
            q = self._queues.setdefault(key, [])
            q.append(req)
            leader = len(q) == 1
        if leader:
            time.sleep(self.COALESCE_WINDOW_S)
            with self._q_lock:
                taken, q[:] = q[:], []
            while taken:
                batch, total = [], 0
                while taken and total + taken[0]["n"] <= self.MAX_N:
                    batch.append(taken.pop(0))
                    total += batch[-1]["n"]
                try:
                    outs = self._run_eta0_batch(batch, steps, schedule_kind, sampler)
                    for r, o in zip(batch, outs):
                        r["out"] = o
                except Exception as e:  # noqa: BLE001 -- delivered to every waiter
                    for r in batch:
                        r["err"] = e
                for r in batch:
                    r["event"].set()
        if not req["event"].wait(timeout=900):
            raise TimeoutError("coalesced sample timed out")
        if req["err"] is not None:
            raise RuntimeError(
                f"coalesced sample failed: {req['err']!r}") from req["err"]
        return req["out"]

    def _run_eta0_batch(self, batch, steps, schedule_kind, sampler="ddim"):
        """ONE deterministic run (DDIM eta=0 or DPM-Solver++(2M)) over the
        concatenated per-request init noise, split back per request."""
        ts = build_ddim_schedule(
            schedule_kind, steps, self.sched.T,
            alphas_cumprod=self.sched.alphas_cumprod.cpu().numpy())
        with self._lock:
            x_init = torch.cat([self._init_noise(r["n"], r["seed"]) for r in batch])
            kernel = dpmpp_from_init if sampler == "dpmpp" else ddim_from_init
            x = kernel(self.model, self.sched, x_init, ts)
            x01 = to_unit_interval(x).float().cpu().numpy()
        with self._stats_lock:
            self._stats["coalesced_batches"] += 1
            if len(batch) >= 2:
                self._stats["multi_request_batches"] += 1
            hist = self._stats["batch_size_hist"]
            hist[str(len(batch))] = hist.get(str(len(batch)), 0) + 1
        outs, off = [], 0
        for r in batch:
            outs.append(x01[off:off + r["n"]])
            off += r["n"]
        return outs


def make_server(service: SamplerService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "img_size": service.img_size,
                    "T": service.sched.T,
                    "step_choices": list(service.STEP_CHOICES),
                    "max_n": service.MAX_N,
                    "num_classes": 0,
                    "edit_modes": ["img2img", "inpaint"],
                    "consistency": False,
                    "upsampler": False,
                    "device": str(service.device),
                })
                return
            if url.path == "/metrics":
                self._json(200, service.metrics())
                return
            if url.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                n = max(1, min(int(q.get("n", 4)), service.MAX_N))
                steps = max(1, min(int(q.get("steps", 50)), 1000))
                eta = float(q.get("eta", 0.0))
                seed = int(q.get("seed", 0))
                fmt = q.get("format", "png")
                kind = q.get("schedule", "t_linear")
                sampler = q.get("sampler", "ddim")
                class_id = int(q["class_id"]) if "class_id" in q else None
                guidance = float(q.get("guidance", 1.0))
                x, used = service.sample(n=n, steps=steps, eta=eta, seed=seed,
                                         schedule_kind=kind, sampler=sampler,
                                         class_id=class_id, guidance=guidance)
            except ValueError as e:
                # sample() validates every parameter before device work, so a
                # ValueError is a client error by construction
                service.record_client_error()
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 -- surfaced as a 500
                service.record_error()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_images(x, used, fmt)

        MAX_EDIT_BODY = 32 << 20  # 32 MiB of JSON+base64 is plenty

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/upsample":
                service.record_client_error()
                self._json(400, {"error": f"POST {url.path} {_NOT_PORTED}"})
                return
            if url.path != "/edit":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= self.MAX_EDIT_BODY:
                    raise ValueError(f"body length {length} out of range")
                req = json.loads(self.rfile.read(length))
                if "image" not in req:
                    raise ValueError("missing 'image' (base64 PNG/JPEG)")
                img01 = load_image(io.BytesIO(base64.b64decode(req["image"])),
                                   size=service.img_size)
                mask01 = None
                if req.get("mask") is not None:
                    mask01 = load_image(io.BytesIO(base64.b64decode(req["mask"])),
                                        size=service.img_size, grayscale=True)
                kw = dict(
                    mode=str(req.get("mode", "img2img")),
                    n=int(req.get("n", 4)),
                    steps=int(req.get("steps", 50)),
                    strength=float(req.get("strength", 0.6)),
                    eta=float(req.get("eta", 0.0)),
                    seed=int(req.get("seed", 0)),
                    box=req.get("box"),
                    mask01=mask01,
                    resamples=int(req.get("resamples", 1)),
                    class_id=(int(req["class_id"])
                              if req.get("class_id") is not None else None),
                    guidance=float(req.get("guidance", 1.0)),
                )
                fmt = req.get("format", "png")
            except Exception as e:  # noqa: BLE001 -- a body that does not decode
                service.record_client_error()
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                x, used = service.edit(img01, **kw)
            except ValueError as e:
                # edit() validates every field before device work
                service.record_client_error()
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 -- surfaced as a 500
                service.record_error()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_images(x, used, fmt)

        def _send_images(self, x, used, fmt):
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, x)
                body, ctype = buf.getvalue(), "application/octet-stream"
            else:
                body, ctype = encode_png(make_grid(x)), "image/png"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Used-N", str(used["n"]))
            self.send_header("X-Used-Steps", str(used["steps"]))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="reference-format .pt (ddpm-tpu export-torch)")
    ap.add_argument("--preset", help="architecture preset, overriding the "
                    "experiment stored in the checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--no-ema", action="store_true")
    args = ap.parse_args(argv)

    service = SamplerService.from_checkpoint(
        args.ckpt, preset=args.preset, ema=not args.no_ema, device=args.device)
    server = make_server(service, args.host, args.port)
    print(f"[SERVE] sampling service on http://{args.host}:"
          f"{server.server_address[1]} ({service.device})", flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    while t.is_alive() and not stop.wait(0.5):
        pass
    died = not stop.is_set()
    print("[SERVE] draining ...", flush=True)
    server.shutdown()
    server.server_close()  # joins in-flight handler threads
    t.join(timeout=30)
    print(f"[SERVE] stopped | {json.dumps(service.metrics())}", flush=True)
    return 1 if died else 0


if __name__ == "__main__":
    sys.exit(main())
