"""Sampling service: an HTTP endpoint over a loaded U-Net, on one device.

Counterpart of ``ddpm_diffusion_model_tpu/serving.py`` for DDIM and
DPM-Solver++ sampling and image editing, unconditional or with a class and
classifier-free guidance, for one-forward sampling of a consistency
student, and for super-resolution upsampling.  Stdlib-only
(``ThreadingHTTPServer``); device work serializes behind one lock.

    python -m ddpm_diffusion_model_tpu_torch.serving --ckpt ck/run_last [--device cuda]
    python -m ddpm_diffusion_model_tpu_torch.serving --ckpt x.pt [--device cuda]
    GET /healthz                 -> {"status": "ok", ...}
    GET /sample?n=4&steps=50&eta=0.0&seed=7&schedule=t_linear&format=png|npy
                &sampler=ddim|dpmpp|cm   (cm: consistency students, 1-NFE)
                &class_id=K&guidance=W
    POST /edit   {"image": <b64 PNG>, "mode": "img2img"|"inpaint", ...}
                 -> edited grid (SDEdit / RePaint, sampling/editing.py)
    POST /upsample {"image": <b64 PNG>, "n": 4, "steps": 50, ...}
                 -> super-resolved grid (SR upsampler checkpoints only:
                    cond_channels > 0, sampling/superres.py; /sample and
                    /edit are refused on those checkpoints and vice versa)
    GET /metrics                 -> counters, latency quantiles, kernel launches

Kept from the JAX service: steps snap to ``STEP_CHOICES``, n is capped at
``MAX_N``, the parameters actually used come back in ``X-Used-*`` headers,
and eta=0 and DPM-Solver++ requests are coalesced into one device batch
per (sampler, steps, schedule, guidance) while each request's images depend
only on its own seed and label (labels go per row, so requests for
different classes share a batch).
``/edit`` snaps strength to ``STRENGTH_STEP`` and caps resamples at
``MAX_RESAMPLES``; ``/upsample`` takes a low-res image of any size up to
the model's and runs under the device lock, uncoalesced, as in JAX.
Dropped: the power-of-two row padding, which only bounded XLA's compile
cache (eager PyTorch compiles nothing per shape), so every route draws n
rows.  ``guidance`` is clamped to [0, 8] and snapped to 0.25 as the JAX
service does it before it is tested; ``class_id`` or a guidance other than
1 needs a class-conditional checkpoint (400 otherwise).  A consistency
student (``distill --mode consistency``; the checkpoint's ``extra`` says
so) serves ``sampler=cm`` only, at steps=1 and guidance 1 (its guidance
was baked in), and refuses ``/edit``; every other checkpoint refuses
``sampler=cm``.  Not ported yet: mesh serving.
``--ckpt`` takes a checkpoint directory of the port (``train``,
``distill``; the experiment comes from its meta, the EMA weights unless
``--no-ema``) or a reference-format ``.pt`` (the JAX CLI's
``export-torch``).
"""

from __future__ import annotations

import base64
import io
import json
import math
import os
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
from .sampling.inference import _ddim, ddim_from_init, dpmpp_from_init
from .sampling.loops import to_unit_interval
from .sampling.superres import upsample_infer_sample
from .sampling.timesteps import build_ddim_schedule
from .training.consistency import SIGMA_DATA, TIMESTEP_SCALING, cm_from_init
from .training.restore import checkpoint_experiment, load_run
from .utils.config import get_preset, preset_from_experiment
from .utils.device import resolve_device
from .utils.images import encode_png, load_image, make_grid
from .utils.interop import load_reference_checkpoint

__all__ = ["SamplerService", "make_server", "main"]


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
                 img_size: int, device: Union[str, torch.device] = "cuda",
                 consistency: bool = False, cm_guidance: Optional[float] = None,
                 cm_sigma_data: Optional[float] = None,
                 cm_timestep_scaling: Optional[float] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device,
                              memory_format=torch.channels_last).eval()
        self.sched = sched
        self.img_size = int(img_size)
        self._lock = threading.Lock()        # device work
        self._stats_lock = threading.Lock()  # counters, never held on device
        self._t_start = time.time()
        self._stats = {"requests": 0, "samples": 0, "errors": 0,
                       "client_errors": 0, "edits": 0, "upsamples": 0,
                       "coalesced_batches": 0, "multi_request_batches": 0,
                       "batch_size_hist": {}}
        # an SR upsampler (cond_channels > 0) serves /upsample only: its
        # forward needs x_cond, which /sample and /edit cannot build
        self.cond_channels = int(getattr(model.config, "cond_channels", 0) or 0)
        # a consistency student serves sampler=cm only: its weights
        # parameterize f through c_skip/c_out, not eps; its scalings are the
        # ones it was distilled with (the defaults for a checkpoint without)
        self.consistency = bool(consistency)
        self.cm_guidance = cm_guidance  # the guidance baked in, if any
        self.cm_sigma_data = float(SIGMA_DATA if cm_sigma_data is None else cm_sigma_data)
        self.cm_timestep_scaling = float(TIMESTEP_SCALING if cm_timestep_scaling is None
                                         else cm_timestep_scaling)
        self._latencies: list = []
        self._q_lock = threading.Lock()
        self._queues: dict = {}

    @classmethod
    def from_checkpoint(cls, ckpt_path: str, preset: Optional[str] = None,
                        ema: bool = True, device: Union[str, torch.device] = "cuda"
                        ) -> "SamplerService":
        """Serve a checkpoint directory of the port or a reference-format
        ``.pt``, the EMA weights unless ``ema=False``.  The architecture
        comes from ``preset`` if given, else from the experiment stored with
        the checkpoint (a directory's meta, the ``.pt``'s ``export-torch``
        extra), else ``celeba64_low`` (the JAX service's default).  A
        directory's ``extra`` marks a consistency student."""
        if os.path.isdir(ckpt_path):
            return cls._from_directory(ckpt_path, preset, ema, device)
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

    @classmethod
    def _from_directory(cls, path: str, preset: Optional[str], ema: bool,
                        device) -> "SamplerService":
        """A checkpoint directory written by ``save_checkpoint``."""
        exp = get_preset(preset) if preset is not None else (
            checkpoint_experiment(path) or get_preset("celeba64_low"))
        dev = resolve_device(device)
        model, sched, state, meta = load_run(path, exp, dev)
        if ema:
            model.load_state_dict(state.ema_params, strict=True)
        extra = (meta or {}).get("extra", {}) or {}
        return cls(model, sched, exp.img_size, device=dev,
                   consistency=extra.get("distill_mode") == "consistency",
                   cm_guidance=extra.get("distill_guidance"),
                   cm_sigma_data=extra.get("cm_sigma_data"),
                   cm_timestep_scaling=extra.get("cm_timestep_scaling"))

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

    @property
    def num_classes(self) -> int:
        return int(getattr(self.model.config, "num_classes", 0) or 0)

    def _snap_guidance(self, class_id, guidance: float) -> float:
        """Clamp and snap ``guidance`` to the 0.25 grid on [0, 8], then
        test, as the JAX service does: a class, or a guidance that does not
        snap to 1.0, needs a class-conditional checkpoint, and the class
        must be one of its ``num_classes``."""
        if not math.isfinite(guidance):
            raise ValueError(f"guidance must be finite, got {guidance!r}")
        guidance = min(max(float(guidance), 0.0), self.MAX_GUIDANCE)
        guidance = round(guidance / self.GUIDANCE_STEP) * self.GUIDANCE_STEP
        if class_id is not None or guidance != 1.0:
            if not self.num_classes:
                raise ValueError("class_id/guidance need a class-conditional checkpoint "
                                 "(model.num_classes > 0)")
            if class_id is not None and not 0 <= int(class_id) < self.num_classes:
                raise ValueError(f"class_id {class_id} out of range "
                                 f"[0, {self.num_classes})")
        return guidance

    def _used_class(self, used: dict, class_id, guidance: float) -> None:
        if self.num_classes:
            used["class_id"] = None if class_id is None else int(class_id)
            used["guidance"] = float(guidance)

    def _snap_steps(self, steps: int) -> int:
        return min(self.STEP_CHOICES, key=lambda s: abs(s - int(steps)))

    def _record(self, n: int, t0: float, counter: Optional[str] = None) -> None:
        """Count a served request of n images (and its route's ``counter``,
        ``edits`` or ``upsamples``) and its latency."""
        with self._stats_lock:
            self._stats["requests"] += 1
            if counter is not None:
                self._stats[counter] += 1
            self._stats["samples"] += n
            self._latencies.append(time.perf_counter() - t0)
            del self._latencies[:-self._LAT_WINDOW]

    def sample(self, n: int = 4, steps: int = 50, eta: float = 0.0,
               seed: int = 0, schedule_kind: str = "t_linear",
               sampler: str = "ddim", class_id=None, guidance: float = 1.0):
        """Returns ``(images, used)``: (n, H, W, C) float [0, 1] numpy and
        the parameters actually used after snapping.  Thread-safe.

        ``sampler="dpmpp"`` is deterministic (eta forced to 0).  eta=0 and
        DPM requests with the same (sampler, steps, schedule, guidance)
        landing within ``COALESCE_WINDOW_S`` run as ONE device batch; each
        request's rows depend only on its own seed's init noise (neither
        sampler adds in-loop noise) and its own label, so its images do not
        depend on what it was batched with.  On a conditional checkpoint a
        request without a class rides as the NULL token, on which guidance
        collapses to the unconditional forward.

        ``sampler="cm"`` serves a consistency student only (and only it):
        one forward from the seed's x_T, steps=1, guidance 1 (the student's
        was baked in); eta is forced to 0 and the schedule to ``t_linear``,
        so every cm request coalesces.  A conditional student asked without
        a class gets a ``warning`` in ``used``: its NULL class is
        untrained."""
        self._refuse_upsampler()
        if sampler not in ("ddim", "dpmpp", "cm"):
            raise ValueError(f"sampler must be 'ddim'|'dpmpp'|'cm', got {sampler!r}")
        if self.consistency != (sampler == "cm"):
            raise ValueError(
                "sampler=cm serves consistency-distilled checkpoints only"
                if sampler == "cm" else
                "this is a consistency student checkpoint — its weights "
                "parameterize f_theta, not eps; use sampler=cm (1-NFE)")
        if sampler == "cm":
            # multistep CM re-noises from one generator, which would
            # entangle coalesced requests' seeds: the CLI's sample-cm serves
            # steps > 1
            if int(steps) != 1:
                raise ValueError(
                    "sampler=cm serves 1-NFE only (steps=1): multistep CM "
                    "refinement is stochastic per batch — use the CLI "
                    "sample-cm for steps > 1")
            if guidance != 1.0:
                baked = (f" (w={self.cm_guidance} baked in at distillation)"
                         if self.cm_guidance is not None else "")
                raise ValueError("sampler=cm: guidance is fixed at distillation time"
                                 + baked + "; pass class_id only")
        if schedule_kind not in self.SCHEDULE_KINDS:
            raise ValueError(f"schedule must be one of {self.SCHEDULE_KINDS}, "
                             f"got {schedule_kind!r}")
        guidance = self._snap_guidance(class_id, guidance)
        if not math.isfinite(eta):
            raise ValueError(f"eta must be finite, got {eta!r}")
        if sampler in ("dpmpp", "cm"):
            eta = 0.0  # deterministic; always coalesced
        if sampler == "cm":
            schedule_kind = "t_linear"  # cm runs no ladder: one queue for all
        n = max(1, min(int(n), self.MAX_N))
        steps = self._snap_steps(steps)
        used = {"n": n, "steps": int(steps), "eta": float(eta),
                "seed": int(seed), "schedule": schedule_kind, "sampler": sampler,
                "guidance": guidance}
        self._used_class(used, class_id, guidance)
        if sampler == "cm" and self.num_classes and class_id is None:
            used["warning"] = (
                "conditional consistency student, no class_id: output uses "
                "the untrained NULL class and may be degraded — pass "
                "class_id")
        # per-row label: requests without a class ride as the NULL token
        label = (None if not self.num_classes
                 else (self.num_classes if class_id is None else int(class_id)))

        t0 = time.perf_counter()
        if eta == 0.0:
            out = self._sample_coalesced(n, steps, schedule_kind, int(seed), sampler,
                                         label, guidance)
        else:
            out = self._sample_direct(n, steps, float(eta), schedule_kind,
                                      int(seed), label, guidance)
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
        (x0, y0, x1, y1) and ``mask01`` (>= 0.5 = keep).  ``class_id`` and
        ``guidance`` as in :meth:`sample`.  Returns ``(images01, used)``: n
        variations, each row with its own noise.  Thread-safe; device work
        serializes."""
        self._refuse_upsampler()
        if self.consistency:
            raise ValueError(
                "/edit rides the eps-prediction boundary, which a "
                "consistency student's weights no longer satisfy — edit "
                "with the base (pre-distillation) checkpoint")
        if mode not in ("img2img", "inpaint"):
            raise ValueError(f"mode must be 'img2img'|'inpaint', got {mode!r}")
        if not math.isfinite(strength) or not math.isfinite(eta):
            raise ValueError("strength/eta must be finite")
        guidance = self._snap_guidance(class_id, guidance)
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
        self._used_class(used, class_id, guidance)
        kw = dict(n=n, steps=steps, eta=eta, seed=int(seed), out_path=None,
                  class_id=None if class_id is None else int(class_id),
                  guidance=guidance, device=self.device)
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
        self._record(n, t0, counter="edits")
        return out, used

    def _refuse_upsampler(self) -> None:
        if self.cond_channels:
            raise ValueError(
                "this is an SR upsampler checkpoint (cond_channels > 0) — "
                "use POST /upsample with a low-res image")

    def upsample(self, image01: np.ndarray, n: int = 4, steps: int = 50,
                 eta: float = 0.0, seed: int = 0, class_id=None,
                 guidance: float = 1.0):
        """Super-resolve a low-res image (``/upsample``) with an SR upsampler
        checkpoint (``cond_channels > 0``, ``sampling/superres.py``).
        ``image01``: (h, w, C) float [0, 1] at any resolution up to the
        service's; it is resized on the device into the conditioning
        channels.  n is capped at ``MAX_N``, steps snap to ``STEP_CHOICES``,
        eta is clamped to [0, 1] and ``class_id``/``guidance`` are handled as
        in :meth:`sample`.  Returns ``(images01, used)``: n variations, each
        row with its own noise over the shared conditioning.  Thread-safe;
        device work serializes, uncoalesced."""
        if not self.cond_channels:
            raise ValueError(
                "upsample needs an SR upsampler checkpoint "
                "(cond_channels > 0) — this service holds a plain denoiser; "
                "use GET /sample")
        if not math.isfinite(guidance) or not math.isfinite(eta):
            raise ValueError("eta/guidance must be finite")
        guidance = self._snap_guidance(class_id, guidance)
        S, C = self.img_size, self.model.config.in_channels
        img = np.asarray(image01, np.float32)
        if (img.ndim != 3 or img.shape[-1] != C
                or not 0 < img.shape[0] <= S or not 0 < img.shape[1] <= S):
            raise ValueError(f"image must be (h<={S}, w<={S}, {C}) in [0,1], "
                             f"got {img.shape}")
        n = max(1, min(int(n), self.MAX_N))
        steps = self._snap_steps(steps)
        eta = min(max(float(eta), 0.0), 1.0)
        used = {"n": n, "steps": int(steps), "eta": eta, "seed": int(seed),
                "low_res": list(img.shape[:2])}
        self._used_class(used, class_id, guidance)
        label = None if not self.num_classes or class_id is None else int(class_id)
        t0 = time.perf_counter()
        with self._lock:
            out = upsample_infer_sample(self.model, None, self.sched, img * 2.0 - 1.0, n=n,
                                        steps=steps, eta=eta, seed=int(seed), out_path=None,
                                        class_id=label, guidance=guidance,
                                        device=self.device)
        self._record(n, t0, counter="upsamples")
        return out, used

    def _sample_direct(self, n, steps, eta, schedule_kind, seed, label=None,
                       guidance=1.0):
        """One un-batched request: eta > 0 draws in-loop noise from the
        request's own generator, so merging would entangle seeds."""
        ts = build_ddim_schedule(schedule_kind, steps, self.sched.T,
                                 alphas_cumprod=self.sched.alphas_cumprod.cpu().numpy())
        with self._lock:
            x, _ = _ddim(self.model, None, self.sched, n, self.img_size, seed,
                         self.device, ts, eta, class_id=label, guidance=guidance)
            return to_unit_interval(x).float().cpu().numpy()

    def _init_noise(self, n: int, seed: int) -> torch.Tensor:
        """Request ``seed``'s x_T: the first draw of a generator seeded with
        it, as :func:`ddim_sample` draws it."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (n, self.img_size, self.img_size, self.model.config.in_channels)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32)

    def _sample_coalesced(self, n, steps, schedule_kind, seed, sampler="ddim",
                          label=None, guidance=1.0):
        """Enqueue; the first thread on an empty queue becomes the leader,
        waits ``COALESCE_WINDOW_S`` for company, takes the whole queue in
        one grab and serves it in <= MAX_N chunks.  Guidance keys the queue
        (one combine per batch); labels go per row and share it."""
        req = {"n": n, "seed": seed, "label": label, "event": threading.Event(),
               "out": None, "err": None}
        key = (sampler, steps, schedule_kind, guidance)
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
                    outs = self._run_eta0_batch(batch, steps, schedule_kind, sampler,
                                                guidance)
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

    def _run_eta0_batch(self, batch, steps, schedule_kind, sampler="ddim",
                        guidance=1.0):
        """ONE deterministic run (DDIM eta=0, DPM-Solver++(2M) or the
        consistency student's one forward) over the concatenated
        per-request init noise and labels, split back per request."""
        y = None
        if any(r["label"] is not None for r in batch):
            y = torch.from_numpy(np.concatenate(
                [np.full(r["n"], r["label"], np.int64) for r in batch])).to(self.device)
        with self._lock:
            x_init = torch.cat([self._init_noise(r["n"], r["seed"]) for r in batch])
            if sampler == "cm":
                x = cm_from_init(self.model, None, self.sched, x_init, y=y,
                                 sigma_data=self.cm_sigma_data,
                                 timestep_scaling=self.cm_timestep_scaling)
            else:
                ts = build_ddim_schedule(
                    schedule_kind, steps, self.sched.T,
                    alphas_cumprod=self.sched.alphas_cumprod.cpu().numpy())
                kernel = dpmpp_from_init if sampler == "dpmpp" else ddim_from_init
                x = kernel(self.model, self.sched, x_init, ts, y=y, guidance=guidance)
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
                    "num_classes": service.num_classes,
                    "edit_modes": [] if service.consistency else ["img2img", "inpaint"],
                    # a consistency student: sampler=cm is its only route
                    "consistency": service.consistency,
                    **({"consistency_caveat":
                        "conditional student; requests without class_id "
                        "use the untrained NULL class"}
                       if service.consistency and service.num_classes else {}),
                    "upsampler": bool(service.cond_channels),
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
                steps = max(1, min(int(q.get("steps", 1 if service.consistency else 50)),
                                   1000))
                eta = float(q.get("eta", 0.0))
                seed = int(q.get("seed", 0))
                fmt = q.get("format", "png")
                kind = q.get("schedule", "t_linear")
                sampler = q.get("sampler", "cm" if service.consistency else "ddim")
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
            routes = {"/edit": (self._edit_args, service.edit),
                      "/upsample": (self._upsample_args, service.upsample)}
            if url.path not in routes:
                self._json(404, {"error": "unknown path"})
                return
            parse, run = routes[url.path]
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= self.MAX_EDIT_BODY:
                    raise ValueError(f"body length {length} out of range")
                req = json.loads(self.rfile.read(length))
                if "image" not in req:
                    raise ValueError("missing 'image' (base64 PNG/JPEG)")
                img01, kw = parse(req)
                kw.update(class_id=(int(req["class_id"])
                                    if req.get("class_id") is not None else None),
                          guidance=float(req.get("guidance", 1.0)))
                fmt = req.get("format", "png")
            except Exception as e:  # noqa: BLE001 -- a body that does not decode
                service.record_client_error()
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                x, used = run(img01, **kw)
            except ValueError as e:
                # edit() and upsample() validate every field before device work
                service.record_client_error()
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 -- surfaced as a 500
                service.record_error()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_images(x, used, fmt)

        @staticmethod
        def _edit_args(req):
            img01 = load_image(io.BytesIO(base64.b64decode(req["image"])),
                               size=service.img_size)
            mask01 = None
            if req.get("mask") is not None:
                mask01 = load_image(io.BytesIO(base64.b64decode(req["mask"])),
                                    size=service.img_size, grayscale=True)
            return img01, dict(mode=str(req.get("mode", "img2img")),
                               n=int(req.get("n", 4)), steps=int(req.get("steps", 50)),
                               strength=float(req.get("strength", 0.6)),
                               eta=float(req.get("eta", 0.0)), seed=int(req.get("seed", 0)),
                               box=req.get("box"), mask01=mask01,
                               resamples=int(req.get("resamples", 1)))

        @staticmethod
        def _upsample_args(req):
            # the low-res input keeps its own size (the conditioning is
            # resized on the device); low_size crops and resizes it first
            low_size = int(req["low_size"]) if req.get("low_size") is not None else None
            img01 = load_image(io.BytesIO(base64.b64decode(req["image"])), size=low_size)
            return img01, dict(n=int(req.get("n", 4)), steps=int(req.get("steps", 50)),
                               eta=float(req.get("eta", 0.0)), seed=int(req.get("seed", 0)))

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
                    help="a checkpoint directory of the port (cli train, distill) or a "
                         "reference-format .pt (the JAX CLI's export-torch)")
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
