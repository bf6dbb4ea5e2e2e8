"""Command line of the port: train, sample, strip, evaluate, inspect.

Counterpart of ``ddpm_diffusion_model_tpu/cli.py`` for the commands whose
modules are ported:

    python -m ddpm_diffusion_model_tpu_torch.cli train --preset celeba64_attn --data zip --zip-path faces.zip
    python -m ddpm_diffusion_model_tpu_torch.cli sample-ddpm --ckpt checkpoints/celeba64_attn_last --n 36
    python -m ddpm_diffusion_model_tpu_torch.cli sample-ddim --ckpt checkpoints/celeba64_attn_last --steps 50
    python -m ddpm_diffusion_model_tpu_torch.cli sample-dpmpp --ckpt checkpoints/celeba64_attn_last --steps 20
    python -m ddpm_diffusion_model_tpu_torch.cli img2img --ckpt checkpoints/celeba64_attn_last --init face.png
    python -m ddpm_diffusion_model_tpu_torch.cli inpaint --ckpt checkpoints/celeba64_attn_last --init face.png --box 16,16,48,48
    python -m ddpm_diffusion_model_tpu_torch.cli train --preset sr64to256 --data zip --zip-path faces256.zip --no-crop
    python -m ddpm_diffusion_model_tpu_torch.cli upsample --ckpt checkpoints/sr64to256_last --init face64.png
    python -m ddpm_diffusion_model_tpu_torch.cli cascade --ckpt checkpoints/sr64to256_last --base-ckpt checkpoints/celeba64_attn_last
    python -m ddpm_diffusion_model_tpu_torch.cli distill --ckpt checkpoints/celeba64_attn_last --out student --to-steps 4
    python -m ddpm_diffusion_model_tpu_torch.cli distill --ckpt checkpoints/celeba64_attn_last --out cm --mode consistency
    python -m ddpm_diffusion_model_tpu_torch.cli sample-cm --ckpt cm --steps 1
    python -m ddpm_diffusion_model_tpu_torch.cli strip --ckpt checkpoints/celeba64_attn_last --sampler ddim
    python -m ddpm_diffusion_model_tpu_torch.cli eval --ckpt checkpoints/celeba64_attn_last --data blobs
    python -m ddpm_diffusion_model_tpu_torch.cli info --preset celebahq256

The commands and flags are the JAX CLI's, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path, and without a card nothing
runs unless it is asked for).  Checkpoints are the port's directories
(``training/checkpoint.py``), not Orbax.  A class-conditional model is an
``ExperimentConfig`` JSON with ``model.num_classes > 0`` passed with
``--config``; it trains on the labelled sources (``--data blobs`` or
``synthetic``), samples and edits with ``--class-id`` / ``--guidance``, and
``eval --nll`` scores the variational bound.  A super-resolution upsampler
(``--preset sr64to256``, or a config with ``model.cond_channels`` and
``train.superres_factor``) trains on its batches' own low-res views,
upsamples a low-res image (``upsample``) and chains a base checkpoint
(``cascade``).  ``distill`` halves a checkpoint's DDIM ladder (progressive)
or trains a consistency student (``--mode consistency``), with guidance
baked in by ``--guidance``; ``sample-cm`` samples a consistency student.
Flags whose modules are not
ported (meshes, the sharded cache, latent diffusion, ``--data hf``) exit
with "... is not ported yet"; the JAX CLI's other commands come with their
modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from .training.restore import build_model, checkpoint_experiment, load_run

_NOT_PORTED = "is not ported yet"


def _not_ported(what: str):
    sys.exit(f"error: {what} {_NOT_PORTED}")


def _exp_from_args(args):
    from .utils.config import ExperimentConfig, get_preset

    if getattr(args, "config", None):
        with open(args.config) as f:
            return ExperimentConfig.from_json(f.read())
    exp = get_preset(args.preset)
    if getattr(args, "ckpt", None):
        return checkpoint_experiment(args.ckpt) or exp
    return exp


def _synthetic_array(exp, n, seed):
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=(n, exp.img_size, exp.img_size, 3)).astype(np.float32)
    return np.clip(arr * 0.4, -1, 1)


def _smoke_labels(n: int, nc: int):
    """Labels ``i % nc`` of the synthetic source (None without classes)."""
    return (np.arange(n, dtype=np.int64) % nc) if nc else None


def _blob_faces(n: int, img_size: int, seed: int, nc: int):
    """``n`` blob faces rendered once, as ``(images, labels)``: labels
    ``i % nc`` with class hues, or None without classes."""
    from .data import BlobFacesDataset

    ds = BlobFacesDataset(n, img_size=img_size, seed=seed, num_classes=nc)
    items = [ds[i] for i in range(n)]
    labels = np.asarray([y for _, y in items], np.int64) if nc else None
    return np.stack([im for im, _ in items]), labels


def _eval_set_size(args, exp):
    """Held-out set size for the procedural sources: ~1/8 of the train set
    in whole batches, at least one."""
    return max(args.synthetic_size // 8 // exp.batch_size, 1) * exp.batch_size


def _make_loader(args, exp, device, with_eval=False):
    """``(train, eval_or_None)`` for ``--data``: the official valid split
    for celeba, held-out sets of another seed for the procedural sources,
    a seeded ``--val-frac`` of a zip, else None."""
    from .data import (ArrayDataset, BlobFacesDataset, DataLoader, DeviceCacheLoader,
                       get_celeba_loader_from_zip, get_celeba_loaders, materialize_corpus)

    nc = int(getattr(exp.model, "num_classes", 0))
    device_cache = bool(getattr(args, "device_cache", False))
    if nc and args.data in ("zip", "hf", "celeba"):
        sys.exit(f"error: --data {args.data} has no labels; conditional "
                 "models train on labeled sources (--data blobs assigns "
                 "class hues, --data synthetic assigns smoke labels)")
    cache_kw = dict(quantize=True, progress=True, device=device)

    def from_array(arr, seed, labels=None):
        if device_cache:
            return DeviceCacheLoader(arr, exp.batch_size, seed=seed, labels=labels,
                                     **cache_kw)
        return DataLoader(ArrayDataset(np.asarray(arr), labels), exp.batch_size, seed=seed,
                          shuffle=True)

    def maybe_cached(loader):
        """Decode-per-item sources: decode the corpus once and keep it on
        the card as uint8."""
        if not device_cache or loader is None:
            return loader
        return DeviceCacheLoader(materialize_corpus(loader, progress=True), exp.batch_size,
                                 seed=exp.seed, **cache_kw)

    if args.data == "synthetic":
        n = args.synthetic_size
        train = from_array(_synthetic_array(exp, n, exp.seed), exp.seed, _smoke_labels(n, nc))
        n_eval = _eval_set_size(args, exp)
        val = (DataLoader(ArrayDataset(_synthetic_array(exp, n_eval, exp.seed + 777),
                                       _smoke_labels(n_eval, nc)),
                          exp.batch_size, shuffle=False) if with_eval else None)
        return train, val
    if args.data == "blobs":
        if getattr(args, "preload", False) or device_cache:
            # render the corpus once: per-item rendering cannot feed the card
            arr, labels = _blob_faces(args.synthetic_size, exp.img_size, exp.seed, nc)
            train = from_array(arr, exp.seed, labels)
        else:
            train = DataLoader(BlobFacesDataset(args.synthetic_size, img_size=exp.img_size,
                                                seed=exp.seed, num_classes=nc),
                               exp.batch_size, seed=exp.seed, shuffle=True)
        val = None
        if with_eval:
            n_eval = _eval_set_size(args, exp)
            if device_cache:
                arr, labels = _blob_faces(n_eval, exp.img_size, exp.seed + 777, nc)
                val = DeviceCacheLoader(arr, exp.batch_size, shuffle=False, quantize=True,
                                        labels=labels, device=device)
            else:
                val = DataLoader(BlobFacesDataset(n_eval, img_size=exp.img_size,
                                                  seed=exp.seed + 777, num_classes=nc),
                                 exp.batch_size, shuffle=False)
        return train, val
    if args.data == "zip":
        if not args.zip_path:
            raise SystemExit("error: --data zip requires --zip-path <file.zip>")
        if not os.path.exists(args.zip_path):
            raise SystemExit(f"error: zip not found: {args.zip_path}")
        zl = get_celeba_loader_from_zip(
            args.zip_path, img_size=exp.img_size, batch_size=exp.batch_size,
            seed=exp.seed, crop=None if getattr(args, "no_crop", False) else 178)
        print(f"[DATA] zip corpus: {len(zl.dataset)} images, decoder "
              f"{zl.dataset.decoder}")
        vf = float(getattr(args, "val_frac", 0.0) or 0.0)
        if vf > 0.0:
            # no official partition: hold out a seeded fraction
            arr = materialize_corpus(zl, progress=True)
            n_val = max(1, min(len(arr) - 1, int(round(len(arr) * vf))))
            perm = np.random.default_rng(exp.seed).permutation(len(arr))
            va_arr, tr_arr = arr[perm[:n_val]], arr[perm[n_val:]]
            print(f"[SPLIT] zip corpus {len(arr)} -> train {len(tr_arr)} / "
                  f"val {n_val} (seed {exp.seed})")
            vbs = min(exp.batch_size, n_val)
            if device_cache:
                train = DeviceCacheLoader(tr_arr, exp.batch_size, seed=exp.seed, **cache_kw)
                val = (DeviceCacheLoader(va_arr, vbs, shuffle=False, drop_last=False,
                                         quantize=True, device=device)
                       if with_eval else None)
            else:
                train = DataLoader(ArrayDataset(tr_arr), exp.batch_size, seed=exp.seed,
                                   shuffle=True)
                val = (DataLoader(ArrayDataset(va_arr), vbs, shuffle=False,
                                  drop_last=False) if with_eval else None)
            return train, val
        return maybe_cached(zl), None
    if args.data == "celeba":
        train, va, _te = get_celeba_loaders(data_dir=args.data_dir, img_size=exp.img_size,
                                            batch_size=exp.batch_size, seed=exp.seed)
        return maybe_cached(train), va if with_eval else None
    if args.data == "hf":
        _not_ported("--data hf (the HuggingFace download)")
    raise ValueError(args.data)


def cmd_train(args):
    from .ops.superres import degrade
    from .sampling import ddpm_sample, upsample_infer_sample
    from .training import train_ddpm
    from .utils.config import ExperimentConfig

    if getattr(args, "mesh", "none") != "none":
        _not_ported(f"--mesh {args.mesh} (multi-card training)")
    if getattr(args, "device_cache_sharded", False):
        _not_ported("--device-cache-sharded (a corpus sharded over cards)")
    if getattr(args, "latent_vae", None):
        _not_ported("--latent-vae (latent diffusion)")
    exp = _exp_from_args(args)
    if getattr(args, "loss_weighting", None):
        exp = ExperimentConfig.from_dict({
            **exp.to_dict(),
            "train": {**exp.train.to_dict(), "loss_weighting": args.loss_weighting}})
    device = args.device
    model, sched = build_model(exp, device)
    loader, eval_loader = _make_loader(args, exp, device,
                                       with_eval=bool(getattr(args, "eval_every", 0)))

    nc = int(getattr(exp.model, "num_classes", 0))
    sr_f = int(getattr(exp.train, "superres_factor", 0) or 0)
    sr_anchor = {}

    def sample_fn(model_, params_, sched_, *, n, img_size, save_path, seed):
        if sr_f:
            # an upsampler's grid upsamples a FIXED low-res anchor (the first
            # train batch, degraded, tiled to n), so consecutive grids compare
            if "low" not in sr_anchor:
                x = _as_eval_array(next(iter(loader)))
                x = np.resize(x, (n, *x.shape[1:]))  # tile if the batch is < n
                sr_anchor["low"] = degrade(torch.from_numpy(x).to(device), sr_f)
            return upsample_infer_sample(model_, params_, sched_, sr_anchor["low"], n=n,
                                         steps=min(50, sched_.T - 1), seed=seed,
                                         out_path=save_path, device=device)
        # the (n, H, W, C) [0, 1] samples, so the loop can score rFID; a
        # conditional run's grid cycles the classes (row i is class i % K,
        # guidance 1), so every class shows and rFID compares like for like
        return ddpm_sample(model_, params_, sched_, n, img_size, seed=seed,
                           save_path=save_path, return_grid=False,
                           class_id=_smoke_labels(n, nc), device=device)

    fid_ref = None
    if args.data == "blobs" and not args.no_samples:
        # a held-out reference of another seed for the per-epoch rFID, from
        # the labelled distribution when the model is conditional
        fid_ref = _blob_faces(128, exp.img_size, exp.seed + 999, nc)[0]

    if getattr(args, "eval_every", 0) and eval_loader is None:
        print(f"[EVAL] no validation split for --data {args.data}; skipping eval")

    _state, summary = train_ddpm(
        model, sched, loader, train_config=exp.train,
        epochs=args.epochs if args.epochs is not None else exp.epochs,
        max_batches=args.max_batches,
        sample_every=exp.sample_every, sample_n=exp.sample_n, img_size=exp.img_size,
        sample_fn=sample_fn if not args.no_samples else None,
        ckpt_dir=args.ckpt_dir, run_name=exp.run_name, save_every=exp.save_every,
        resume_path=args.resume,
        log_every=args.log_every if args.log_every is not None else exp.log_every,
        probe_timesteps=[10, 50, 200, 500] if args.probes else None,
        log_grad_norm=args.probes,
        configs_for_ckpt={"experiment": exp.to_dict()},
        fid_reference=fid_ref, fid_extractor=getattr(args, "fid_extractor", None),
        eval_loader=eval_loader, eval_every=max(getattr(args, "eval_every", 0), 1),
        eval_max_batches=getattr(args, "eval_max_batches", None),
        reset_optimizer_state=getattr(args, "reset_optimizer", False),
        override_lr=getattr(args, "override_lr", None),
        override_weight_decay=getattr(args, "override_weight_decay", None),
        override_ema_decay=getattr(args, "override_ema_decay", None),
        repair_ema_on_resume={"auto": True, "force": "force"}.get(
            getattr(args, "repair_ema", None), False))
    final = summary["epochs"][-1]["loss"] if summary["epochs"] else None
    out = {"final_loss": final}
    rfids = [e["rfid"] for e in summary["epochs"] if "rfid" in e]
    if rfids:
        out["rfid_first"], out["rfid_last"] = rfids[0], rfids[-1]
    print(json.dumps(out))


def _check_sampling_flags(args):
    """The sampling flags of the JAX CLI whose modules are not ported."""
    if getattr(args, "vae", None):
        _not_ported("--vae (latent diffusion)")
    if getattr(args, "sharded", False):
        _not_ported("--sharded (sampling over several cards)")


def _class_vec(args, exp):
    """``--class-id``: None, an int (the whole grid) or ``all`` (the
    classes cycled over the grid's rows) -> the samplers' ``class_id``."""
    cid = getattr(args, "class_id", None)
    if cid is None:
        if getattr(args, "guidance", 1.0) != 1.0:
            sys.exit("error: --guidance needs --class-id (what to guide "
                     "toward); use --class-id all for a class-cycled grid")
        return None
    nc = int(getattr(exp.model, "num_classes", 0))
    if not nc:
        sys.exit("error: --class-id needs a class-conditional checkpoint "
                 "(model.num_classes > 0)")
    if getattr(args, "refresh_every", 0) > 1:
        sys.exit("error: --class-id with --refresh-every (encoder-cached "
                 "sampling) is not supported")
    if cid == "all":
        return np.arange(args.n, dtype=np.int64) % nc
    k = int(cid)
    if not 0 <= k < nc:
        sys.exit(f"error: --class-id {k} out of range [0, {nc})")
    return k


def _cfg_msg(args):
    if getattr(args, "class_id", None) is None:
        return ""
    return f" (class={args.class_id}, guidance={args.guidance})"


def cmd_sample_ddpm(args):
    from .sampling import ddpm_infer_sample

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)  # flag mistakes fail before the checkpoint loads
    model, sched, state, _meta = load_run(args.ckpt, exp, args.device)
    ddpm_infer_sample(model, None, sched, n=args.n, img_size=exp.img_size,
                      ema_params=state.ema_params if args.ema else None,
                      out_path=args.out, seed=args.seed,
                      save_individual=args.individual, class_id=cls,
                      guidance=args.guidance, device=args.device)
    print(f"[INFER] grid -> {args.out}{_cfg_msg(args)}")


def cmd_sample_ddim(args):
    from .sampling import ddim_infer_sample, ddim_sample_fast

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)
    model, sched, state, _meta = load_run(args.ckpt, exp, args.device)
    if args.refresh_every > 1:
        # encoder-cached: decoder-only reuse steps between encoder refreshes
        ddim_sample_fast(model, None, sched, n=args.n, img_size=exp.img_size,
                         ema_params=state.ema_params if args.ema else None,
                         save_path=args.out, seed=args.seed, steps=args.steps,
                         eta=args.eta, schedule_kind=args.schedule,
                         refresh_every=args.refresh_every, device=args.device)
        print(f"[INFER-DDIM] grid -> {args.out} (steps={args.steps},"
              f" encoder-cached 1/{args.refresh_every})")
        return
    ddim_infer_sample(model, None, sched, n=args.n, img_size=exp.img_size,
                      ema_params=state.ema_params if args.ema else None,
                      out_path=args.out, seed=args.seed, steps=args.steps, eta=args.eta,
                      schedule_kind=args.schedule, save_individual=args.individual,
                      class_id=cls, guidance=args.guidance, device=args.device)
    print(f"[INFER-DDIM] grid -> {args.out} (steps={args.steps}, eta={args.eta})"
          f"{_cfg_msg(args)}")


def cmd_sample_dpmpp(args):
    from .sampling import dpmpp_infer_sample

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)
    model, sched, state, _meta = load_run(args.ckpt, exp, args.device)
    dpmpp_infer_sample(model, None, sched, n=args.n, img_size=exp.img_size,
                       ema_params=state.ema_params if args.ema else None,
                       out_path=args.out, seed=args.seed, steps=args.steps,
                       schedule_kind=args.schedule, save_individual=args.individual,
                       class_id=cls, guidance=args.guidance, sde=args.sde,
                       device=args.device)
    variant = "SDE" if args.sde else ""
    print(f"[INFER-DPM++{variant}] grid -> {args.out} (steps={args.steps})"
          f"{_cfg_msg(args)}")


def cmd_distill(args):
    """Progressive distillation (halve a checkpoint's DDIM ladder down to
    ``--to-steps``, ``training/distill.py``) or consistency distillation
    (``--mode consistency``, ``training/consistency.py``).  A progressive
    student samples with ``sample-ddim --schedule linear --steps
    <to-steps>``, a consistency student with ``sample-cm``; a
    ``--guidance`` teacher bakes classifier-free guidance into the student,
    which then samples guided at one forward's cost."""
    from .training import (TrainConfig, consistency_distill, init_train_state,
                           progressive_distill, save_checkpoint)

    exp = _exp_from_args(args)
    nc = int(getattr(exp.model, "num_classes", 0))
    if args.guidance is not None and not nc:
        sys.exit("error: --guidance needs a class-conditional checkpoint "
                 "(the student distills the guided conditional sampler)")
    model, sched, state, _ = load_run(args.ckpt, exp, args.device)
    teacher = state.ema_params if args.ema else None  # None: the raw params
    if sched.prediction_type == "epsilon" and args.mode == "progressive":
        print("[DISTILL] note: epsilon-prediction teacher — distillation "
              "works but v-prediction teachers distill better at few steps "
              "(Salimans & Ho 2022 §4; train with prediction_type: 'v')")

    loader, _ = _make_loader(args, exp, args.device)
    cfg = TrainConfig(base_lr=args.lr, warmup_steps=0, ema_decay=args.ema_decay,
                      grad_clip=exp.train.grad_clip,
                      flat_optimizer=exp.train.flat_optimizer)
    if args.mode == "consistency":
        params, info = consistency_distill(
            model, sched, teacher, make_batches=lambda: loader,
            num_ladder_steps=args.ladder_steps, updates=args.phase_updates, cfg=cfg,
            guidance=args.guidance, distance=args.distance, seed=exp.seed)
    else:
        params, info = progressive_distill(
            model, sched, teacher, make_batches=lambda: loader,
            start_steps=args.start_steps, end_steps=args.to_steps,
            phase_updates=args.phase_updates, cfg=cfg, guidance=args.guidance,
            weighting=args.weighting, seed=exp.seed)

    # the student as a fresh state: params and EMA both the student's
    model.load_state_dict(params, strict=True)
    out_state, _ = init_train_state(model, cfg, seed=exp.seed)
    extra = {"distilled_steps": info["steps"], "distill_mode": args.mode,
             "distill_guidance": args.guidance, "distill_phases": info["phases"]}
    if args.mode == "consistency":
        # sample-cm and the service reproduce the distilled f exactly
        extra.update(cm_sigma_data=info["sigma_data"],
                     cm_timestep_scaling=info["timestep_scaling"])
    path = save_checkpoint(args.out, out_state, extra=extra,
                           configs={"experiment": exp.to_dict()})
    print(json.dumps({"out": path, "mode": args.mode, "steps": info["steps"],
                      "phases": info["phases"]}))
    if args.mode == "consistency":
        print(f"[DISTILL] consistency student -> {path}; sample with: "
              f"sample-cm --ckpt {args.out} --steps 1"
              + (" --class-id all" if nc else ""))
    else:
        print(f"[DISTILL] student -> {path}; sample with: sample-ddim "
              f"--ckpt {args.out} --schedule linear --steps {info['steps']}"
              + (" --class-id all" if nc else ""))


def cmd_sample_cm(args):
    """Sample a consistency student (``training/consistency.py``): one
    forward per image at ``--steps 1``, the stochastic multistep refinement
    at ``--steps N``.  Guidance is baked in at distillation time, so
    ``--guidance`` is refused here."""
    from .training import consistency_sample_loop
    from .training.consistency import SIGMA_DATA, TIMESTEP_SCALING
    from .utils.images import save_image_grid

    if getattr(args, "vae", None):
        sys.exit("sample-cm: latent consistency checkpoints are not "
                 "supported; distill in pixel space")
    if getattr(args, "guidance", 1.0) != 1.0:
        sys.exit("sample-cm: guidance is baked into the student at distill "
                 "time (distill --mode consistency --guidance W); "
                 "sample with --class-id only")
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)
    model, sched, state, meta = load_run(args.ckpt, exp, args.device)
    extra = (meta or {}).get("extra", {}) or {}
    mode = extra.get("distill_mode")
    if mode != "consistency":
        # a base or progressive student has no consistency parameterization:
        # f would run and emit garbage
        sys.exit(f"sample-cm: checkpoint {args.ckpt} is not a consistency "
                 f"student (meta distill_mode={mode!r}); produce one with "
                 "distill --mode consistency, or sample this checkpoint "
                 "with sample-ddpm/sample-ddim/sample-dpmpp")
    nc = int(getattr(exp.model, "num_classes", 0))
    y = None
    if nc:
        if cls is None:
            # the consistency loss supervises only real labels: the NULL
            # class's pathway is untrained
            print("[SAMPLE-CM] warning: conditional consistency student — "
                  "unconditional (no --class-id) output rides the untrained "
                  "NULL class and may be degraded; pass --class-id K or "
                  "'all'")
            cls = nc
        y = np.broadcast_to(np.asarray(cls, np.int64), (args.n,)).copy()
    S = exp.img_size
    x = consistency_sample_loop(
        model, state.ema_params if args.ema else None, sched,
        (args.n, S, S, model.config.in_channels), seed=args.seed, steps=args.steps, y=y,
        sigma_data=float(extra.get("cm_sigma_data", SIGMA_DATA)),
        timestep_scaling=float(extra.get("cm_timestep_scaling", TIMESTEP_SCALING)),
        device=args.device)
    save_image_grid(((x + 1.0) * 0.5).float().cpu().numpy(), args.out,
                    nrow=int(args.n ** 0.5))
    print(f"[SAMPLE-CM] grid -> {args.out} (steps={args.steps}, NFE="
          f"{args.steps}){_cfg_msg(args)}")


def cmd_img2img(args):
    from .sampling import img2img_infer_sample
    from .utils.images import load_image

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)
    model, sched, state, _ = load_run(args.ckpt, exp, args.device)
    init01 = load_image(args.init, size=exp.img_size)
    img2img_infer_sample(model, None, sched, init01 * 2.0 - 1.0, n=args.n,
                         strength=args.strength, steps=args.steps, eta=args.eta,
                         seed=args.seed, out_path=args.out,
                         ema_params=state.ema_params if args.ema else None,
                         class_id=cls, guidance=args.guidance,
                         device=args.device)
    print(f"[IMG2IMG] grid -> {args.out} (strength={args.strength}, "
          f"steps={args.steps}){_cfg_msg(args)}")


def cmd_inpaint(args):
    from .sampling import box_mask, inpaint_infer_sample
    from .utils.images import load_image

    # argument mistakes fail before the checkpoint loads
    if (args.mask is None) == (args.box is None):
        sys.exit("inpaint: pass exactly one of --mask PNG or --box x0,y0,x1,y1")
    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    cls = _class_vec(args, exp)
    model, sched, state, _ = load_run(args.ckpt, exp, args.device)
    init01 = load_image(args.init, size=exp.img_size)
    if args.mask is not None:
        # white (1) = keep, black (0) = generate
        m = load_image(args.mask, size=exp.img_size, grayscale=True)
        mask = (m >= 0.5).astype("float32")
    else:
        mask = box_mask(exp.img_size, [int(v) for v in args.box.split(",")])
    inpaint_infer_sample(model, None, sched, init01 * 2.0 - 1.0, mask, n=args.n,
                         steps=args.steps, eta=args.eta, resamples=args.resamples,
                         seed=args.seed, out_path=args.out,
                         ema_params=state.ema_params if args.ema else None,
                         class_id=cls, guidance=args.guidance,
                         device=args.device)
    frac = float(1.0 - mask.mean())
    print(f"[INPAINT] grid -> {args.out} (steps={args.steps}, "
          f"resamples={args.resamples}, generated={frac:.0%} of pixels)"
          f"{_cfg_msg(args)}")


def cmd_upsample(args):
    from .sampling import upsample_infer_sample
    from .utils.images import load_image

    exp = _exp_from_args(args)
    if not int(getattr(exp.model, "cond_channels", 0) or 0):
        sys.exit("error: upsample needs an image-conditional (SR) checkpoint"
                 " — train one with TrainConfig.superres_factor"
                 " (e.g. --preset sr64to256)")
    cls = _class_vec(args, exp)
    model, sched, state, _ = load_run(args.ckpt, exp, args.device)
    low01 = load_image(args.init, size=args.low_size)
    upsample_infer_sample(model, None, sched, low01 * 2.0 - 1.0, n=args.n,
                          steps=args.steps, eta=args.eta, seed=args.seed, out_path=args.out,
                          ema_params=state.ema_params if args.ema else None,
                          class_id=cls, guidance=args.guidance, device=args.device)
    print(f"[UPSAMPLE] grid -> {args.out} ({low01.shape[0]}px -> "
          f"{exp.model.img_resolution}px, steps={args.steps}){_cfg_msg(args)}")


def cmd_cascade(args):
    from .sampling import cascade_infer_sample

    base_exp = _exp_from_args(argparse.Namespace(config=args.base_config, preset=args.preset,
                                                 ckpt=args.base_ckpt))
    sr_exp = _exp_from_args(args)
    if not int(getattr(sr_exp.model, "cond_channels", 0) or 0):
        sys.exit("error: --ckpt must be an image-conditional (SR) checkpoint"
                 " (cond_channels > 0); the base model goes in --base-ckpt")
    cls = _class_vec(args, base_exp)
    base_model, base_sched, base_state, _ = load_run(args.base_ckpt, base_exp, args.device)
    sr_model, sr_sched, sr_state, _ = load_run(args.ckpt, sr_exp, args.device)
    cascade_infer_sample(
        base_model, base_state.ema_params if args.ema else None, base_sched,
        sr_model, sr_state.ema_params if args.ema else None, sr_sched,
        n=args.n, base_steps=args.base_steps, sr_steps=args.steps, eta=args.eta,
        seed=args.seed, out_path=args.out, out_low_path=args.out_low, class_id=cls,
        guidance=args.guidance, device=args.device)
    print(f"[CASCADE] {base_exp.model.img_resolution}px x{args.n}"
          f" (base {args.base_steps} steps) -> "
          f"{sr_exp.model.img_resolution}px grid -> {args.out}"
          f" (sr {args.steps} steps){_cfg_msg(args)}")


def cmd_strip(args):
    from .sampling import render_denoise_strip, render_denoise_strip_ddim

    exp = _exp_from_args(args)
    model, sched, state, _ = load_run(args.ckpt, exp, args.device)
    p = state.ema_params if args.ema else None
    if args.sampler == "ddim":
        render_denoise_strip_ddim(model, p, sched, img_size=exp.img_size, out_path=args.out,
                                  seed=args.seed, steps=args.steps, eta=args.eta,
                                  device=args.device)
    else:
        render_denoise_strip(model, p, sched, img_size=exp.img_size, out_path=args.out,
                             seed=args.seed, device=args.device)
    print(f"[DENOISE] strip -> {args.out}")


def _as_eval_array(batch) -> np.ndarray:
    x = batch[0] if isinstance(batch, (tuple, list)) else batch
    return x.float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def cmd_eval(args):
    """Eval-mode L_simple on a held-out set for the raw and the EMA weights
    (the same draws), the rFID of an EMA DDPM grid against it and, with
    ``--nll``/``--nll-full``, the variational bound in bits/dim.  A
    conditional checkpoint is scored on the labelled sources with their
    labels."""
    from .data import ArrayDataset, BlobFacesDataset, DataLoader, get_celeba_loaders
    from .sampling import ddpm_sample
    from .training import evaluate_loss, make_eval_step
    from .utils.fid import fid, rfid

    exp = _exp_from_args(args)
    nc = int(getattr(exp.model, "num_classes", 0))
    if (args.nll or args.nll_full) and int(getattr(exp.model, "cond_channels", 0) or 0):
        sys.exit("error: --nll needs a plain denoiser; SR upsampler "
                 "checkpoints model p(x_hi | x_lo), not p(x)")
    if args.data == "celeba" and nc:
        sys.exit("error: --data celeba has no labels; evaluate "
                 "conditional checkpoints with --data blobs/synthetic")
    model, sched, state, meta = load_run(args.ckpt, exp, args.device)
    n_eval = max(args.eval_size // exp.batch_size, 1) * exp.batch_size
    if args.data == "celeba":
        _tr, eval_loader, _te = get_celeba_loaders(
            data_dir=args.data_dir, img_size=exp.img_size, batch_size=exp.batch_size,
            seed=exp.seed)
    elif args.data == "blobs":
        eval_loader = DataLoader(BlobFacesDataset(n_eval, img_size=exp.img_size,
                                                  seed=exp.seed + 777, num_classes=nc),
                                 exp.batch_size, shuffle=False)
    else:  # synthetic
        eval_loader = DataLoader(ArrayDataset(_synthetic_array(exp, n_eval, exp.seed + 777),
                                              _smoke_labels(n_eval, nc)),
                                 exp.batch_size, shuffle=False)

    eval_fn = make_eval_step(model, sched)
    out = {"ckpt": args.ckpt, "global_step": meta.get("global_step"),
           "val_loss": evaluate_loss(eval_fn, None, eval_loader, labeled=bool(nc)),
           "val_loss_ema": evaluate_loss(eval_fn, state.ema_params, eval_loader,
                                         labeled=bool(nc))}
    if args.rfid_n:
        samples = ddpm_sample(model, state.ema_params, sched, args.rfid_n, exp.img_size,
                              seed=args.seed, return_grid=False, device=args.device)
        # stop once 256 reference images are in hand
        chunks, have = [], 0
        for b in eval_loader:
            chunks.append(_as_eval_array(b))
            have += chunks[-1].shape[0]
            if have >= 256:
                break
        ref = np.concatenate(chunks)[:256]
        out["rfid_ema"] = rfid((ref + 1.0) / 2.0, samples, device=args.device)
        if getattr(args, "fid_extractor", None):
            out["fid_ema"] = fid((ref + 1.0) / 2.0, samples,
                                 extractor_path=args.fid_extractor, device=args.device)
    if args.nll or args.nll_full:
        out.update(_eval_nll(args, exp, model, sched, state, eval_loader, nc))
    print(json.dumps(out))


def _eval_nll(args, exp, model, sched, state, eval_loader, nc):
    """Variational-bound bits/dim on the EMA weights (``ops/likelihood.py``)
    over the first ``--nll-n`` held-out images; a labelled loader scores the
    conditional bound (its labels through ``cfg_eps_fn`` at guidance 1).
    The draws come from a generator seeded with ``--seed``."""
    from .ops.likelihood import vlb_bits_per_dim, vlb_bits_per_dim_mc
    from .sampling.inference import _sampling, cfg_eps_fn
    from .utils.device import resolve_device

    want = args.nll_n or exp.batch_size
    xs, ys = [], []
    for b in eval_loader:
        xs.append(_as_eval_array(b))
        if isinstance(b, (tuple, list)):
            ys.append(np.asarray(b[1]))
        if sum(x.shape[0] for x in xs) >= want:
            break
    dev = resolve_device(args.device)
    x0 = torch.from_numpy(np.concatenate(xs)[:want]).to(dev)
    y = np.concatenate(ys)[:x0.shape[0]] if (nc and ys) else None
    eps_fn = cfg_eps_fn(model, sched, params=state.ema_params, y=y)
    gen = torch.Generator(device=dev).manual_seed(int(args.seed))
    with _sampling(model):
        if args.nll_full:
            bpd = vlb_bits_per_dim(sched, eps_fn, x0, gen)
        else:
            bpd = vlb_bits_per_dim_mc(sched, eps_fn, x0, gen, num_t=int(args.nll))
    key = "nll_bpd_full" if args.nll_full else f"nll_bpd_mc{int(args.nll)}"
    return {key: float(bpd.mean()), "nll_n": int(x0.shape[0]),
            "nll_conditional": bool(y is not None)}


def cmd_info(args):
    print(_exp_from_args(args).to_json())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ddpm-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, ckpt_required=False, device=True):
        sp.add_argument("--preset", default="celeba64_low")
        sp.add_argument("--config", help="path to ExperimentConfig JSON")
        if device:
            sp.add_argument("--device", default="cuda",
                            help="where to run (default cuda; cpu runs the plain "
                                 "PyTorch path)")
        if ckpt_required:
            sp.add_argument("--ckpt", required=True)
            sp.add_argument("--ema", action="store_true")
            sp.add_argument("--seed", type=int, default=1234)

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--data", default="synthetic",
                    choices=["synthetic", "blobs", "zip", "hf", "celeba"])
    sp.add_argument("--zip-path")
    sp.add_argument("--no-crop", action="store_true",
                    help="zip data: skip the 178 CelebA face crop (pre-cropped "
                         "square corpora)")
    sp.add_argument("--data-dir", default="data")
    sp.add_argument("--synthetic-size", type=int, default=512)
    sp.add_argument("--preload", action="store_true",
                    help="blobs: render the whole corpus to RAM up front")
    sp.add_argument("--device-cache", action="store_true",
                    help="keep the training corpus on the card as uint8 and gather "
                         "batches there; zip/celeba decode the corpus once up front; "
                         "implies --preload for blobs")
    sp.add_argument("--device-cache-sharded", action="store_true", help="not ported yet")
    sp.add_argument("--epochs", type=int)
    sp.add_argument("--max-batches", type=int)
    sp.add_argument("--ckpt-dir", default="checkpoints")
    sp.add_argument("--resume")
    sp.add_argument("--log-every", type=int)
    sp.add_argument("--probes", action="store_true")
    sp.add_argument("--no-samples", action="store_true")
    sp.add_argument("--loss-weighting", choices=["uniform", "snr", "p2", "min_snr_5"])
    sp.add_argument("--mesh", default="none", choices=["none", "dp", "fsdp"],
                    help="not ported yet")
    sp.add_argument("--eval-every", type=int, default=0, metavar="N",
                    help="validation loss (raw+EMA) every N epochs (0=off)")
    sp.add_argument("--eval-max-batches", type=int)
    sp.add_argument("--val-frac", type=float, default=0.0, metavar="F",
                    help="with --data zip: hold out this seeded fraction of the corpus "
                         "as the validation split")
    sp.add_argument("--fid-extractor", metavar="WEIGHTS",
                    help="mounted feature-extractor file (TorchScript module or "
                         "inception_v3 state_dict): FID next to rFID")
    sp.add_argument("--reset-optimizer", action="store_true",
                    help="on resume: fresh optimizer state (warmup clock kept)")
    sp.add_argument("--override-lr", type=float)
    sp.add_argument("--override-weight-decay", type=float)
    sp.add_argument("--override-ema-decay", type=float)
    sp.add_argument("--repair-ema", nargs="?", const="auto", choices=["auto", "force"],
                    help="on resume: re-seed the EMA shadow from the model, 'auto' "
                         "when the health check fails, 'force' always")
    sp.add_argument("--latent-vae", metavar="VAE_CKPT", help="not ported yet")
    sp.set_defaults(fn=cmd_train)

    def cfg_args(sp):
        sp.add_argument("--class-id", default=None, metavar="K|all",
                        help="class to sample (int), or 'all' to cycle every class across "
                             "the grid; needs a conditional checkpoint (model.num_classes "
                             "> 0)")
        sp.add_argument("--guidance", type=float, default=1.0, metavar="W",
                        help="classifier-free guidance scale: 1 = plain conditional, 0 = "
                             "unconditional, >1 amplifies the class (typ. 1.5-5)")
        sp.add_argument("--vae", metavar="VAE_CKPT", help="not ported yet")
        sp.add_argument("--latent-scale", type=float, help="not ported yet")

    sp = sub.add_parser("sample-ddpm")
    common(sp, ckpt_required=True)
    sp.add_argument("--n", type=int, default=36)
    sp.add_argument("--out", default="samples_ddpm.png")
    sp.add_argument("--individual", action="store_true")
    sp.add_argument("--sharded", action="store_true", help="not ported yet")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_sample_ddpm)

    sp = sub.add_parser("sample-ddim")
    common(sp, ckpt_required=True)
    sp.add_argument("--n", type=int, default=36)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--schedule", default="t_linear",
                    choices=["t_linear", "linear", "alpha_bar_cosine", "cosine", "karras"])
    sp.add_argument("--out", default="samples_ddim.png")
    sp.add_argument("--individual", action="store_true")
    sp.add_argument("--sharded", action="store_true", help="not ported yet")
    sp.add_argument("--refresh-every", type=int, default=0, metavar="K",
                    help="encoder-cached fast DDIM: recompute encoder features every "
                         "K steps, decoder-only between (0/1 = full model every step)")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_sample_ddim)

    sp = sub.add_parser("sample-dpmpp",
                        help="DPM-Solver++(2M) grid: DDIM-50 quality in ~20 steps")
    common(sp, ckpt_required=True)
    sp.add_argument("--n", type=int, default=36)
    sp.add_argument("--steps", type=int, default=20)
    sp.add_argument("--schedule", default="t_linear",
                    choices=["t_linear", "linear", "alpha_bar_cosine", "cosine", "karras"])
    sp.add_argument("--out", default="samples_dpmpp.png")
    sp.add_argument("--individual", action="store_true")
    sp.add_argument("--sharded", action="store_true", help="not ported yet")
    sp.add_argument("--sde", action="store_true",
                    help="stochastic SDE-DPM-Solver++(2M): fresh noise each step")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_sample_dpmpp)

    sp = sub.add_parser(
        "distill",
        help="progressive distillation (halve a checkpoint's DDIM ladder down to "
             "--to-steps) or consistency distillation; optionally bake guidance in")
    common(sp, ckpt_required=True)
    sp.add_argument("--out", required=True,
                    help="output checkpoint directory for the student")
    sp.add_argument("--data", default="blobs",
                    choices=["synthetic", "blobs", "zip", "hf", "celeba"])
    sp.add_argument("--zip-path")
    sp.add_argument("--no-crop", action="store_true")
    sp.add_argument("--data-dir", default="data")
    sp.add_argument("--synthetic-size", type=int, default=512)
    sp.add_argument("--preload", action="store_true")
    sp.add_argument("--device-cache", action="store_true")
    sp.add_argument("--val-frac", type=float, default=0.0, metavar="F",
                    help="with --data zip: exclude the seeded held-out fraction the "
                         "train run held out")
    sp.add_argument("--start-steps", type=int, default=64,
                    help="the teacher's DDIM step count (the first student learns "
                         "start-steps/2)")
    sp.add_argument("--to-steps", type=int, default=4,
                    help="stop when the student reaches this many steps")
    sp.add_argument("--phase-updates", type=int, default=400,
                    help="optimizer updates per halving phase")
    sp.add_argument("--lr", type=float, default=1e-4,
                    help="distillation LR (no warmup; lower than training)")
    sp.add_argument("--ema-decay", type=float, default=0.999,
                    help="student EMA (the EMA student seeds the next phase)")
    sp.add_argument("--guidance", type=float, default=None, metavar="W",
                    help="bake guidance at this scale into the student (conditional "
                         "checkpoints; the student then samples guided at guidance=1 "
                         "cost)")
    sp.add_argument("--weighting", default="truncated_snr",
                    choices=["truncated_snr", "snr", "uniform"])
    sp.add_argument("--mode", default="progressive", choices=["progressive", "consistency"],
                    help="progressive = ladder halving; consistency = one-phase "
                         "consistency distillation, sampled at any NFE by sample-cm")
    sp.add_argument("--ladder-steps", type=int, default=32,
                    help="[consistency] teacher ladder segments N (the pairing grid, "
                         "not the student's sampling steps)")
    sp.add_argument("--distance", default="pseudo_huber", choices=["pseudo_huber", "l2"],
                    help="[consistency] the distance (pseudo-Huber or L2)")
    sp.set_defaults(fn=cmd_distill)

    sp = sub.add_parser("sample-cm",
                        help="sample a consistency student at 1..N forwards per image")
    common(sp, ckpt_required=True)
    sp.add_argument("--n", type=int, default=16)
    sp.add_argument("--steps", type=int, default=2,
                    help="network forwards per sample (1 = single-step)")
    sp.add_argument("--out", default="samples_cm.png")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_sample_cm)

    sp = sub.add_parser("img2img",
                        help="SDEdit: noise a real image to strength*T and denoise it back")
    common(sp, ckpt_required=True)
    sp.add_argument("--init", required=True,
                    help="input image (center-cropped + resized to the model resolution)")
    sp.add_argument("--n", type=int, default=9,
                    help="variations to draw (grid rows get independent noise)")
    sp.add_argument("--strength", type=float, default=0.6,
                    help="(0,1]: fraction of the ladder to run; small = faithful edit, "
                         "1.0 = near-from-scratch")
    sp.add_argument("--steps", type=int, default=50,
                    help="FULL-ladder step count before truncation")
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--out", default="samples_img2img.png")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_img2img)

    sp = sub.add_parser("inpaint",
                        help="regenerate a masked region of a real image (RePaint-style "
                             "replace + optional resampling; mask=white kept exactly)")
    common(sp, ckpt_required=True)
    sp.add_argument("--init", required=True, help="input image")
    sp.add_argument("--mask", help="grayscale PNG: white = keep, black = generate")
    sp.add_argument("--box", metavar="x0,y0,x1,y1",
                    help="generate inside this pixel box instead of a mask file")
    sp.add_argument("--n", type=int, default=9)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--resamples", type=int, default=1,
                    help="RePaint harmonization repeats per step (1 = plain replace "
                         "method)")
    sp.add_argument("--out", default="samples_inpaint.png")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_inpaint)

    sp = sub.add_parser(
        "upsample",
        help="super-resolve a low-res image with an SR upsampler checkpoint "
             "(SR3/cascaded diffusion, sampling/superres.py)")
    common(sp, ckpt_required=True)
    sp.add_argument("--init", required=True,
                    help="low-resolution input image (kept at its native size unless "
                         "--low-size crops/resizes it first)")
    sp.add_argument("--low-size", type=int, default=None,
                    help="center-crop + resize the input to this size before "
                         "conditioning (e.g. 64)")
    sp.add_argument("--n", type=int, default=4,
                    help="variations to draw (independent noise per row)")
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--out", default="samples_upsampled.png")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_upsample)

    sp = sub.add_parser(
        "cascade",
        help="two-stage generation: sample a base checkpoint, then super-resolve "
             "every sample with an SR upsampler checkpoint")
    common(sp, ckpt_required=True)
    sp.add_argument("--base-ckpt", required=True,
                    help="the low-resolution base model checkpoint (--ckpt is the SR "
                         "upsampler)")
    sp.add_argument("--base-config",
                    help="ExperimentConfig JSON for the base model (default: the base "
                         "checkpoint's meta sidecar)")
    sp.add_argument("--n", type=int, default=4)
    sp.add_argument("--base-steps", type=int, default=50,
                    help="DDIM steps for the base stage")
    sp.add_argument("--steps", type=int, default=50, help="DDIM steps for the SR stage")
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--out", default="samples_cascade.png")
    sp.add_argument("--out-low", default=None, help="also save the base-stage grid here")
    cfg_args(sp)
    sp.set_defaults(fn=cmd_cascade)

    sp = sub.add_parser("strip")
    common(sp, ckpt_required=True)
    sp.add_argument("--sampler", default="ddim", choices=["ddpm", "ddim"])
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--out", default="denoise_strip.png")
    sp.set_defaults(fn=cmd_strip)

    sp = sub.add_parser("eval")
    common(sp, ckpt_required=True)
    sp.add_argument("--data", default="blobs", choices=["synthetic", "blobs", "celeba"])
    sp.add_argument("--data-dir", default="data")
    sp.add_argument("--eval-size", type=int, default=512,
                    help="held-out set size for the procedural sources")
    sp.add_argument("--rfid-n", type=int, default=36, metavar="N",
                    help="EMA sample count for rFID (0 = skip sampling)")
    sp.add_argument("--fid-extractor", metavar="WEIGHTS",
                    help="mounted feature-extractor file: FID next to rFID")
    sp.add_argument("--nll", type=int, default=0, metavar="NUM_T",
                    help="variational-bound bits/dim on EMA params from NUM_T Monte-Carlo "
                         "timestep draws per image (ops/likelihood.py); 0 = skip")
    sp.add_argument("--nll-full", action="store_true",
                    help="exact bound: all T terms per image (one model eval per t, the "
                         "cost of a full ancestral pass)")
    sp.add_argument("--nll-n", type=int, default=0, metavar="N",
                    help="images to score (0 = one eval batch)")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("info")
    common(sp, device=False)
    sp.add_argument("--ckpt")
    sp.set_defaults(fn=cmd_info)
    return p


def main(argv: Optional[list] = None):
    # epoch tables reach a redirected log as they happen
    try:
        sys.stdout.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):
        pass
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) is not None:
        from .utils.device import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise here
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
