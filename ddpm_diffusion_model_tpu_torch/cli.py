"""Command line of the port: train, sample, strip, evaluate, inspect.

Counterpart of ``ddpm_diffusion_model_tpu/cli.py`` for the commands whose
modules are ported:

    python -m ddpm_diffusion_model_tpu_torch.cli train --preset celeba64_attn --data zip --zip-path faces.zip
    python -m ddpm_diffusion_model_tpu_torch.cli sample-ddpm --ckpt checkpoints/celeba64_attn_last --n 36
    python -m ddpm_diffusion_model_tpu_torch.cli sample-ddim --ckpt checkpoints/celeba64_attn_last --steps 50
    python -m ddpm_diffusion_model_tpu_torch.cli sample-dpmpp --ckpt checkpoints/celeba64_attn_last --steps 20
    python -m ddpm_diffusion_model_tpu_torch.cli img2img --ckpt checkpoints/celeba64_attn_last --init face.png
    python -m ddpm_diffusion_model_tpu_torch.cli inpaint --ckpt checkpoints/celeba64_attn_last --init face.png --box 16,16,48,48
    python -m ddpm_diffusion_model_tpu_torch.cli strip --ckpt checkpoints/celeba64_attn_last --sampler ddim
    python -m ddpm_diffusion_model_tpu_torch.cli eval --ckpt checkpoints/celeba64_attn_last --data blobs
    python -m ddpm_diffusion_model_tpu_torch.cli info --preset celebahq256

The commands and flags are the JAX CLI's, plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path, and without a card nothing
runs unless it is asked for).  Checkpoints are the port's directories
(``training/checkpoint.py``), not Orbax.  Flags whose modules are not
ported (meshes, the sharded cache, latent diffusion, class conditioning,
the likelihood, ``--data hf``) exit with "... is not ported yet"; the JAX
CLI's other commands come with their modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

_NOT_PORTED = "is not ported yet"


def _not_ported(what: str):
    sys.exit(f"error: {what} {_NOT_PORTED}")


def _build(exp, device):
    from .models import UNetDenoiser
    from .ops import make_schedule

    torch.manual_seed(exp.seed)  # the seeded init of a fresh run
    model = UNetDenoiser(exp.model, dtype=torch.bfloat16, device=device,
                         remat=exp.remat).to(memory_format=torch.channels_last)
    return model, make_schedule(exp.diffusion, device=device)


def _load_state(ckpt, exp, device):
    """The model, schedule, train state and meta of a port checkpoint."""
    from .training import init_train_state, load_checkpoint

    model, sched = _build(exp, device)
    template, _ = init_train_state(model, exp.train)
    state, meta = load_checkpoint(ckpt, template)
    return model, sched, state, meta


def _exp_from_args(args):
    from .utils.config import ExperimentConfig, get_preset

    if getattr(args, "config", None):
        with open(args.config) as f:
            return ExperimentConfig.from_json(f.read())
    exp = get_preset(args.preset)
    if getattr(args, "ckpt", None):
        from .training.checkpoint import read_meta

        meta = read_meta(args.ckpt) or {}
        if meta.get("configs", {}).get("experiment"):
            return ExperimentConfig.from_dict(meta["configs"]["experiment"], legacy=True)
    return exp


def _synthetic_array(exp, n, seed):
    rng = np.random.default_rng(seed)
    arr = rng.normal(size=(n, exp.img_size, exp.img_size, 3)).astype(np.float32)
    return np.clip(arr * 0.4, -1, 1)


def _eval_set_size(args, exp):
    """Held-out set size for the procedural sources: ~1/8 of the train set
    in whole batches, at least one."""
    return max(args.synthetic_size // 8 // exp.batch_size, 1) * exp.batch_size


def _make_loader(args, exp, device, with_eval=False):
    """``(train, eval_or_None)`` for ``--data``: the official valid split
    for celeba, held-out sets of another seed for the procedural sources,
    a seeded ``--val-frac`` of a zip, else None."""
    from .data import (ArrayDataset, BlobFacesDataset, DataLoader, DeviceCacheLoader,
                       blob_faces_array, get_celeba_loader_from_zip, get_celeba_loaders,
                       materialize_corpus)

    device_cache = bool(getattr(args, "device_cache", False))
    cache_kw = dict(quantize=True, progress=True, device=device)

    def from_array(arr, seed):
        if device_cache:
            return DeviceCacheLoader(arr, exp.batch_size, seed=seed, **cache_kw)
        return DataLoader(ArrayDataset(np.asarray(arr)), exp.batch_size, seed=seed,
                          shuffle=True)

    def maybe_cached(loader):
        """Decode-per-item sources: decode the corpus once and keep it on
        the card as uint8."""
        if not device_cache or loader is None:
            return loader
        return DeviceCacheLoader(materialize_corpus(loader, progress=True), exp.batch_size,
                                 seed=exp.seed, **cache_kw)

    if args.data == "synthetic":
        train = from_array(_synthetic_array(exp, args.synthetic_size, exp.seed), exp.seed)
        val = (DataLoader(ArrayDataset(_synthetic_array(exp, _eval_set_size(args, exp),
                                                        exp.seed + 777)),
                          exp.batch_size, shuffle=False) if with_eval else None)
        return train, val
    if args.data == "blobs":
        if getattr(args, "preload", False) or device_cache:
            # render the corpus once: per-item rendering cannot feed the card
            train = from_array(blob_faces_array(args.synthetic_size, img_size=exp.img_size,
                                                seed=exp.seed), exp.seed)
        else:
            train = DataLoader(BlobFacesDataset(args.synthetic_size, img_size=exp.img_size,
                                                seed=exp.seed),
                               exp.batch_size, seed=exp.seed, shuffle=True)
        val = None
        if with_eval:
            n_eval = _eval_set_size(args, exp)
            if device_cache:
                val = DeviceCacheLoader(blob_faces_array(n_eval, img_size=exp.img_size,
                                                         seed=exp.seed + 777),
                                        exp.batch_size, shuffle=False, quantize=True,
                                        device=device)
            else:
                val = DataLoader(BlobFacesDataset(n_eval, img_size=exp.img_size,
                                                  seed=exp.seed + 777),
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
    from .sampling import ddpm_sample
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
    model, sched = _build(exp, device)
    loader, eval_loader = _make_loader(args, exp, device,
                                       with_eval=bool(getattr(args, "eval_every", 0)))

    def sample_fn(model_, params_, sched_, *, n, img_size, save_path, seed):
        # the (n, H, W, C) [0, 1] samples, so the loop can score rFID
        return ddpm_sample(model_, params_, sched_, n, img_size, seed=seed,
                           save_path=save_path, return_grid=False, device=device)

    fid_ref = None
    if args.data == "blobs" and not args.no_samples:
        # a held-out reference of another seed for the per-epoch rFID
        from .data import blob_faces_array

        fid_ref = blob_faces_array(128, img_size=exp.img_size, seed=exp.seed + 999)

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
    if getattr(args, "class_id", None) is not None:
        _not_ported("--class-id (class-conditional sampling)")
    if getattr(args, "guidance", 1.0) != 1.0:
        _not_ported("--guidance (classifier-free guidance)")


def cmd_sample_ddpm(args):
    from .sampling import ddpm_infer_sample

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    model, sched, state, _meta = _load_state(args.ckpt, exp, args.device)
    ddpm_infer_sample(model, None, sched, n=args.n, img_size=exp.img_size,
                      ema_params=state.ema_params if args.ema else None,
                      out_path=args.out, seed=args.seed,
                      save_individual=args.individual, device=args.device)
    print(f"[INFER] grid -> {args.out}")


def cmd_sample_ddim(args):
    from .sampling import ddim_infer_sample, ddim_sample_fast

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    model, sched, state, _meta = _load_state(args.ckpt, exp, args.device)
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
                      device=args.device)
    print(f"[INFER-DDIM] grid -> {args.out} (steps={args.steps}, eta={args.eta})")


def cmd_sample_dpmpp(args):
    from .sampling import dpmpp_infer_sample

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    model, sched, state, _meta = _load_state(args.ckpt, exp, args.device)
    dpmpp_infer_sample(model, None, sched, n=args.n, img_size=exp.img_size,
                       ema_params=state.ema_params if args.ema else None,
                       out_path=args.out, seed=args.seed, steps=args.steps,
                       schedule_kind=args.schedule, save_individual=args.individual,
                       sde=args.sde, device=args.device)
    variant = "SDE" if args.sde else ""
    print(f"[INFER-DPM++{variant}] grid -> {args.out} (steps={args.steps})")


def cmd_img2img(args):
    from .sampling import img2img_infer_sample
    from .utils.images import load_image

    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    model, sched, state, _ = _load_state(args.ckpt, exp, args.device)
    init01 = load_image(args.init, size=exp.img_size)
    img2img_infer_sample(model, None, sched, init01 * 2.0 - 1.0, n=args.n,
                         strength=args.strength, steps=args.steps, eta=args.eta,
                         seed=args.seed, out_path=args.out,
                         ema_params=state.ema_params if args.ema else None,
                         device=args.device)
    print(f"[IMG2IMG] grid -> {args.out} (strength={args.strength}, "
          f"steps={args.steps})")


def cmd_inpaint(args):
    from .sampling import box_mask, inpaint_infer_sample
    from .utils.images import load_image

    # argument mistakes fail before the checkpoint loads
    if (args.mask is None) == (args.box is None):
        sys.exit("inpaint: pass exactly one of --mask PNG or --box x0,y0,x1,y1")
    _check_sampling_flags(args)
    exp = _exp_from_args(args)
    model, sched, state, _ = _load_state(args.ckpt, exp, args.device)
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
                         device=args.device)
    frac = float(1.0 - mask.mean())
    print(f"[INPAINT] grid -> {args.out} (steps={args.steps}, "
          f"resamples={args.resamples}, generated={frac:.0%} of pixels)")


def cmd_strip(args):
    from .sampling import render_denoise_strip, render_denoise_strip_ddim

    exp = _exp_from_args(args)
    model, sched, state, _ = _load_state(args.ckpt, exp, args.device)
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
    (the same draws), and the rFID of an EMA DDPM grid against it."""
    from .data import ArrayDataset, BlobFacesDataset, DataLoader, get_celeba_loaders
    from .sampling import ddpm_sample
    from .training import evaluate_loss, make_eval_step
    from .utils.fid import fid, rfid

    if args.nll or args.nll_full:
        _not_ported("--nll/--nll-full (the variational bound)")
    exp = _exp_from_args(args)
    model, sched, state, meta = _load_state(args.ckpt, exp, args.device)
    n_eval = max(args.eval_size // exp.batch_size, 1) * exp.batch_size
    if args.data == "celeba":
        _tr, eval_loader, _te = get_celeba_loaders(
            data_dir=args.data_dir, img_size=exp.img_size, batch_size=exp.batch_size,
            seed=exp.seed)
    elif args.data == "blobs":
        eval_loader = DataLoader(BlobFacesDataset(n_eval, img_size=exp.img_size,
                                                  seed=exp.seed + 777),
                                 exp.batch_size, shuffle=False)
    else:  # synthetic
        eval_loader = DataLoader(ArrayDataset(_synthetic_array(exp, n_eval, exp.seed + 777)),
                                 exp.batch_size, shuffle=False)

    eval_fn = make_eval_step(model, sched)
    out = {"ckpt": args.ckpt, "global_step": meta.get("global_step"),
           "val_loss": evaluate_loss(eval_fn, None, eval_loader),
           "val_loss_ema": evaluate_loss(eval_fn, state.ema_params, eval_loader)}
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
    print(json.dumps(out))


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
        sp.add_argument("--class-id", default=None, metavar="K|all", help="not ported yet")
        sp.add_argument("--guidance", type=float, default=1.0, metavar="W",
                        help="not ported yet (1 = unguided)")
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
    sp.add_argument("--nll", type=int, default=0, metavar="NUM_T", help="not ported yet")
    sp.add_argument("--nll-full", action="store_true", help="not ported yet")
    sp.add_argument("--nll-n", type=int, default=0, metavar="N", help="not ported yet")
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
