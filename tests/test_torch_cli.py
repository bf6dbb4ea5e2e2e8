"""The port's command line, ``python -m ddpm_diffusion_model_tpu_torch.cli``,
driven in-process through ``cli.main([..., "--device", "cpu"])`` at a
16-px config: ``train`` on synthetic, blob and zip data (with the device
cache and a held-out fraction), ``--resume auto``, ``sample-ddim`` (also
``--refresh-every``), ``sample-ddpm``, ``sample-dpmpp`` (also ``--sde``),
``img2img``, ``inpaint``, ``strip``, ``eval`` and ``info``.  Held against the JAX
package's modules: ``ExperimentConfig`` and ``info``'s JSON, the
experiment a checkpoint stores, the grids' and strips' shapes, ``eval``'s
keys; a class-conditional run (``--config`` with ``model.num_classes``,
labelled blob faces) and its ``--class-id``/``--guidance`` commands and
``eval --nll``/``--nll-full``; ``--data hf`` exits with "not ported yet"
and the mesh flags with the JAX CLI's refusals.  The JAX CLI's own ``train`` is not run (it
compiles XLA programs)."""

import contextlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_diffusion_model_tpu import cli as jax_cli
from ddpm_diffusion_model_tpu.utils import config as jax_config
from ddpm_diffusion_model_tpu.utils import images as jax_images
from ddpm_diffusion_model_tpu_torch import cli
from ddpm_diffusion_model_tpu_torch.training import read_meta
from ddpm_diffusion_model_tpu_torch.utils import config

torch.set_num_threads(2)

EXP = {"model": {"in_channels": 3, "base_channels": 32, "channel_mults": [1, 2],
                 "num_res_blocks": 1, "attn_resolutions": [8], "time_embed_dim": 64,
                 "dropout": 0.0, "num_heads": 2, "head_dim": 16, "img_resolution": 16},
       "diffusion": {"T": 100, "schedule": "linear", "beta_min": 0.0001, "beta_max": 0.02,
                     "cosine_s": 0.008, "clamp_x0": True, "dynamic_threshold": None,
                     "img_size": 16},
       "train": {"base_lr": 0.001, "warmup_steps": 5, "weight_decay": 0.0, "adam_b1": 0.9,
                 "adam_b2": 0.999, "grad_clip": 1.0, "grad_accum_steps": 2,
                 "ema_decay": 0.999},
       "run_name": "verify16", "img_size": 16, "batch_size": 8, "epochs": 2,
       "sample_every": 1, "sample_n": 4, "save_every": 1, "log_every": 2, "seed": 0,
       "remat": False}
CPU = ["--device", "cpu"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _png_shape(path):
    with Image.open(path) as im:
        return np.asarray(im).shape


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One trained run: synthetic data, 2 epochs of 8 steps, eval and
    probes; returns (tmp dir, config path, ckpt dir, stdout)."""
    d = tmp_path_factory.mktemp("cli")
    cfg = d / "exp.json"
    cfg.write_text(json.dumps(EXP))
    ck = str(d / "ck")
    out = _run(["train", "--config", str(cfg), "--data", "synthetic", "--synthetic-size",
                "64", "--ckpt-dir", ck, "--log-every", "2", "--probes", "--eval-every",
                "1", *CPU])
    return d, str(cfg), ck, out


@pytest.mark.parametrize("name", ["celeba64_low", "celeba64_attn", "celebahq256",
                                  "sr64to256"])
def test_experiment_config_and_info_equal_jax(name):
    ours, theirs = config.get_preset(name), jax_config.get_preset(name)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()
    assert config.ExperimentConfig.from_json(theirs.to_json()) == ours
    legacy = config.ExperimentConfig.from_dict(theirs.to_dict(), legacy=True)
    assert legacy.train == config.TrainConfig.from_dict(theirs.train.to_dict(), legacy=True)
    assert config.preset_from_experiment(theirs.to_dict()) == ours
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        jax_cli.main(["info", "--preset", name])
    assert _run(["info", "--preset", name]) == jax_out.getvalue()


def test_pinned_jax_info_is_the_jax_packages():
    """``tests/jax_info_celeba64_attn.json`` is what the JAX package's
    ``info --preset celeba64_attn`` prints; ``chip_smoke.py`` holds the
    port's ``info`` on the card (which has no JAX) against it."""
    jax_out = io.StringIO()
    with contextlib.redirect_stdout(jax_out):
        jax_cli.main(["info", "--preset", "celeba64_attn"])
    pinned = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "jax_info_celeba64_attn.json")
    with open(pinned) as f:
        assert f.read() == jax_out.getvalue() == _run(["info", "--preset", "celeba64_attn"])


def test_unported_presets_name_their_family():
    # every preset is ported: sr64to256 (tests/test_torch_superres_cli.py), the
    # DiT presets (tests/test_torch_dit.py) and the latent one (tests/test_torch_latent.py)
    exp = config.ExperimentConfig.from_dict(jax_config.get_preset("celeba64_latent").to_dict())
    assert exp == config.get_preset("celeba64_latent") and not exp.diffusion.clamp_x0
    for name in ("celeba64_dit_s4", "celeba64_dit_moe"):
        exp = config.ExperimentConfig.from_dict(jax_config.get_preset(name).to_dict())
        assert exp == config.get_preset(name) and exp.model.to_dict()["family"] == "dit"
    # the port's own presets (a model the JAX package lacks) come on top of JAX's
    assert sorted(set(config.PRESETS) - set(config.PORT_PRESETS)) == sorted(jax_config.PRESETS)
    assert not set(config.PORT_PRESETS) & set(jax_config.PRESETS)
    with pytest.raises(KeyError, match="unknown preset"):
        config.get_preset("nope")


def test_train_leaves_the_run_and_the_jax_experiment(run):
    d, cfg, ck, out = run
    assert "[EVAL]" in out and "[SAMPLE]" in out and "t=10:" in out
    assert _last_json(out).keys() == {"final_loss"}
    assert sorted(os.listdir(ck)) == ["verify16_e000", "verify16_e001", "verify16_last",
                                      "verify16_metrics.jsonl", "verify16_samples_e000.png",
                                      "verify16_samples_e001.png"]
    meta = read_meta(os.path.join(ck, "verify16_last"))
    want = jax_config.ExperimentConfig.from_json(open(cfg).read()).to_json()
    assert meta["configs"]["experiment"] == json.loads(want)
    assert (meta["epoch"], meta["global_step"]) == (1, 16)
    with open(os.path.join(ck, "verify16_metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["epoch"] for r in recs] == [0, 1] and [r["global_step"] for r in recs] == [8, 16]
    assert all({"loss", "imgs_per_s", "val_loss", "val_loss_ema", "lr"} <= r.keys()
               for r in recs)
    grid = jax_images.make_grid(np.zeros((4, 16, 16, 3)), nrow=2)
    assert _png_shape(os.path.join(ck, "verify16_samples_e000.png")) == grid.shape


def test_resume_auto_continues_the_run(run):
    d, cfg, ck, _ = run
    out = _run(["train", "--config", cfg, "--data", "synthetic", "--synthetic-size", "64",
                "--ckpt-dir", ck, "--resume", "auto", "--no-samples", "--epochs", "3",
                "--override-lr", "5e-4", *CPU])
    assert "[RESUME] auto ->" in out and "start_epoch=2" in out and "override_lr" in out
    meta = read_meta(os.path.join(ck, "verify16_last"))
    assert (meta["epoch"], meta["global_step"]) == (2, 24)


def test_sample_strip_and_eval_from_the_checkpoint(run, monkeypatch):
    d, _, ck, _ = run
    monkeypatch.chdir(d)
    last = os.path.join(ck, "verify16_last")
    _run(["sample-ddim", "--ckpt", last, "--ema", "--n", "4", "--steps", "8", "--out",
          "g.png", *CPU])
    assert _png_shape(d / "g.png") == jax_images.make_grid(np.zeros((4, 16, 16, 3)),
                                                            nrow=2).shape
    _run(["sample-ddpm", "--ckpt", last, "--n", "3", "--out", "d.png", "--individual", *CPU])
    assert _png_shape(d / "d.png") == jax_images.make_grid(np.zeros((3, 16, 16, 3)),
                                                            nrow=2).shape
    assert sorted(os.listdir(d / "samples_individual")) == [f"img_{i:03d}.png"
                                                            for i in range(3)]
    _run(["strip", "--ckpt", last, "--sampler", "ddpm", "--out", "s.png", *CPU])
    assert _png_shape(d / "s.png") == jax_images.make_grid(
        np.zeros((20, 16, 16, 3)), nrow=20, padding=2).shape
    _run(["strip", "--ckpt", last, "--sampler", "ddim", "--steps", "10", "--out", "s2.png",
          *CPU])
    assert _png_shape(d / "s2.png") == jax_images.make_grid(
        np.zeros((10, 16, 16, 3)), nrow=10, padding=2).shape
    res = _last_json(_run(["eval", "--ckpt", last, "--data", "blobs", "--eval-size", "16",
                           "--rfid-n", "8", *CPU]))
    assert res.keys() == {"ckpt", "global_step", "val_loss", "val_loss_ema", "rfid_ema"}
    assert all(np.isfinite(res[k]) for k in ("val_loss", "val_loss_ema", "rfid_ema"))


def test_fast_samplers_and_editing_from_the_checkpoint(run, monkeypatch):
    """``sample-dpmpp`` (ODE and ``--sde``), ``sample-ddim --refresh-every
    2``, ``img2img`` and ``inpaint`` (``--box`` and ``--mask``) from the
    run's checkpoint: exit 0 and the grid PNG ``make_grid`` gives."""
    d, _, ck, _ = run
    monkeypatch.chdir(d)
    last = os.path.join(ck, "verify16_last")
    grid = lambda n, nrow: jax_images.make_grid(np.zeros((n, 16, 16, 3)),  # noqa: E731
                                                nrow=nrow).shape
    face = (np.random.default_rng(0).uniform(size=(40, 30, 3)) * 255).astype(np.uint8)
    Image.fromarray(face).save(d / "face.png")
    mask = np.full((16, 16), 255, np.uint8)
    mask[:, :6] = 0
    Image.fromarray(mask).save(d / "mask.png")
    for argv, out, shape, say in [
        (["sample-dpmpp", "--n", "4", "--steps", "6", "--out", "p.png"], "p.png",
         grid(4, 2), "[INFER-DPM++] grid -> p.png (steps=6)"),
        (["sample-dpmpp", "--n", "3", "--steps", "6", "--sde", "--individual", "--out",
          "ps.png"], "ps.png", grid(3, 2), "[INFER-DPM++SDE] grid -> ps.png"),
        (["sample-ddim", "--n", "4", "--steps", "8", "--refresh-every", "2", "--out",
          "f.png"], "f.png", grid(4, 2), "encoder-cached 1/2"),
        (["img2img", "--init", "face.png", "--n", "2", "--steps", "8", "--strength", "0.5",
          "--out", "i.png"], "i.png", grid(2, 2), "[IMG2IMG] grid -> i.png (strength=0.5"),
        (["inpaint", "--init", "face.png", "--box", "2,2,10,12", "--n", "3", "--steps", "4",
          "--resamples", "2", "--out", "b.png"], "b.png", grid(3, 2),
         "resamples=2, generated=31% of pixels"),
        (["inpaint", "--init", "face.png", "--mask", "mask.png", "--n", "1", "--steps",
          "4", "--out", "m.png"], "m.png", grid(1, 1), "generated=38% of pixels"),
    ]:
        text = _run([argv[0], "--ckpt", last, "--ema", *argv[1:], *CPU])
        assert say in text, text
        assert _png_shape(d / out) == shape
    assert sorted(os.listdir(d / "samples_individual"))[:3] == [f"img_{i:03d}.png"
                                                                for i in range(3)]


@pytest.mark.parametrize("extra", [[], ["--box", "0,0,4,4", "--mask", "m.png"]],
                         ids=["neither", "both"])
def test_inpaint_needs_one_of_mask_and_box_before_the_checkpoint(extra):
    """The argument mistake exits before the checkpoint (which does not
    exist here) is read."""
    with pytest.raises(SystemExit, match="exactly one of --mask PNG or --box"):
        cli.main(["inpaint", "--ckpt", "no/such/ckpt", "--init", "x.png", *extra, *CPU])


def test_new_commands_take_the_jax_clis_flags(monkeypatch):
    """The port's parser accepts what the JAX CLI's does for the four
    commands, with the same defaults (the JAX CLI's commands are replaced
    by a recorder, so its parse runs alone)."""
    seen = []
    for name in ("cmd_sample_dpmpp", "cmd_img2img", "cmd_inpaint", "cmd_sample_ddim"):
        monkeypatch.setattr(jax_cli, name, lambda args: seen.append(vars(args)))
    ours = cli.build_parser()
    for argv in (["sample-dpmpp", "--ckpt", "c"], ["sample-dpmpp", "--ckpt", "c", "--sde",
                                                   "--steps", "12", "--schedule", "karras",
                                                   "--individual", "--n", "5"],
                 ["img2img", "--ckpt", "c", "--init", "i"],
                 ["img2img", "--ckpt", "c", "--init", "i", "--strength", "0.3",
                  "--eta", "0.2", "--steps", "20", "--n", "4"],
                 ["inpaint", "--ckpt", "c", "--init", "i", "--box", "1,2,3,4"],
                 ["inpaint", "--ckpt", "c", "--init", "i", "--mask", "m", "--resamples",
                  "3", "--eta", "0.5"],
                 ["sample-ddim", "--ckpt", "c", "--refresh-every", "3"]):
        jax_cli.main(argv)
        a, b = vars(ours.parse_args(argv)), seen.pop()
        shared = set(b) - {"fn"}
        assert shared <= set(a), shared - set(a)
        assert {k: a[k] for k in shared} == {k: b[k] for k in shared}


def test_train_blobs_on_the_device_cache_scores_rfid(tmp_path):
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps(dict(EXP, epochs=1, sample_n=16)))
    out = _run(["train", "--config", str(cfg), "--data", "blobs", "--synthetic-size", "32",
                "--device-cache", "--ckpt-dir", str(tmp_path / "ck"), "--eval-every", "1",
                *CPU])
    res = _last_json(out)
    assert "rFID=" in out and "[EVAL]" in out
    assert np.isfinite(res["rfid_first"]) and res["rfid_first"] == res["rfid_last"]


@pytest.mark.parametrize("classes", [0, 3])
@pytest.mark.parametrize("src", ["synthetic", "blobs"])
def test_preload_and_device_cache_give_the_host_loaders_batches(src, classes):
    """``--preload`` and ``--device-cache`` yield the host loader's train
    and eval batches in its order (the cache's uint8 within half a code),
    with each image's label when the model is conditional, none otherwise."""
    from argparse import Namespace

    exp = config.ExperimentConfig.from_dict(
        dict(EXP, batch_size=4, model=dict(EXP["model"], num_classes=classes)))

    def batches(**flags):
        args = Namespace(**{"data": src, "synthetic_size": 12, "preload": False,
                            "device_cache": False, **flags})
        train, val = cli._make_loader(args, exp, "cpu", with_eval=True)
        return [(np.asarray(x), None if y is None else np.asarray(y))
                for loader in (train, val) for x, y in loader]

    host = batches()
    assert len(host) == 3 + 1
    for flags in ({"preload": True}, {"device_cache": True}):
        got = batches(**flags)
        assert len(got) == len(host)
        for i, ((hx, hy), (x, y)) in enumerate(zip(host, got)):
            np.testing.assert_allclose(x, hx, rtol=0,
                                       atol=0 if "preload" in flags else 0.5 / 127.5 + 1e-6)
            if classes:
                np.testing.assert_array_equal(y, hy)
            elif i < 3 and flags.get("device_cache"):
                assert y is None, "an unconditional device cache yields labels"
    if classes:
        assert sorted(np.concatenate([y for _x, y in host[:3]]).tolist()) == \
            sorted(np.arange(12) % classes)


@pytest.fixture
def faces_zip(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "faces.zip"
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(20):
            buf = io.BytesIO()
            img = rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)
            Image.fromarray(img).save(buf, format="JPEG" if i % 4 else "PNG", quality=95)
            zf.writestr(f"img/{i:06d}.{'jpg' if i % 4 else 'png'}", buf.getvalue())
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--device-cache", "--val-frac", "0.2",
                                        "--eval-every", "1"]],
                         ids=["host", "device_cache_val"])
def test_train_from_a_zip(tmp_path, monkeypatch, faces_zip, extra):
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps(dict(EXP, epochs=1)))
    out = _run(["train", "--config", str(cfg), "--data", "zip", "--zip-path", faces_zip,
                "--no-samples", "--ckpt-dir", "ck", *extra, *CPU])
    assert "decoder native" in out
    assert os.path.exists(tmp_path / "data" / "celeba_zip" / ".extraction_complete")
    with open(tmp_path / "ck" / "verify16_metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert rec["global_step"] == 2  # 16 of the 20 images, or the 16 not held out
    if extra:
        assert "[SPLIT] zip corpus 20 -> train 16 / val 4" in out and "[EVAL]" in out
    assert np.isfinite(_last_json(out)["final_loss"])


NOT_PORTED = "is not ported yet"
NEEDS_CLASSES = "--class-id needs a class-conditional checkpoint"
NEEDS_CLASS_ID = "--guidance needs --class-id"
# the JAX CLI's refusals of the latent family's flags
LATENT_SR = "--latent-vae with superres_factor is not supported (cascade in pixel space instead)"
CM_VAE = "sample-cm: latent consistency checkpoints are not supported; distill in pixel space"
# the JAX CLI's refusals of the mesh flags (ported: tests/test_torch_parallel_cli.py)
NEEDS_MESH = ("--device-cache-sharded needs --mesh (the corpus shards over the mesh's "
              "data axis)")
VAE_SHARDED = "error: --vae does not compose with --sharded/--sde yet"


@pytest.mark.parametrize("argv,msg,classes", [
    (["train", "--mesh", "fsdp", "--data", "hf"], f"--data hf (the HuggingFace download) "
     f"{NOT_PORTED}", 0),
    (["train", "--device-cache-sharded"], NEEDS_MESH, 0),
    (["train", "--preset", "sr64to256", "--latent-vae", "v"], LATENT_SR, 0),
    (["train", "--data", "hf"], "--data hf", 0),
    (["sample-ddim", "--ckpt", "c", "--sharded", "--vae", "v"], VAE_SHARDED, 0),
    (["sample-ddim", "--ckpt", "c", "--refresh-every", "4", "--class-id", "1"],
     "--class-id with --refresh-every (encoder-cached sampling) is not supported", 3),
    (["sample-ddpm", "--ckpt", "c", "--class-id", "1"], NEEDS_CLASSES, 0),
    (["sample-ddpm", "--ckpt", "c", "--guidance", "2"], NEEDS_CLASS_ID, 0),
    (["sample-cm", "--ckpt", "c", "--vae", "v"], CM_VAE, 0),
    (["eval", "--ckpt", "c", "--nll", "5", "--data", "celeba"],
     "--data celeba has no labels", 3),
    (["eval", "--ckpt", "c", "--nll-full", "--data", "celeba"],
     "--data celeba has no labels", 3),
    (["sample-dpmpp", "--ckpt", "c", "--sharded", "--vae", "v"], VAE_SHARDED, 0),
    (["sample-dpmpp", "--ckpt", "c", "--sde", "--class-id", "2"], NEEDS_CLASSES, 0),
    (["img2img", "--ckpt", "c", "--init", "i.png", "--guidance", "3"], NEEDS_CLASS_ID, 0),
    (["inpaint", "--ckpt", "c", "--init", "i.png", "--box", "0,0,4,4", "--class-id", "0"],
     NEEDS_CLASSES, 0),
], ids=["mesh", "sharded_cache", "latent", "hf", "sharded", "refresh", "class_id",
        "guidance", "vae", "nll", "nll_full", "dpmpp_sharded", "dpmpp_class_id",
        "img2img_guidance", "inpaint_class_id"])
def test_unported_flags_exit(argv, msg, classes, tmp_path):
    """Flags whose modules are not ported exit "not ported yet" (``--data
    hf``, also under a one-rank ``--mesh`` whose process group the command
    ends again); the class, latent and mesh flags (ported) exit with the JAX
    CLI's message where they do not apply, before the checkpoint (which
    does not exist here) is read.  A case that names a preset runs it, not
    the config file."""
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps(_cond_exp(classes) if classes else EXP))
    exp = [] if "--preset" in argv else ["--config", str(cfg)]
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, *exp, *CPU])
    assert msg in str(e.value)
    unported = not classes and msg not in (NEEDS_CLASSES, NEEDS_CLASS_ID, LATENT_SR, CM_VAE,
                                           NEEDS_MESH, VAE_SHARDED)
    assert (NOT_PORTED in str(e.value)) == unported
    assert not torch.distributed.is_initialized()


def _cond_exp(classes, **kw):
    """EXP as a class-conditional model (``model.num_classes``), at width 64
    so the class bias survives GroupNorm (two channels per group)."""
    return dict(EXP, model=dict(EXP["model"], base_channels=64, num_classes=classes), **kw)


@pytest.fixture(scope="module")
def cond_run(tmp_path_factory):
    """A class-conditional run: blob faces with 3 class hues from the device
    cache, 1 epoch of 4 steps with the eval pass and the class-cycled grid."""
    d = tmp_path_factory.mktemp("cond")
    cfg = d / "cond.json"
    cfg.write_text(json.dumps(_cond_exp(3, epochs=1)))
    ck = str(d / "ck")
    out = _run(["train", "--config", str(cfg), "--data", "blobs", "--synthetic-size", "32",
                "--device-cache", "--eval-every", "1", "--ckpt-dir", ck, *CPU])
    return d, str(cfg), ck, out


def test_conditional_train_leaves_a_conditional_checkpoint(cond_run):
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, load_checkpoint

    d, _cfg, ck, out = cond_run
    last = os.path.join(ck, "verify16_last")
    assert "[EVAL]   val_loss=" in out and "EMA_used=" in out and "rFID=" in out
    assert np.isfinite(_last_json(out)["final_loss"])
    exp = config.ExperimentConfig.from_dict(read_meta(last)["configs"]["experiment"])
    assert exp.model.num_classes == 3 and exp.train.cond_dropout == 0.1
    # the JAX package reads the same experiment
    assert jax_config.ExperimentConfig.from_dict(exp.to_dict()).model.num_classes == 3
    model = UNetDenoiser(exp.model, dtype=torch.float32, device="cpu")
    state, meta = load_checkpoint(last, init_train_state(model, exp.train)[0])
    assert meta["global_step"] == 4 and "class_emb.weight" in state.ema_params


def test_conditional_sampling_editing_and_nll_from_the_checkpoint(cond_run, monkeypatch):
    d, _cfg, ck, _ = cond_run
    monkeypatch.chdir(d)
    last = os.path.join(ck, "verify16_last")
    grid = lambda n, nrow: jax_images.make_grid(np.zeros((n, 16, 16, 3)),  # noqa: E731
                                                nrow=nrow).shape
    Image.fromarray((np.random.default_rng(0).uniform(size=(16, 16, 3)) * 255
                     ).astype(np.uint8)).save(d / "face.png")
    for argv, out, shape, say in [
        (["sample-ddim", "--class-id", "all", "--guidance", "3", "--n", "4", "--steps", "5",
          "--out", "a.png"], "a.png", grid(4, 2), "(class=all, guidance=3.0)"),
        (["sample-dpmpp", "--class-id", "2", "--n", "3", "--steps", "5", "--out", "p.png"],
         "p.png", grid(3, 2), "(class=2, guidance=1.0)"),
        (["sample-ddpm", "--class-id", "1", "--guidance", "0", "--n", "2", "--out",
          "d.png"], "d.png", grid(2, 2), "(class=1, guidance=0.0)"),
        (["img2img", "--init", "face.png", "--class-id", "1", "--n", "2", "--steps", "8",
          "--out", "i.png"], "i.png", grid(2, 2), "(class=1, guidance=1.0)"),
        (["inpaint", "--init", "face.png", "--box", "2,2,10,12", "--class-id", "0",
          "--guidance", "2", "--n", "1", "--steps", "4", "--out", "b.png"], "b.png",
         grid(1, 1), "(class=0, guidance=2.0)"),
    ]:
        text = _run([argv[0], "--ckpt", last, "--ema", *argv[1:], *CPU])
        assert say in text, text
        assert _png_shape(d / out) == shape
    with pytest.raises(SystemExit, match=r"--class-id 3 out of range \[0, 3\)"):
        cli.main(["sample-ddim", "--ckpt", last, "--class-id", "3", *CPU])
    with pytest.raises(SystemExit, match="--data zip has no labels"):
        cli.main(["train", "--config", _cfg, "--data", "zip", "--zip-path", "z.zip", *CPU])
    res = _last_json(_run(["eval", "--ckpt", last, "--data", "synthetic", "--eval-size", "8",
                           "--rfid-n", "0", "--nll", "3", "--nll-n", "4", *CPU]))
    assert res.keys() == {"ckpt", "global_step", "val_loss", "val_loss_ema", "nll_bpd_mc3",
                          "nll_n", "nll_conditional"}
    assert res["nll_n"] == 4 and res["nll_conditional"] is True
    assert np.isfinite(res["nll_bpd_mc3"]) and res["nll_bpd_mc3"] > 0


def test_nll_full_on_an_unconditional_checkpoint(run):
    _d, _cfg, ck, _ = run
    res = _last_json(_run(["eval", "--ckpt", os.path.join(ck, "verify16_last"), "--data",
                           "blobs", "--eval-size", "8", "--rfid-n", "0", "--nll-full",
                           "--nll-n", "2", *CPU]))
    assert res["nll_n"] == 2 and res["nll_conditional"] is False
    assert np.isfinite(res["nll_bpd_full"]) and res["nll_bpd_full"] > 0


def test_class_and_nll_flags_are_the_jax_clis(monkeypatch):
    """``--class-id``, ``--guidance`` and the ``eval --nll`` flags parse as
    the JAX CLI's, with the same defaults."""
    seen = []
    for name in ("cmd_sample_ddpm", "cmd_sample_dpmpp", "cmd_img2img", "cmd_inpaint",
                 "cmd_sample_ddim", "cmd_eval"):
        monkeypatch.setattr(jax_cli, name, lambda args: seen.append(vars(args)))
    ours = cli.build_parser()
    for argv in (["sample-ddpm", "--ckpt", "c", "--class-id", "all", "--guidance", "3"],
                 ["sample-ddim", "--ckpt", "c", "--class-id", "2"],
                 ["sample-dpmpp", "--ckpt", "c", "--guidance", "1.5"],
                 ["img2img", "--ckpt", "c", "--init", "i", "--class-id", "0"],
                 ["inpaint", "--ckpt", "c", "--init", "i", "--box", "1,2,3,4", "--class-id",
                  "1", "--guidance", "4"],
                 ["eval", "--ckpt", "c"],
                 ["eval", "--ckpt", "c", "--nll", "25", "--nll-n", "8"],
                 ["eval", "--ckpt", "c", "--nll-full"]):
        jax_cli.main(argv)
        a, b = vars(ours.parse_args(argv)), seen.pop()
        shared = set(b) - {"fn"}
        assert shared <= set(a), shared - set(a)
        assert {k: a[k] for k in shared} == {k: b[k] for k in shared}


def test_zip_without_path_and_no_card_without_device_cpu(tmp_path):
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps(EXP))
    with pytest.raises(SystemExit, match="--data zip requires --zip-path"):
        cli.main(["train", "--config", str(cfg), "--data", "zip", *CPU])
    with pytest.raises(SystemExit, match="zip not found"):
        cli.main(["train", "--config", str(cfg), "--data", "zip", "--zip-path",
                  str(tmp_path / "no.zip"), *CPU])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["train", "--config", str(cfg)])
