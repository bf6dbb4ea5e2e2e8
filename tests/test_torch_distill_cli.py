"""Distillation through the port's entry points, on the CPU at the 16-px
config of ``tests/test_torch_cli.py``, and the service over the port's own
checkpoint directories:

- ``cli distill`` (progressive; consistency, unconditional and
  conditional with guidance baked in) writes a student whose meta
  ``extra`` and ``configs``, and whose last two lines of output, equal what
  the JAX CLI's ``cmd_distill`` writes and prints given the same run (JAX's
  loaders, distillers and saver replaced by stubs that hand it the port's
  results, so no XLA program is compiled); the students sample through
  ``sample-ddim --schedule linear`` and ``sample-cm``; the JAX CLI's exit
  messages for ``--guidance`` on an unconditional checkpoint, ``sample-cm``
  on a checkpoint that is no consistency student, ``--guidance`` and
  ``--vae`` on ``sample-cm``; the two commands' flags and defaults are the
  JAX CLI's;
- the service over a ``train`` checkpoint directory (EMA and raw weights)
  equals ``ddim_infer_sample`` from the same seed, also through
  ``python -m ddpm_diffusion_model_tpu_torch.serving --ckpt <dir>``;
- ``sampler=cm`` over a consistency student: coalesced requests equal their
  solo re-runs and ``sample-cm --steps 1`` from the same seed; every route
  the JAX service refuses answers 400; ``/healthz`` reports the student."""

import concurrent.futures
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ddpm_diffusion_model_tpu import cli as jax_cli
from ddpm_diffusion_model_tpu import training as jax_training
from ddpm_diffusion_model_tpu.training import consistency as jcm
from ddpm_diffusion_model_tpu.utils import images as jax_images
from ddpm_diffusion_model_tpu_torch import cli
from ddpm_diffusion_model_tpu_torch.sampling import ddim_infer_sample
from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
from ddpm_diffusion_model_tpu_torch.training import checkpoint_experiment, load_run, read_meta

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = {"model": {"in_channels": 3, "base_channels": 32, "channel_mults": [1, 2],
                 "num_res_blocks": 1, "attn_resolutions": [8], "time_embed_dim": 64,
                 "dropout": 0.1, "num_heads": 2, "head_dim": 16, "img_resolution": 16},
       "diffusion": {"T": 100, "schedule": "linear", "beta_min": 0.0001, "beta_max": 0.02,
                     "cosine_s": 0.008, "clamp_x0": True, "dynamic_threshold": None,
                     "img_size": 16},
       "train": {"base_lr": 0.001, "warmup_steps": 5, "weight_decay": 0.0, "adam_b1": 0.9,
                 "adam_b2": 0.999, "grad_clip": 1.0, "grad_accum_steps": 2,
                 "ema_decay": 0.999},
       "run_name": "dist16", "img_size": 16, "batch_size": 8, "epochs": 1,
       "sample_every": 1, "sample_n": 4, "save_every": 1, "log_every": 2, "seed": 0,
       "remat": False}
# width 64 with 3 classes: the class bias survives GroupNorm (two channels a group)
COND = dict(EXP, model=dict(EXP["model"], base_channels=64, num_classes=3),
            run_name="cond16")
CPU = ["--device", "cpu"]
DATA = ["--data", "synthetic", "--synthetic-size", "16"]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


def _png_shape(path):
    with Image.open(path) as im:
        return np.asarray(im).shape


def _grid_shape(n):
    return jax_images.make_grid(np.zeros((n, 16, 16, 3)), nrow=int(n ** 0.5)).shape


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two trained teachers (2 steps each) and three students: progressive
    8 -> 4 -> 2 and consistency from the unconditional one, consistency
    with guidance 2 from the conditional one."""
    d = tmp_path_factory.mktemp("distill")
    out = {"dir": d}
    for name, exp in (("uncond", EXP), ("cond", COND)):
        cfg = d / f"{name}.json"
        cfg.write_text(json.dumps(exp))
        _run(["train", "--config", str(cfg), *DATA, "--no-samples", "--ckpt-dir",
              str(d / "ck"), *CPU])
        out[name] = (str(cfg), str(d / "ck" / f"{exp['run_name']}_last"))
    jobs = {
        "progressive": ("uncond", ["--start-steps", "8", "--to-steps", "2",
                                   "--phase-updates", "2"]),
        "consistency": ("uncond", ["--mode", "consistency", "--ladder-steps", "8",
                                   "--phase-updates", "3"]),
        "cond_consistency": ("cond", ["--mode", "consistency", "--ladder-steps", "8",
                                      "--phase-updates", "2", "--guidance", "2"]),
    }
    for name, (teacher, extra) in jobs.items():
        cfg, ck = out[teacher]
        argv = ["distill", "--config", cfg, "--ckpt", ck, "--ema", "--out",
                str(d / name), *DATA, *extra]
        out[name] = (argv, str(d / name), _run([*argv, *CPU]))
    return out


# -------------------------------------------------------------- cli distill


def _jax_cmd_distill(monkeypatch, argv, info, prediction_type="epsilon"):
    """The JAX CLI's ``cmd_distill`` on ``argv`` with its checkpoint load,
    loader, distiller and saver replaced by stubs: the distiller returns
    ``info``; returns (what it saved, its stdout)."""
    saved = {}
    state = types.SimpleNamespace(params={}, ema_params={})
    sched = types.SimpleNamespace(prediction_type=prediction_type)
    monkeypatch.setattr(jax_cli, "_load_state", lambda ckpt, exp: (None, sched, state, {}))
    monkeypatch.setattr(jax_cli, "_make_loader", lambda args, exp, **kw: ([], None))
    for name in ("progressive_distill", "consistency_distill"):
        monkeypatch.setattr(jax_training, name, lambda *a, **kw: ({}, info))
    monkeypatch.setattr(jax_training, "init_train_state", lambda *a, **kw: (None, None))
    monkeypatch.setattr(jax_training, "make_optimizer", lambda cfg: None)

    def save(path, _state, *, extra=None, configs=None, **kw):
        saved.update(extra=extra, configs=configs)
        return os.path.abspath(path)

    monkeypatch.setattr(jax_training, "save_checkpoint", save)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_cli.main(argv)
    return saved, out.getvalue()


@pytest.mark.parametrize("name", ["progressive", "consistency", "cond_consistency"])
def test_distill_writes_and_prints_what_the_jax_cli_does(runs, monkeypatch, name):
    argv, path, out = runs[name]
    meta = read_meta(path)
    extra = meta["extra"]
    info = {"steps": extra["distilled_steps"], "phases": extra["distill_phases"]}
    if extra["distill_mode"] == "consistency":
        info.update(ladder_steps=8, sigma_data=jcm.SIGMA_DATA,
                    timestep_scaling=jcm.TIMESTEP_SCALING)
    saved, jax_out = _jax_cmd_distill(monkeypatch, argv, info)
    assert saved["extra"] == extra
    assert json.loads(json.dumps(saved["configs"])) == meta["configs"]
    assert out.strip().splitlines()[-2:] == jax_out.strip().splitlines()[-2:]
    if name == "progressive":
        assert [p["student_steps"] for p in extra["distill_phases"]] == [4, 2]
        assert extra["distilled_steps"] == 2 and "[DISTILL] note: epsilon" in out
        assert out.count("[distill 8->4] update") == 2
    else:
        assert extra["cm_sigma_data"] == 0.5 and extra["cm_timestep_scaling"] == 10.0
        assert extra["distill_guidance"] == (2.0 if name == "cond_consistency" else None)
    for p in extra["distill_phases"]:
        assert np.isfinite(p["first_loss"]) and np.isfinite(p["last_loss"])
    assert meta["global_step"] == 0 and os.path.isfile(os.path.join(path, "state.pt"))


def test_students_sample_through_the_cli(runs, monkeypatch):
    d = runs["dir"]
    monkeypatch.chdir(d)
    _argv, prog, out = runs["progressive"]
    assert f"sample-ddim --ckpt {d / 'progressive'} --schedule linear --steps 2" in out
    text = _run(["sample-ddim", "--ckpt", prog, "--ema", "--schedule", "linear", "--steps",
                 "2", "--n", "4", "--out", "p.png", *CPU])
    assert "(steps=2, eta=0.0)" in text and _png_shape(d / "p.png") == _grid_shape(4)
    _argv, cm, out = runs["consistency"]
    assert out.strip().endswith(f"sample-cm --ckpt {d / 'consistency'} --steps 1")
    for steps in ("1", "3"):
        text = _run(["sample-cm", "--ckpt", cm, "--ema", "--steps", steps, "--n", "4",
                     "--out", f"c{steps}.png", *CPU])
        assert f"(steps={steps}, NFE={steps})" in text
        assert _png_shape(d / f"c{steps}.png") == _grid_shape(4)
    _argv, ccm, out = runs["cond_consistency"]
    assert out.strip().endswith("--steps 1 --class-id all")
    text = _run(["sample-cm", "--ckpt", ccm, "--ema", "--steps", "2", "--class-id", "2",
                 "--n", "3", "--out", "k.png", *CPU])
    assert "(class=2, guidance=1.0)" in text and "warning" not in text
    assert _png_shape(d / "k.png") == _grid_shape(3)
    text = _run(["sample-cm", "--ckpt", ccm, "--steps", "1", "--n", "2", "--out", "u.png",
                 *CPU])
    assert "[SAMPLE-CM] warning: conditional consistency student" in text


def _jax_exit(monkeypatch, argv, extra=None):
    """The JAX CLI's exit message on ``argv`` (its checkpoint load a stub
    whose meta holds ``extra``)."""
    state = types.SimpleNamespace(params={}, ema_params={})
    sched = types.SimpleNamespace(prediction_type="epsilon")
    monkeypatch.setattr(jax_cli, "_load_state",
                        lambda ckpt, exp: (None, sched, state, {"extra": extra or {}}))
    with pytest.raises(SystemExit) as e:
        jax_cli.main(argv)
    return str(e.value)


@pytest.mark.parametrize("case", ["distill_guidance_unconditional", "cm_on_progressive",
                                  "cm_on_base", "cm_guidance", "cm_vae"])
def test_exit_messages_are_the_jax_clis(runs, monkeypatch, case):
    cfg, base = runs["uncond"]
    _argv, prog, _out = runs["progressive"]
    argv, extra = {
        "distill_guidance_unconditional": (["distill", "--config", cfg, "--ckpt", base,
                                            "--out", "x", "--guidance", "3"], None),
        "cm_on_progressive": (["sample-cm", "--config", cfg, "--ckpt", prog],
                              read_meta(prog)["extra"]),
        "cm_on_base": (["sample-cm", "--config", cfg, "--ckpt", base], None),
        "cm_guidance": (["sample-cm", "--config", cfg, "--ckpt", prog, "--guidance", "2"],
                        None),
        "cm_vae": (["sample-cm", "--config", cfg, "--ckpt", prog, "--vae", "v"], None),
    }[case]
    want = _jax_exit(monkeypatch, argv, extra)
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, *CPU])
    assert str(e.value) == want
    if case == "cm_on_progressive":
        assert "distill_mode='progressive'" in want


def test_distill_and_sample_cm_take_the_jax_clis_flags(monkeypatch):
    seen = []
    for name in ("cmd_distill", "cmd_sample_cm"):
        monkeypatch.setattr(jax_cli, name, lambda args: seen.append(vars(args)))
    ours = cli.build_parser()
    for argv in (["distill", "--ckpt", "c", "--out", "o"],
                 ["distill", "--ckpt", "c", "--out", "o", "--mode", "consistency",
                  "--ladder-steps", "16", "--distance", "l2", "--guidance", "3",
                  "--data", "zip", "--zip-path", "z", "--val-frac", "0.1", "--no-crop",
                  "--device-cache", "--lr", "3e-4", "--ema-decay", "0.99"],
                 ["distill", "--ckpt", "c", "--out", "o", "--start-steps", "32",
                  "--to-steps", "8", "--phase-updates", "7", "--weighting", "snr",
                  "--preload", "--synthetic-size", "64", "--data-dir", "dd", "--ema"],
                 ["sample-cm", "--ckpt", "c"],
                 ["sample-cm", "--ckpt", "c", "--steps", "1", "--n", "9", "--class-id",
                  "all", "--seed", "3", "--out", "o.png"]):
        jax_cli.main(argv)
        a, b = vars(ours.parse_args(argv)), seen.pop()
        shared = set(b) - {"fn"}
        assert shared <= set(a), shared - set(a)
        assert {k: a[k] for k in shared} == {k: b[k] for k in shared}


def test_distill_from_hf_is_not_ported(runs):
    cfg, base = runs["uncond"]
    with pytest.raises(SystemExit, match="--data hf .* is not ported yet"):
        cli.main(["distill", "--config", cfg, "--ckpt", base, "--out",
                  str(runs["dir"] / "hf"), "--data", "hf", *CPU])


# ------------------------------------------- serving a checkpoint directory


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _npy(base, **q):
    query = "&".join(f"{k}={v}" for k, v in dict(q, format="npy").items())
    return np.load(io.BytesIO(_get(f"{base}/sample?{query}")[2]))


@pytest.mark.parametrize("ema", [True, False], ids=["ema", "no_ema"])
def test_service_over_a_train_directory_equals_ddim_infer_sample(runs, ema, tmp_path):
    """C1: the directory ``train`` leaves is served with its experiment and
    (unless ``ema=False``) its EMA weights; /sample's rows equal
    ``ddim_infer_sample`` from the same seed."""
    cfg, base = runs["uncond"]
    svc = SamplerService.from_checkpoint(base, ema=ema, device="cpu")
    assert svc.img_size == 16 and svc.sched.T == 100 and not svc.consistency
    x, used = svc.sample(n=4, steps=5, seed=7)
    assert used["steps"] == 5 and x.shape == (4, 16, 16, 3)
    model, sched, state, _meta = load_run(base, cli._exp_from_args(
        cli.build_parser().parse_args(["sample-ddim", "--ckpt", base])), "cpu")
    grid = ddim_infer_sample(model, None, sched, n=4, img_size=16,
                             ema_params=state.ema_params if ema else None,
                             out_path=str(tmp_path / "g.png"), seed=7, steps=5,
                             device="cpu")
    np.testing.assert_allclose(jax_images.make_grid(x, nrow=2), grid, atol=1e-6)
    other = SamplerService.from_checkpoint(base, ema=not ema, device="cpu")
    assert np.abs(other.sample(n=4, steps=5, seed=7)[0] - x).max() > 1e-4
    # --preset overrides the stored experiment (here: one that does not fit)
    with pytest.raises(Exception):
        SamplerService.from_checkpoint(base, preset="celeba64_low", device="cpu")


def test_checkpoint_experiment_reads_the_meta(runs, tmp_path):
    """The experiment the service and the CLI open a directory under: the
    one ``train`` stored in its meta, None for a directory without."""
    cfg, base = runs["uncond"]
    exp = checkpoint_experiment(base)
    assert json.loads(exp.to_json()) == read_meta(base)["configs"]["experiment"]
    assert exp.img_size == 16 and exp.diffusion.T == 100
    assert checkpoint_experiment(str(tmp_path)) is None


@pytest.mark.parametrize("first", ["utils.config", "training.restore", "serving"])
def test_checkpoint_loading_modules_import_first(first):
    """The modules around ``training/restore.py`` (``utils.config`` imports
    the training package, which imports ``restore``) import in any order."""
    out = subprocess.run([sys.executable, "-c",
                          f"import ddpm_diffusion_model_tpu_torch.{first}"],
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_main_serves_a_train_directory(runs):
    _cfg, base = runs["uncond"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddpm_diffusion_model_tpu_torch.serving", "--ckpt", base,
         "--device", "cpu", "--port", "0"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "[SERVE] sampling service on http://" in line, line
        url = line.split("on ")[1].split()[0]
        health = json.loads(_get(url + "/healthz")[2])
        assert health["img_size"] == 16 and health["T"] == 100
        assert health["consistency"] is False
        want = SamplerService.from_checkpoint(base, device="cpu").sample(n=2, steps=2,
                                                                         seed=4)[0]
        np.testing.assert_array_equal(_npy(url, n=2, steps=2, seed=4), want)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0 and "[SERVE] stopped" in rest, rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ----------------------------------------------------------- sampler=cm


@contextlib.contextmanager
def _serving(path):
    svc = SamplerService.from_checkpoint(path, device="cpu")
    svc.COALESCE_WINDOW_S = 0.2  # wide enough that concurrent requests meet
    srv = make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


@pytest.fixture(scope="module")
def served_cm(runs):
    with _serving(runs["consistency"][1]) as s:
        yield s


def _sample_cm_rows(monkeypatch, ckpt, seed, n, extra=()):
    """What ``cli sample-cm --steps 1`` saves, before it is quantized."""
    from ddpm_diffusion_model_tpu_torch.utils import images

    got = {}
    monkeypatch.setattr(images, "save_image_grid", lambda x, path, nrow: got.update(x=x))
    _run(["sample-cm", "--ckpt", ckpt, "--ema", "--steps", "1", "--n", str(n), "--seed",
          str(seed), "--out", "unused.png", *extra, *CPU])
    return got["x"]


def test_cm_requests_coalesce_and_equal_sample_cm(served_cm, runs, monkeypatch):
    svc, base = served_cm
    health = json.loads(_get(base + "/healthz")[2])
    assert health["consistency"] is True and health["edit_modes"] == []
    assert "consistency_caveat" not in health
    code, hdr, _b = _get(base + "/sample?n=2&seed=5")  # defaults: sampler cm, 1 step
    assert code == 200 and hdr["X-Used-Steps"] == "1"
    solo = {s: _npy(base, n=2, seed=s, sampler="cm", steps=1) for s in (31, 32)}
    before = svc.metrics()["multi_request_batches"]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        futs = {s: ex.submit(_npy, base, n=2, seed=s, sampler="cm", schedule=k)
                for s, k in ((31, "t_linear"), (32, "cosine"))}  # the schedule is ignored
        merged = {s: f.result() for s, f in futs.items()}
    assert svc.metrics()["multi_request_batches"] == before + 1
    for s in solo:
        np.testing.assert_allclose(merged[s], solo[s], atol=1e-5)
        cli_rows = _sample_cm_rows(monkeypatch, runs["consistency"][1], s, 2)
        np.testing.assert_allclose(solo[s], cli_rows, atol=1e-6)
    assert np.abs(solo[31] - solo[32]).max() > 1e-3
    _x, used = svc.sample(n=1, steps=1, seed=3, sampler="cm", eta=0.7, schedule_kind="karras")
    assert used["eta"] == 0.0 and used["schedule"] == "t_linear" and "warning" not in used


CM_ONLY = "sampler=cm serves consistency-distilled checkpoints only"


@pytest.mark.parametrize("query,needle", [
    ("steps=2", "sampler=cm serves 1-NFE only (steps=1)"),
    ("sampler=ddim&steps=1", "this is a consistency student checkpoint"),
    ("sampler=dpmpp&steps=1", "this is a consistency student checkpoint"),
    ("guidance=2", "guidance is fixed at distillation time"),
    ("class_id=0", "class_id/guidance need a class-conditional checkpoint"),
    ("sampler=euler", "sampler must be"),
])
def test_cm_bad_requests_are_400(served_cm, query, needle):
    svc, base = served_cm
    before = svc.metrics()["client_errors"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"{base}/sample?{query}")
    assert ei.value.code == 400 and needle in ei.value.read().decode()
    assert svc.metrics()["client_errors"] == before + 1


def test_edit_on_a_student_is_400(served_cm):
    import base64

    _svc, base = served_cm
    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, format="PNG")
    body = json.dumps({"image": base64.b64encode(buf.getvalue()).decode()}).encode()
    req = urllib.request.Request(base + "/edit", data=body,
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 400
    assert "consistency student's weights" in ei.value.read().decode()


def test_conditional_student_is_served_with_its_caveat(runs, monkeypatch):
    ckpt = runs["cond_consistency"][1]
    with _serving(ckpt) as (svc, base):
        health = json.loads(_get(base + "/healthz")[2])
        assert health["consistency"] is True and health["num_classes"] == 3
        assert "untrained NULL class" in health["consistency_caveat"]
        x, used = svc.sample(n=2, steps=1, seed=8, sampler="cm")
        assert "untrained NULL class" in used["warning"]
        x1, used1 = svc.sample(n=2, steps=1, seed=8, sampler="cm", class_id=1)
        assert "warning" not in used1 and np.abs(x1 - x).max() > 1e-4
        np.testing.assert_allclose(x1, _sample_cm_rows(monkeypatch, ckpt, 8, 2,
                                                       ["--class-id", "1"]), atol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + "/sample?class_id=0&guidance=2")
        assert ei.value.code == 400
        assert "w=2.0 baked in at distillation" in ei.value.read().decode()


def test_cm_requests_of_two_classes_share_a_batch_row_by_row(runs):
    """Labels go per row: two classes coalesce, each equal to its solo run."""
    with _serving(runs["cond_consistency"][1]) as (svc, base):
        solo = {c: _npy(base, n=2, seed=40 + c, class_id=c) for c in (0, 2)}
        before = svc.metrics()["multi_request_batches"]
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            futs = {c: ex.submit(_npy, base, n=2, seed=40 + c, class_id=c) for c in solo}
            merged = {c: f.result() for c, f in futs.items()}
        assert svc.metrics()["multi_request_batches"] == before + 1
        for c in solo:
            np.testing.assert_allclose(merged[c], solo[c], atol=1e-5)
        assert np.abs(solo[0] - solo[2]).max() > 1e-3


def test_plain_checkpoint_refuses_cm(runs):
    svc = SamplerService.from_checkpoint(runs["progressive"][1], device="cpu")
    assert not svc.consistency
    with pytest.raises(ValueError, match=CM_ONLY):
        svc.sample(n=1, steps=1, sampler="cm")
