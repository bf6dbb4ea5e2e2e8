"""The port's sampling service on the CPU: health, PNG/npy sampling, the
eta=0 and DPM-Solver++ coalescer (coalesced rows equal the solo run, one
queue per sampler), eta>0, ``POST /edit`` (img2img and inpaint, the JAX
service's snapping and caps), the 400s for bad and not-yet-ported
requests, metrics, and ``main``'s graceful drain."""

import base64
import concurrent.futures
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ddpm_diffusion_model_tpu_torch.models import UNetConfig, UNetDenoiser
from ddpm_diffusion_model_tpu_torch.ops import DiffusionConfig, make_schedule
from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server

torch.set_num_threads(1)

RES = 8
CFG = UNetConfig(base_channels=8, channel_mults=(1, 2), num_res_blocks=1,
                 attn_resolutions=(4,), time_embed_dim=16, num_heads=1,
                 head_dim=8, img_resolution=RES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served():
    torch.manual_seed(0)
    model = UNetDenoiser(CFG, dtype=torch.float32, device="cpu")
    svc = SamplerService(model, make_schedule(DiffusionConfig(T=20, img_size=RES),
                                              device="cpu"), RES, device="cpu")
    svc.COALESCE_WINDOW_S = 0.2  # wide enough that concurrent requests meet
    srv = make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _npy(base, **q):
    query = "&".join(f"{k}={v}" for k, v in dict(q, format="npy").items())
    return np.load(io.BytesIO(_get(f"{base}/sample?{query}")[2]))


def test_healthz(served):
    _svc, base = served
    code, _h, body = _get(base + "/healthz")
    data = json.loads(body)
    assert code == 200 and data["status"] == "ok"
    assert data["img_size"] == RES and data["T"] == 20 and data["max_n"] == 64
    assert data["step_choices"] == list(SamplerService.STEP_CHOICES)
    assert data["num_classes"] == 0 and data["edit_modes"] == ["img2img", "inpaint"]
    assert data["device"] == "cpu"


def test_sample_png_and_used_headers(served):
    _svc, base = served
    code, hdr, body = _get(base + "/sample?n=3&steps=4&seed=3")
    assert code == 200 and hdr["Content-Type"] == "image/png"
    assert hdr["X-Used-N"] == "3" and hdr["X-Used-Steps"] == "5"  # 4 snaps to 5
    from PIL import Image

    assert Image.open(io.BytesIO(body)).size[0] > RES


def test_coalesced_rows_equal_solo_runs(served):
    svc, base = served
    solo = {s: _npy(base, n=2, steps=2, seed=s) for s in (21, 22, 23)}
    before = svc.metrics()["multi_request_batches"]
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
        futs = {s: ex.submit(_npy, base, n=2, steps=2, seed=s) for s in solo}
        merged = {s: f.result() for s, f in futs.items()}
    assert svc.metrics()["multi_request_batches"] > before
    for s in solo:
        assert merged[s].shape == (2, RES, RES, 3)
        # row i depends only on its own seed; co-batching changes only the
        # batch shape (last-ulp reassociation), never the math
        np.testing.assert_allclose(merged[s], solo[s], atol=1e-4)
    assert np.abs(solo[21] - solo[22]).max() > 1e-3


def test_eta_positive_is_deterministic_per_seed(served):
    _svc, base = served
    a = _npy(base, n=2, steps=2, seed=5, eta=1.0)
    b = _npy(base, n=2, steps=2, seed=5, eta=1.0)
    c = _npy(base, n=2, steps=2, seed=5, eta=0.0)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert not np.array_equal(a, c)


# a class or a guidance other than 1 on this unconditional checkpoint: the
# JAX service's 400 (the ids are the cases' since they answered "not ported")
NEEDS_CLASSES = "need a class-conditional checkpoint"
# sampler=cm on a checkpoint that is no consistency student: the JAX
# service's 400 (the ids are the cases' since they answered "not ported")
CM_ONLY = "serves consistency-distilled checkpoints only"


@pytest.mark.parametrize("query,needle", [
    ("schedule=bogus", "schedule must be one of"),
    ("n=abc", "invalid literal"),
    pytest.param("sampler=dpmpp&class_id=3", NEEDS_CLASSES,
                 id="sampler=dpmpp&class_id=3-not ported yet"),
    pytest.param("sampler=cm", CM_ONLY, id="sampler=cm-not ported yet"),
    ("sampler=euler", "sampler must be"),
    pytest.param("class_id=3", NEEDS_CLASSES, id="class_id=3-not ported yet"),
    pytest.param("guidance=2.0", NEEDS_CLASSES, id="guidance=2.0-not ported yet"),
    pytest.param("guidance=1.2", NEEDS_CLASSES,  # snaps to 1.25
                 id="guidance=1.2-not ported yet"),
    ("guidance=nan", "guidance must be finite"),
    ("guidance=inf", "guidance must be finite"),
    ("eta=nan", "finite"),
])
def test_bad_or_unported_requests_are_400(served, query, needle):
    svc, base = served
    before = svc.metrics()["client_errors"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"{base}/sample?steps=1&{query}")
    assert ei.value.code == 400
    assert needle in json.loads(ei.value.read())["error"]
    assert svc.metrics()["client_errors"] == before + 1


@pytest.mark.parametrize("guidance", ["1.1", "0.9", "1.125", "1"])
def test_guidance_snapping_to_one_is_served(served, guidance):
    """As the JAX service: guidance is clamped to [0, 8] and snapped to the
    0.25 grid before it is tested, so near 1.0 it is the unconditional
    request, answered 200 with the same images as guidance=1."""
    svc, base = served
    code, _h, _b = _get(f"{base}/sample?n=1&steps=1&seed=4&guidance={guidance}")
    assert code == 200
    x, used = svc.sample(n=1, steps=1, seed=4, guidance=float(guidance))
    assert used["guidance"] == 1.0
    np.testing.assert_array_equal(x, svc.sample(n=1, steps=1, seed=4)[0])


@pytest.mark.parametrize("path", ["/edit", "/upsample"])
def test_unported_post_routes_are_400(served, path):
    """On this plain, unconditional checkpoint, as in the JAX service:
    ``/edit`` with a class needs a class-conditional checkpoint, and
    ``/upsample`` needs an SR upsampler (tests/test_torch_superres_cli.py
    serves one)."""
    _svc, base = served
    body = {"image": _b64_png(np.full((RES, RES, 3), 0.5))}
    if path == "/edit":
        body["class_id"] = 1
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    want = (NEEDS_CLASSES if path == "/edit" else
            "upsample needs an SR upsampler checkpoint (cond_channels > 0) — this service "
            "holds a plain denoiser; use GET /sample")
    assert ei.value.code == 400 and want in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/nowhere")
    assert ei.value.code == 404


def _b64_png(img01, mode=None):
    from PIL import Image

    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr.squeeze(-1) if arr.ndim == 3 and arr.shape[-1] == 1 else arr,
                    mode=mode).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _face():
    rng = np.random.default_rng(0)
    return rng.uniform(size=(RES, RES, 3)).astype(np.float32)


def test_dpmpp_sample_is_served_coalesced_and_deterministic(served):
    """sampler=dpmpp forces eta to 0, coalesces with other DPM requests and
    equals ``dpmpp_from_init`` from the seed's x_T."""
    from ddpm_diffusion_model_tpu_torch.sampling import (build_ddim_schedule,
                                                         dpmpp_from_init, to_unit_interval)

    svc, base = served
    code, hdr, _ = _get(f"{base}/sample?n=2&steps=4&seed=3&sampler=dpmpp")
    assert code == 200 and hdr["X-Used-Steps"] == "5"
    x, used = svc.sample(n=2, steps=5, eta=0.7, seed=3, sampler="dpmpp")
    assert used["sampler"] == "dpmpp" and used["eta"] == 0.0
    ts = build_ddim_schedule("t_linear", 5, svc.sched.T,
                             alphas_cumprod=svc.sched.alphas_cumprod.numpy())
    want = to_unit_interval(dpmpp_from_init(svc.model, svc.sched,
                                            svc._init_noise(2, 3), ts)).numpy()
    np.testing.assert_allclose(x, want, atol=1e-5)
    np.testing.assert_array_equal(_npy(base, n=2, steps=5, seed=3, sampler="dpmpp",
                                       eta=0.9), x)
    ddim = _npy(base, n=2, steps=5, seed=3)
    assert np.abs(ddim - x).max() > 1e-3  # the same x_T, another sampler

    solo = {s: _npy(base, n=2, steps=2, seed=s, sampler="dpmpp") for s in (31, 32)}
    before = svc.metrics()["multi_request_batches"]
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        futs = {s: ex.submit(_npy, base, n=2, steps=2, seed=s, sampler="dpmpp")
                for s in solo}
        merged = {s: f.result() for s, f in futs.items()}
    assert svc.metrics()["multi_request_batches"] == before + 1
    for s in solo:
        np.testing.assert_allclose(merged[s], solo[s], atol=1e-4)


def test_ddim_and_dpmpp_requests_never_share_a_batch(served):
    """The queue key holds the sampler: a DDIM and a DPM request in the same
    window run as two batches of one request each, and each equals its
    solo run."""
    svc, base = served
    # 5 steps: a 2-point ladder's one DPM step is one DDIM step
    solo_d = _npy(base, n=2, steps=5, seed=41)
    solo_p = _npy(base, n=2, steps=5, seed=41, sampler="dpmpp")
    m0 = svc.metrics()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        fd = ex.submit(_npy, base, n=2, steps=5, seed=41)
        fp = ex.submit(_npy, base, n=2, steps=5, seed=41, sampler="dpmpp")
        d, p = fd.result(), fp.result()
    m1 = svc.metrics()
    assert m1["multi_request_batches"] == m0["multi_request_batches"]
    assert m1["coalesced_batches"] == m0["coalesced_batches"] + 2
    np.testing.assert_allclose(d, solo_d, atol=1e-4)
    np.testing.assert_allclose(p, solo_p, atol=1e-4)
    assert np.abs(d - p).max() > 1e-3


def test_edit_img2img_and_inpaint_are_served(served):
    svc, base = served
    img = _face()
    before = svc.metrics()["edits"]
    code, hdr, body = _post(base + "/edit", {"image": _b64_png(img), "mode": "img2img",
                                             "n": 3, "steps": 4, "strength": 0.5,
                                             "seed": 2, "format": "npy"})
    x = np.load(io.BytesIO(body))
    assert code == 200 and hdr["X-Used-N"] == "3" and hdr["X-Used-Steps"] == "5"
    assert x.shape == (3, RES, RES, 3) and 0.0 <= x.min() and x.max() <= 1.0
    code, hdr, body = _post(base + "/edit", {"image": _b64_png(img), "mode": "inpaint",
                                             "n": 2, "steps": 5, "box": [2, 2, 6, 6],
                                             "resamples": 2, "format": "npy"})
    y = np.load(io.BytesIO(body))
    assert code == 200 and y.shape == (2, RES, RES, 3)
    # the known pixels are the PNG's, bit for bit through [-1, 1] and back
    from ddpm_diffusion_model_tpu_torch.utils.images import load_image

    sent = load_image(io.BytesIO(base64.b64decode(_b64_png(img))), size=RES)
    keep = np.ones((RES, RES), bool)
    keep[2:6, 2:6] = False
    np.testing.assert_allclose(y[:, keep], np.broadcast_to(sent[keep], (2, *sent[keep].shape)),
                               atol=1e-6)
    assert np.abs(y[:, ~keep] - sent[~keep]).max() > 1e-3
    mask = np.ones((RES, RES, 1), np.float32)
    mask[:, :4] = 0.0
    code, _h, body = _post(base + "/edit", {"image": _b64_png(img), "mode": "inpaint",
                                            "mask": _b64_png(mask, mode="L"), "n": 1,
                                            "steps": 2, "format": "png"})
    assert code == 200 and body[:4] == b"\x89PNG"
    assert svc.metrics()["edits"] == before + 3


def test_edit_snaps_and_caps_as_jax(served):
    """Strength snaps to 0.05 in (0, 1], resamples cap at 4, n at MAX_N,
    steps snap to STEP_CHOICES, eta clamps to [0, 1]."""
    svc, _base = served
    img = _face()
    x, used = svc.edit(img, mode="img2img", n=100, steps=3, strength=0.62, eta=-2.0)
    assert x.shape == (svc.MAX_N, RES, RES, 3)
    assert used == {"mode": "img2img", "n": svc.MAX_N, "steps": 2, "eta": 0.0, "seed": 0,
                    "strength": pytest.approx(0.6)}
    _x, used = svc.edit(img, mode="img2img", n=1, steps=1, strength=0.0001, eta=3.0)
    assert used["strength"] == pytest.approx(0.05) and used["eta"] == 1.0
    _x, used = svc.edit(img, mode="img2img", n=1, steps=1, strength=7.0)
    assert used["strength"] == 1.0
    _x, used = svc.edit(img, mode="inpaint", n=1, steps=1, box=(0, 0, 4, 4), resamples=9)
    assert used["resamples"] == svc.MAX_RESAMPLES
    _x, used = svc.edit(img, mode="inpaint", n=1, steps=1, box=(0, 0, 4, 4), resamples=-3)
    assert used["resamples"] == 1
    a, _ = svc.edit(img, mode="img2img", n=2, steps=2, seed=4)
    b, _ = svc.edit(img, mode="img2img", n=2, steps=2, seed=4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("body,needle", [
    ({"mode": "inpaint", "box": [4, 4, 2, 8]}, "out of bounds"),
    ({"mode": "inpaint", "box": [0, 0, 99, 4]}, "out of bounds"),
    ({"mode": "inpaint", "box": 5}, "box must be 4 ints"),
    ({"mode": "inpaint"}, "exactly one of 'box' or 'mask'"),
    ({"mode": "inpaint", "box": [0, 0, 4, 4], "mask": "MASK"}, "exactly one of"),
    ({"mode": "outpaint"}, "mode must be"),
    ({"strength": "nan"}, "must be finite"),
    ({"eta": "inf"}, "must be finite"),
    ({"guidance": 3.0}, NEEDS_CLASSES),
    ({"image": None}, "bad request"),
    ({"image": "not-base64-png"}, "bad request"),
    ({"n": "many"}, "bad request"),
], ids=["box_order", "box_bounds", "box_type", "neither", "both", "mode", "strength_nan",
        "eta_inf", "guidance", "no_image", "bad_image", "bad_n"])
def test_bad_edit_requests_are_400(served, body, needle):
    svc, base = served
    req = {"image": _b64_png(_face()), "steps": 1, "n": 1}
    req.update(body)
    if req.get("mask") == "MASK":
        req["mask"] = _b64_png(np.ones((RES, RES, 1)), mode="L")
    if req.get("image") is None:
        del req["image"]
    before = svc.metrics()["client_errors"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/edit", req)
    assert ei.value.code == 400
    assert needle in json.loads(ei.value.read())["error"]
    assert svc.metrics()["client_errors"] == before + 1


def test_edit_checks_the_image_shape(served):
    svc, _base = served
    with pytest.raises(ValueError, match=r"image must be \(8, 8, 3\)"):
        svc.edit(np.zeros((RES, RES + 1, 3)), mode="img2img")
    with pytest.raises(ValueError, match="mask must be"):
        svc.edit(_face(), mode="inpaint", mask01=np.ones((4, 4, 1)))


def test_metrics(served):
    svc, base = served
    _npy(base, n=1, steps=1, seed=1)
    m = json.loads(_get(base + "/metrics")[2])
    assert m["requests"] >= 1 and m["samples"] >= 1 and m["errors"] == 0
    assert m["coalesced_batches"] >= 1 and "latency_p50_s" in m
    assert m["kernel_launches"] == {"gn_silu_fwd": 0, "flash_attn_fwd": 0}  # CPU
    assert m["device"] == "cpu"


def test_main_serves_a_checkpoint_and_drains(tmp_path):
    torch.manual_seed(0)
    model = UNetDenoiser(CFG, dtype=torch.float32, device="cpu")
    sd = model.state_dict()
    pt = str(tmp_path / "tiny.pt")
    torch.save({"model": sd, "ema": {"decay": 0.999, "shadow": list(sd.values())},
                "step": 3, "extra": {"experiment": {
                    "model": CFG.to_dict(),
                    "diffusion": DiffusionConfig(T=20, img_size=RES).to_dict(),
                    "img_size": RES}}}, pt)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ddpm_diffusion_model_tpu_torch.serving",
         "--ckpt", pt, "--device", "cpu", "--port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "[SERVE] sampling service on http://" in line, line
        base = line.split("on ")[1].split()[0]
        assert json.loads(_get(base + "/healthz")[2])["img_size"] == RES
        x = _npy(base, n=2, steps=1, seed=0)
        assert x.shape == (2, RES, RES, 3)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
        assert proc.returncode == 0, rest
        assert "[SERVE] draining" in rest and "[SERVE] stopped" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ------------------------------------------------ a class-conditional checkpoint

NC = 3
# width 64: two channels per GroupNorm group, so the time (and class) bias
# survives the normalization (with one channel per group it cancels)
CFG_COND = dataclasses.replace(CFG, base_channels=64, num_classes=NC)


@pytest.fixture(scope="module")
def served_cond():
    torch.manual_seed(1)
    model = UNetDenoiser(CFG_COND, dtype=torch.float32, device="cpu")
    svc = SamplerService(model, make_schedule(DiffusionConfig(T=20, img_size=RES),
                                              device="cpu"), RES, device="cpu")
    svc.COALESCE_WINDOW_S = 0.2
    srv = make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield svc, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def test_conditional_healthz_and_used(served_cond):
    svc, base = served_cond
    assert json.loads(_get(base + "/healthz")[2])["num_classes"] == NC
    x, used = svc.sample(n=2, steps=2, seed=3, class_id=1, guidance=2.1)
    assert used["class_id"] == 1 and used["guidance"] == 2.0  # snapped to 0.25
    assert x.shape == (2, RES, RES, 3) and 0.0 <= x.min() and x.max() <= 1.0
    _x, used = svc.sample(n=1, steps=1, seed=3)
    assert used["class_id"] is None and used["guidance"] == 1.0
    code, hdr, _b = _get(base + "/sample?n=2&steps=2&seed=3&class_id=1&guidance=2.1")
    assert code == 200 and hdr["X-Used-N"] == "2"
    np.testing.assert_array_equal(_npy(base, n=2, steps=2, seed=3, class_id=1, guidance=2.1),
                                  x)


@pytest.mark.parametrize("query,needle", [
    ("class_id=3", "out of range [0, 3)"),
    ("class_id=-1", "out of range"),
    ("guidance=nan&class_id=0", "guidance must be finite"),
    pytest.param("sampler=cm&class_id=0", CM_ONLY, id="sampler=cm&class_id=0-not ported yet"),
])
def test_conditional_bad_requests_are_400(served_cond, query, needle):
    _svc, base = served_cond
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"{base}/sample?{query}")
    assert ei.value.code == 400 and needle in ei.value.read().decode()


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
def test_classes_share_a_batch_per_row_and_guidance_keys_it(served_cond, sampler):
    """Two classes at one guidance ride one batch, each row with its own
    label and equal to its solo re-run; two guidances never share one."""
    svc, base = served_cond
    q = dict(n=2, steps=2, sampler=sampler)
    solo = {c: _npy(base, seed=10 + c, class_id=c, guidance=3, **q) for c in (0, 2)}
    m0 = svc.metrics()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        futs = {c: ex.submit(_npy, base, seed=10 + c, class_id=c, guidance=3, **q)
                for c in (0, 2)}
        merged = {c: f.result() for c, f in futs.items()}
    m1 = svc.metrics()
    assert (m1["coalesced_batches"] - m0["coalesced_batches"],
            m1["multi_request_batches"] - m0["multi_request_batches"]) == (1, 1)
    for c in (0, 2):
        np.testing.assert_allclose(merged[c], solo[c], atol=1e-4)
    # the class decides the image: seed 10 under class 2 is not seed 10 under 0
    assert np.abs(_npy(base, seed=10, class_id=2, guidance=3, **q) - solo[0]).max() > 1e-3
    m1 = svc.metrics()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        f2 = ex.submit(_npy, base, seed=10, class_id=0, guidance=2, **q)
        f3 = ex.submit(_npy, base, seed=10, class_id=0, guidance=3, **q)
        g2, g3 = f2.result(), f3.result()
    m2 = svc.metrics()
    assert (m2["coalesced_batches"] - m1["coalesced_batches"],
            m2["multi_request_batches"] - m1["multi_request_batches"]) == (2, 0)
    np.testing.assert_allclose(g3, solo[0], atol=1e-4)
    assert np.abs(g2 - g3).max() > 1e-3


def test_a_request_without_a_class_rides_as_the_null_token(served_cond):
    """On a conditional checkpoint a request with no class is the NULL
    label's, on which guidance collapses to the unconditional forward."""
    svc, base = served_cond
    plain = _npy(base, n=2, steps=2, seed=7)
    guided = _npy(base, n=2, steps=2, seed=7, guidance=3)
    np.testing.assert_allclose(guided, plain, atol=1e-5)
    direct, used = svc.sample(n=2, steps=2, seed=7, eta=0.5, class_id=2, guidance=2.0)
    again, _ = svc.sample(n=2, steps=2, seed=7, eta=0.5, class_id=2, guidance=2.0)
    np.testing.assert_array_equal(direct, again)  # eta > 0: per seed, not coalesced
    assert used["class_id"] == 2 and used["eta"] == 0.5


def test_edit_with_a_class(served_cond):
    svc, base = served_cond
    img = _b64_png(_face())
    out = {}
    for c in (0, 2):
        code, hdr, body = _post(base + "/edit", {"image": img, "mode": "img2img", "n": 2,
                                                 "steps": 5, "seed": 4, "class_id": c,
                                                 "guidance": 3.0, "format": "npy"})
        out[c] = np.load(io.BytesIO(body))
        assert code == 200 and hdr["X-Used-N"] == "2" and out[c].shape == (2, RES, RES, 3)
    assert np.abs(out[0] - out[2]).max() > 1e-3
    x, used = svc.edit(_face(), mode="inpaint", n=1, steps=5, box=[2, 2, 6, 6],
                       class_id=1, guidance=2.2)
    assert used["class_id"] == 1 and used["guidance"] == 2.25 and x.shape == (1, RES, RES, 3)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(base + "/edit", {"image": img, "class_id": NC})
    assert ei.value.code == 400 and "out of range" in ei.value.read().decode()
