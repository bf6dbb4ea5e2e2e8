"""The port's sampling service on the CPU: health, PNG/npy sampling, the
eta=0 coalescer (coalesced rows equal the solo run), eta>0, the 400s for
bad and not-yet-ported requests, metrics, and ``main``'s graceful drain."""

import concurrent.futures
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
    assert data["num_classes"] == 0 and data["edit_modes"] == []
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


@pytest.mark.parametrize("query,needle", [
    ("schedule=bogus", "schedule must be one of"),
    ("n=abc", "invalid literal"),
    ("sampler=dpmpp", "not ported yet"),
    ("sampler=cm", "not ported yet"),
    ("sampler=euler", "sampler must be"),
    ("class_id=3", "not ported yet"),
    ("guidance=2.0", "not ported yet"),
    ("guidance=1.2", "not ported yet"),  # snaps to 1.25
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
    _svc, base = served
    req = urllib.request.Request(base + path, data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400 and "not ported yet" in ei.value.read().decode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(base + "/nowhere")
    assert ei.value.code == 404


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
