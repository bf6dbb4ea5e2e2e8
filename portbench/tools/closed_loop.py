"""The sampling service under a closed loop of client threads, outside the
benchmark's cells: ``SamplerService.sample`` (the method ``/sample`` calls;
DDIM-50, eta 0, ``t_linear``) over the seeded ``celeba64_attn`` model,
every row count warmed, each client sending its next request when its last
comes back, n uniform over {1, 2, 4, 8, 16} from client c's
``default_rng([seed, c])``.  Prints one JSON line: images/s of the
requests back inside the window, p50/p95 latency, coalesced batches, rows
and the service's histogram of requests per batch.  Two runs of one seed
show how far the coalescer's grouping moves the service from run to run.

    python3 portbench/tools/closed_loop.py --seed 8100000001 --seconds 30 [--clients 8]
"""
import argparse
import json
import sys
import threading
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness.runtime import RunContext, SetupClock, build_program  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402


def main(seed: int, seconds: float, clients: int) -> None:
    rc = RunContext(config=Spec().config("celeba64_attn"), mix={}, seed=seed, seconds=seconds,
                    trace=False, spans=[], chips=1, clock=SetupClock(T0),
                    device=torch.device("cuda"))
    exp, model, sched = build_program(rc)
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService
    svc = SamplerService(model, sched, exp.img_size, device=rc.device, use_mesh=False)
    kw = dict(steps=50, eta=0.0, sampler="ddim", schedule_kind="t_linear")
    x = torch.randn((svc.MAX_N, exp.img_size, exp.img_size, 3), device=rc.device)
    t = torch.full((svc.MAX_N,), 999, dtype=torch.long, device=rc.device)
    with torch.inference_mode():
        for rows in range(1, svc.MAX_N + 1):
            svc.model(x[:rows], t[:rows])
    svc.sample(n=1, seed=0, **kw)
    torch.cuda.synchronize()
    setup = time.perf_counter() - T0
    before = svc.metrics()
    lat, imgs, lock = [], [0], threading.Lock()
    end = time.perf_counter() + seconds

    def client(c):
        rng = np.random.default_rng([seed, c])
        while time.perf_counter() < end:
            n = int(rng.choice([1, 2, 4, 8, 16]))
            s = int(rng.integers(0, 2**31 - 1))
            a = time.perf_counter()
            svc.sample(n=n, seed=s, **kw)
            b = time.perf_counter()
            with lock:
                lat.append(b - a)
                if b <= end:
                    imgs[0] += n

    ths = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    after = svc.metrics()
    q = np.quantile(np.array(lat), [0.5, 0.95])
    hist = {k: v - before["batch_size_hist"].get(k, 0)
            for k, v in after["batch_size_hist"].items()}
    print(json.dumps({"seed": seed, "images_per_s": imgs[0] / seconds, "requests": len(lat),
                      "p50_s": float(q[0]), "p95_s": float(q[1]),
                      "batches": after["coalesced_batches"] - before["coalesced_batches"],
                      "rows": after["samples"] - before["samples"],
                      "hist": {k: v for k, v in sorted(hist.items()) if v},
                      "setup_s": setup}), flush=True)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--clients", type=int, default=8)
    a = p.parse_args()
    main(a.seed, a.seconds, a.clients)
