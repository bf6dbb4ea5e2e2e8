#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``ddpm_diffusion_model_tpu_torch`` only (no JAX, nothing of the JAX
package), in phases; any failure exits non-zero before the final line.

1. device     needs CUDA; prints the card's name and power limit
2. build      compiles every kernel under csrc/ with nvcc (one process per
              source, in parallel) and prints ptxas register/spill lines
3. kernels    each kernel against its plain PyTorch version on the card, at
              every shape the two main paths give it (recorded from a
              forward of the full-width U-Net at batch 16 and from a train
              step's forward and backward at batch 128), bf16 and fp32, with
              and without the time bias, plus a large-mean GroupNorm input
              and a ragged attention length (N = 100) at head dims 64, 32,
              40 and 128; every bf16 flash forward, dQ and dK/dV call must
              reach the tensor-core kernel and every fp32 one the FMA
              kernel; the GN forward and backward at C = 96, a large mean,
              odd C and unaligned operands too, on the route their plans
              name, and bit-equal on a second identical call; the GN forward
              at mean 1000 at 64x64x384 on both routes and on every plan
              (cluster 1-16, resident and re-read) at one shape; the plain
              backward versions once against float64 autograd of the plain
              forwards
4. unet       celeba64_attn at full width (31,312,131 params, seeded random
              weights): one forward on the kernels and one on the plain
              versions, on the card
5. serving    the port's HTTP server over a reference-format .pt of those
              weights: /healthz, two concurrent eta=0 requests that must
              coalesce and equal their solo re-runs, one eta=0.5 request,
              /metrics; the kernels' launch counts must be 45 and 5 per
              U-Net forward (the GN forward's 25 at batch 16 and 33 at 8
              with the chunk resident in shared memory, the rest re-read),
              the 5 on the tensor-core flash forward
6. train      celeba64_attn with its preset TrainConfig at batch 128 on the
              port's synthetic blob faces: (a) from the same weights and
              injected (t, noise), dropout off, one step on the kernels and
              one on the plain versions, fp32 and bf16 (loss, grads, grad
              norm, updated params), the fp32 step on the FMA flash kernels
              and the bf16 step on the tensor-core ones; (b) train_one_epoch
              for 20 steps with dropout on, launches exactly 45/45/5/5/5 per
              step (the GN forward's 45 re-reading their chunk; 22 of the
              GN backward launches with the time-bias gradient, 13 keeping
              their chunk in shared memory and 32 re-reading it, as the
              plans say; the flash forward's, dQ's and
              dK/dV's 5 all on the tensor cores, none on FMA; the update's
              one adamw pass after its one grad_norm pass, and its one
              ema_lerp pass); (c) the
              step's wall and device time, idle share, top kernels and
              peak memory
6b. update    the update's tail at the MoE cell's 1,046,066,704 params
              (DiT-MoE-XL/2, one 7-block stage), without and with the clip:
              the kernels' params, moments and shadow bit-equal to the
              plain multi-tensor sequence's from one start, the norm within
              1e-6; their device ms against the 40 / 44 B-a-param bound,
              the plain sequence's and the library's fused AdamW with a
              multi-tensor lerp; launches adamw/grad_norm/ema_lerp 1/0/1
              and 1/1/1
7. run        train_ddpm on celeba64_attn at batch 128, bf16, the preset's
              TrainConfig, 3 epochs of 4 batches with the eval pass, a DDIM
              grid (n = 16) and a checkpoint per epoch: (a) uninterrupted;
              (b) stopped by a PreemptionFlag after epoch 1's first batch;
              (c) resume_path="auto" from (b)'s _preempt save, which must
              equal (a) bit for bit (cuDNN deterministic); exact launches of
              (a); the checkpoints on disk, one save's dispatch and durable
              times and its size
8. sample     from (a)'s _last checkpoint (EMA weights): ddpm_infer_sample
              over the full T = 1000 ladder and ddim_infer_sample at n = 16,
              both denoise strips; each PNG against grid_nrow/make_grid,
              seconds per grid, forwards per second, launches
8b. solvers   from the same checkpoint (EMA weights), batch 16: the
              decoder-only forward's kernel calls against their plain
              versions (bf16 and fp32) and the whole decode forward on the
              kernels against the plain versions, decode of a forward's own
              features equal to it, decode and full forward wall and device
              times; DPM-Solver++(2M) 20 steps, ODE and SDE (19 forwards,
              855/95 launches each); encoder-cached DDIM-50 at
              refresh_every=2 (25 full + 24 decode forwards, 1,725/125)
              against plain DDIM-50 (2,205/245) from the same x_T, both walls
              and device times and the max |diff| in [0, 1] pixels (bar
              0.25); img2img at strength 0.6 (29 forwards) and inpaint with a
              box at resamples=2 (98 forwards, the known region bit-equal to
              the input); through make_server two concurrent sampler=dpmpp
              requests in one batch, each equal to its solo re-run, a DDIM
              and a DPM request never batched together, POST /edit img2img
              and inpaint 200 with X-Used-* and a bad box 400; the CLI's
              sample-dpmpp [--sde], img2img, inpaint --box and sample-ddim
              --refresh-every 2 (exit 0, PNGs as make_grid gives); every
              path's launches exact and on the GN plans' routes
9. remat      one celeba64_attn step at batch 128, dropout 0.1, with remat
              False, True and "masks" from the same seed: updated params,
              grad norm, loss and generator bit-equal; launches as the
              config gives them (45 + 44 GN forwards under True); peak memory
10. hq256     celebahq256 at full width (63,100,675 params) with remat=True
              and its TrainConfig (batch 64 = 8 micro-batches of 8): every
              kernel call of one micro-batch against its plain version in
              bf16 and fp32 with each GN call's route; 3 train steps (wall,
              device time, idle share, launches per step, top kernels);
              a micro-batch's peak memory with remat below no remat's
11. data      the data pipeline and the CLI on celeba64_attn at full width:
              (a) 8,192 blob faces as JPEGs (quality 95) and 64 PNGs at
              CelebA's aligned 178x218, zipped; (b) the zip loader's
              decoder route (native or PIL), native against PIL within
              tests/test_native.py's bars where native builds, decode
              images/s by route at 8 and os.cpu_count() workers; (c) ``cli
              train --data zip`` at batch 128, bf16, 3 epochs of 10 steps,
              from the host loader and with --device-cache: images/s by
              epoch beside phase 6c's, exact launches 45/45/5/5/5 per step;
              (d) the device cache at CelebA's train split (162,770 images,
              2.000 GB of uint8): upload seconds and GB/s, the corpus bytes,
              one epoch's 1,271 gathers, its order = DataLoader's and a
              batch bit-equal to the host path; (e) device_prefetch: 64
              batches bit-equal to the synchronous copy, the step's wall
              with and without it; (f) ``cli sample-ddim``, ``strip``,
              ``sample-ddpm``, ``eval`` (128 images) from (c)'s checkpoint
              (PNG shapes, eval's keys, a finite rFID) and ``info`` equal to the JAX
              package's (tests/jax_info_celeba64_attn.json)
12. times     each kernel's device time per train step and per serving
              U-Net forward (and per celebahq256 step) beside its bound,
              its plain version and the PyTorch yardstick (timed here
              only), request latency and forwards per second; the GN
              backward at its largest train-step shape and the GN forward
              at 64x64x384 and 64x64x128 (batch 128) on every cluster size
              and route beside the plan's pick
13. cfg       (run after data, before times) celeba64_attn with 10 classes
              (31,317,763 params; the ExperimentConfig JSON a user passes with
              --config): (a) the conditional forward (labels 0-9 and NULL)
              and the guided eps (guidance 3, n = 16: ONE forward of 32 rows)
              on the kernels against the plain versions in fp32 and bf16,
              every kernel call of the guided forward against its plain
              version on its GN plan's route (23 of 45 in shared memory at 32
              rows), its launches 45/5, guided and unguided wall and device
              time; (b) one conditional step at batch 128 on injected (t,
              noise, drop) against the plain versions (loss, grads, the
              class table's grad, grad norm, updated params), every kernel
              call of the step, 20 steps of train_one_epoch at 45/45/5/5/5
              per step with the step's wall, device time and idle share;
              (c) ``cli train --config cond.json --data blobs --device-cache``
              for 2 epochs of 3 steps (the second resumed) with the eval pass
              and the class-cycled DDPM grid, launches exact, its _last
              rebuilding num_classes 10; (d) from that checkpoint (EMA), n =
              16 at guidance 1 and 3: DDIM-50, DPM-20 ODE and SDE, img2img,
              inpaint x2, launches equal at both guidances (one forward of 2n
              rows each), and the DDPM grid at class_id "all"; the
              conditional bound (``vlb_bits_per_dim_mc``, fp32, injected t
              and noise) on the kernels against the plain versions and a
              CPU copy; (e) through make_server two classes at one guidance
              in one batch (each equal to its re-run beside another request
              at the same rows, and far from the pair with the labels
              swapped), two guidances never together, POST
              /edit with a class, class_id 10 -> 400, /healthz num_classes;
              (f) ``cli sample-ddim --class-id all --guidance 3``,
              ``sample-dpmpp --class-id 2``, ``img2img --class-id 1``, ``eval
              --nll 50 --nll-n 16`` and ``eval --nll-full --nll-n 8`` (T =
              1000 forwards), bits/dim finite and positive
14. sr        (run after cfg, before times) the super-resolution cascade on
              sr64to256 at full width (63,104,131 params: celebahq256 with
              a 6-channel stem; remat, batch 64 = 8 x 8, superres_factor 4,
              cond_aug 0.1): (a) degrade and upsample_cond on the card
              against the CPU (1e-5, float32); one forward at batch 4 with
              x_cond, every kernel call against its plain version on its GN
              plan's route, the whole forward fp32 and bf16 at phase 4's
              bars, launches exact and equal to a celebahq256 forward's; the
              stem conv's device time at 6 channels beside 3; (b) one SR
              step on injected (t, noise, sigma, cond noise) on the kernels
              against the plain versions in fp32 at phase 6a's bars, the
              stem's cond slice learning; every kernel call of a
              micro-batch; 3 bf16 steps at exactly celebahq256's launches per
              step (872/440/24/24/24), wall, device, idle, top kernels; a
              micro-batch's peak memory within 5% of celebahq256's; (c) ``cli
              train --preset sr64to256 --data zip --no-crop`` from a zip of
              128 256-px JPEGs, 2 epochs of 2 steps (the second resumed) with
              the upsampled anchor grid, launches exact, its _last
              rebuilding cond_channels 3; ``info`` equal to the JAX
              package's (tests/jax_info_sr64to256.json); (d) ``cli
              upsample`` (n = 4, DDIM-50) and ``cli cascade`` (a 10-class
              celeba64_attn base from seeded weights, class 2, guidance 3)
              from that checkpoint (EMA), launches exact, the grids' device
              time, and upsample_from_init on the kernels against the plain
              versions in fp32 (max |diff| 1e-3 in [0, 1] pixels); (e)
              through make_server: /healthz upsampler, POST /upsample 200
              with X-Used-* and exact launches, /sample 400, a 300-px image
              400, /metrics upsamples
15. distill   (run after sr, before times) progressive and consistency
              distillation on celeba64_attn with 10 classes at full width
              (31,317,763 params, seeded, saved as a port checkpoint: the
              teacher), guidance 3 baked in, batch 128, bf16: (a) every
              kernel call of one guided progressive update (the teacher's
              two half-steps, each ONE forward of 256 rows, then the
              student's forward and backward at 128) and of one consistency
              update (one teacher forward at 256 rows, the EMA target's and
              the student's at 128) against its plain version in bf16 and
              fp32 on its GN plan's route; one whole update of each kind on
              injected draws, kernels against plain in fp32 at phase 6a's
              bars; each forward kernel's time at the guided teacher's 256
              rows beside its bound; (b) progressive_distill 64 -> 32 -> 16
              and consistency_distill on a 32-segment ladder, launches exact
              per update (3 forwards: 135 GN and 15 flash; the backward's
              45/5/5), peak memory, an update's wall, device time and idle
              share; (c) ``cli distill`` both modes from the teacher's
              checkpoint (blob faces in 10 class hues, device cache), ``cli
              sample-ddim --schedule linear --steps 2 --class-id all`` on the
              progressive student, ``cli sample-cm --steps 1`` and ``--steps
              2 --class-id 2`` on the consistency student (exit 0, launches
              exact, PNGs as make_grid gives); (d) the service over a
              directory ``cli train`` wrote equal to ddim_infer_sample from
              the same seed, and over the consistency student: /healthz, two
              sampler=cm requests in one batch, each equal to its re-run
              beside another request at the same rows and beside its solo
              re-run (reported), steps=2, sampler=ddim and /edit 400
16. dit       (run after distill, before times) the DiT family at full width:
              celeba64_dit_s4 (32,499,120 params) and celeba64_dit_moe
              (131,787,792; 8 experts, switch top-1) on their preset
              TrainConfigs, and dit_s4_256_config (N = 4,096 tokens) at batch
              8, seeded, the adaLN heads and final_proj perturbed off zero:
              (a) every flash call of a forward at 16 and a step at 128
              (N = 256), and of a forward and step at batch 8 (N = 4096),
              against its plain version in bf16 (tensor cores) and fp32
              (FMA), the plain versions on all 48 heads; each flash kernel's
              device time at N = 4096 beside its bound, SDPA's forward or
              autograd backward, its plain version and its fp32 (FMA) time;
              (b) per preset one forward at 16 on the kernels against the
              plain versions (phase 4's bars; launches 0 GN, 12 flash; for the
              MoE each layer's expert loads and dropped share, fp32 routing
              equal but for near-ties) and one step on injected (t, noise)
              at phase 6a's bars (the MoE's aux and router grad included;
              the key biases' grad 0 up to rounding); (c) train_one_epoch per
              preset (5 steps at 128) and for dit_s4_256 (2 at 8): 0/0/12/
              12/12 launches a step, wall, device, idle, top kernels, peak;
              remat True against none at 256 px bit-equal, both peaks; (d)
              ``cli train --preset celeba64_dit_s4`` (2 steps), ``sample-ddim
              --steps 50 --n 16`` and ``sample-dpmpp`` on its checkpoint
              (launches exact, PNGs as make_grid gives), ``--refresh-every 2``
              refused with the JAX CLI's message; the service over that
              directory: /healthz family dit, /sample equal to
              ddim_infer_sample from the same seed, /metrics 0 / 12 launches
              a forward, two concurrent requests coalesced
17. latent    (run after dit, before times) the latent-diffusion family at
              full width, seeded, bf16, on blob faces: vae_64x_config
              (7,056,331 params; GN affines perturbed) at train-vae's batch
              64 and the celeba64_latent U-Net (22,061,316) at batch 128 on
              256 faces encoded through it (encode_corpus, 13 GN launches a
              batch): (a) every kernel call of a VAE step (26 GN forwards
              and 26 backwards, no time bias, C = 64 at two channels a
              group) and of a latent U-Net step (35 / 35, 17 with the time
              bias, 2 of each flash kernel at (512, 64, 64)) and forward at
              16 against its plain version in bf16 and fp32 on its plan's
              route; each GN kernel's device time per VAE step beside its
              bound, its plain version and F.group_norm + F.silu with its
              autograd backward; (b) the VAE's full pass at phase 4's bars;
              one VAE step on injected eps and one latent U-Net step on
              injected (t, noise), fp32 and bf16, at phase 6a's bars,
              launches exact; (c) each command in a fresh process, its
              launches read there: ``cli train-vae`` (2 steps), ``cli train
              --preset celeba64_latent --latent-vae`` (256 faces encoded, 2
              steps), ``sample-ddim --vae --n 16 --steps 50``,
              ``sample-dpmpp --vae`` and ``sample-ddpm --vae`` on its
              checkpoint (EMA): launches exact by route, PNGs as make_grid
              gives, the meta's scale the printed one; latent_sample (fp32,
              DDIM-50) on the kernels within 1e-3 in [0, 1] pixels of the
              plain versions from the same draws; (d) the VAE step's and
              the latent U-Net step's wall, device time, idle share, top
              kernels and peak memory, seconds per decoded grid (bf16
              DDIM-50, n = 16) and the decode's device time
18. parallel  (run after latent, before times) data, fully-sharded and
              context parallelism on one card (worlds above 1 are held on
              the CPU by the tests, in gloo ranks): (a) the ring's
              hop code over S = 2, 4, 8 blocks in one process at
              dit_s4_256_config's attention (48, 4096, 64), bf16 and fp32:
              O, LSE, dQ, dK, dV against one flash call and the plain
              versions at phase 3's bars, S^2 launches of each
              kernel, each hop's device time and the whole ring's beside
              the one call and its bound; (c) fresh processes: ``cli train
              --preset celeba64_attn --mesh dp`` under ``torchrun
              --nproc_per_node 1`` bit-equal to the run without a mesh,
              ``--mesh fsdp`` within 1e-2 of the steps' move,
              ``--mesh dp --device-cache-sharded``, ``train-vae --mesh dp``
              and ``sample-ddim --sharded`` (n = 16), launches exact; (b) a
              world-1 NCCL group in this process: ``ring_attention_sharded``
              bit-equal to ``flash_attention`` (forward and grads),
              dit_s4_256 at batch 8 with attn_impl="ring" under
              ``context_parallel_mesh`` bit-equal to "auto" (forward, one
              step at 0 / 0 / 12 / 12 / 12 launches), the celeba64_attn
              step's wall and device time with the state placed over the
              mesh and without, and (c)'s grid sampled here within one
              8-bit level of the torchrun PNG
19. model_parallel (run after parallel, before times) tensor, expert and
              pipeline parallelism at full width on one card, in their
              virtual forms (one process runs every rank's rank-local code
              in turn, the collectives as list sums, concatenations and
              rotations): (a) TP, celeba64_attn's forward at 16 (R = 2, 4)
              and step at 128 (R = 2, 4), celeba64_dit_s4's step at 128 (R =
              2, 3, 6), fp32 and bf16, against the unsharded model on the
              plain versions at phases 4 and 6a's bars; each TP'd attention
              R calls of each flash kernel at (B * H / R, N, 64), every such
              call against its plain version at phase 3's bars and, at N =
              256, its device time beside its bound, its plain version and
              SDPA; (b) EP, celeba64_dit_moe's forward at 16 and step at 128
              (R = 2, 4, 8): output, aux and routing against the unsharded
              MoE (near-ties apart); (c) PP, celeba64_dit_s4 through
              PipelinedDiT (S = 2, 3, 4; M = S, 2S) at 128, the forward and
              one step through the unmodified make_train_step, a DDIM-50
              grid of 16 within 1e-3 in [0, 1] pixels of the plain grid,
              and the bubble from measured stage times against (S - 1) / (M
              + S - 1); device ms of a TP, EP and PP step against the
              unsharded one; (d) a world-1 NCCL group: placed steps on
              ('data', X) = (1, 1) meshes, X = model, expert, pp, bit-equal
              to the plain step; (e) ``python -m ...serving`` under
              ``torchrun --nproc_per_node 1``: /sample equal to the
              in-process service within 1e-5, /metrics' mesh null, SIGTERM
              drains
20. utils     (run after model_parallel, before times) the last utilities
              on celeba64_attn at full width from the seeded weights: (a)
              a checkpoint directory (EMA with its GroupNorm scales x 1.5,
              step 1234) through ``cli export-torch`` and ``cli
              import-torch``, ``load_run`` of the import bit-equal to it
              (params, EMA, step, schedule clock) and a second export equal
              to the first; ``python -m ...serving --ckpt x.pt --config
              exp.json`` where x.pt's extra names celeba64_low: /sample
              (n = 16, DDIM-50, eta 0) within 1e-5 of ddim_infer_sample
              from the same seed, /metrics 2,205 GN+SiLU and 245 flash
              forward launches; (b) ``profiler_trace`` of one bf16 forward
              at 16: exactly 45 and 5 kernel events in the trace; (c) a
              bf16 step at batch 8 under ``nan_debugging`` (finite params
              and grads, 45 / 45 / 5 / 5 / 5 launches), then a NaN in the
              head's GroupNorm scale after the forward: the backward
              raises naming the GN kernel's autograd.Function; (d) the MFU
              (``utils/flops.py``) of phase 6c's and phase 16's DiT-S/4
              steps from their device and wall ms, each below 100%; (e)
              ``sample_statistics`` of the served grid, ``model_summary``'s
              total

Before the final line it prints one ``{"kernels": [...]}`` JSON line and the
``nvidia-smi`` name/power-limit line; the final line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Device times come from ``torch.profiler`` (CUPTI) traces.  When CUPTI hands
back no device events, ``device_ms`` times the calls by CUDA events queued
behind a busy device (device time, no launch gap), else by CUDA events with
the launch gaps in (not device time: never for a number of the kernels
line, whose timings raise instead; the fallback is held against the
profiler on a matmul at the start, ``queued_events_probe``).  Each time
says its source
(``ms_source`` in the kernels line's rows, ``device_ms_source`` beside each
step's or grid's device time, whose idle share is then null), and the
JSON line lists every time not from a trace under ``not_profiled``.
``--only kernels,run,...`` runs the build and the named phases only, and
prints no result line (for trying a change on the card); ``--only cfg``,
``--only sr``, ``--only distill``, ``--only dit``, ``--only latent``, ``--only
parallel``, ``--only model_parallel`` and ``--only utils`` need no other phase
(``utils`` then reports no MFU: phases 6c and 16 time the steps).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "ddpm_diffusion_model_tpu_torch"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: bf16 is the port's PEAK_TFLOPS["h100"] (utils/flops.py), set by main(), so
#: the kernels' bounds and the MFU share one peak
PEAK_FLOPS = {"bfloat16": None, "float32": 67e12}

GN_LAUNCHES_PER_FORWARD = 45
FLASH_LAUNCHES_PER_FORWARD = 5
GN_DTB_LAUNCHES_PER_STEP = 22  # the norm2 of every ResBlock carries the time bias
# GN backward launches per bf16 step by route, from _gn_bwd_plan over the
# step's 45 shapes: the 13 at 8x8x256 keep their chunk in shared memory
GN_BWD_SMEM_PER_STEP = 13
GN_BWD_REREAD_PER_STEP = GN_LAUNCHES_PER_FORWARD - GN_BWD_SMEM_PER_STEP
BATCH = 16
TRAIN_BATCH = 128
TRAIN_STEPS = 20
# GN forward launches per bf16 U-Net forward that keep their chunk in shared
# memory, by batch, from _gn_fwd_plan over the forward's 45 shapes (the
# rest re-read it): none at the train batch; at the serving batches
# (coalesced 16, solo 8) the shapes whose grid fills at most half the SMs;
# at 32, a guided forward of 16 (the conditional and the NULL branch); at
# 256, a distillation teacher's guided forward of the train batch
GN_FWD_SMEM_PER_FORWARD = {2 * TRAIN_BATCH: 0, TRAIN_BATCH: 0, 2 * BATCH: 23, BATCH: 25,
                           BATCH // 2: 33}

KERNELS = ("gn_silu_fwd", "gn_silu_bwd", "flash_attn_fwd", "flash_attn_bwd_dq",
           "flash_attn_bwd_dkv")
#: launches of the update's kernels in one train step with the clip on (the
#: presets' grad_clip 1.0): the read-only norm pass, the one pass over the
#: optimizer state, the EMA's pass
UPDATE_LAUNCHES_PER_STEP = {"adamw": 1, "adamw.fused": 1, "grad_norm": 1, "grad_norm.fused": 1,
                            "ema_lerp": 1, "ema_lerp.fused": 1}
#: launches of each kernel in one train step (one forward and its backward),
#: in all and by route (``read_counts``)
LAUNCHES_PER_STEP = {"gn_silu_fwd": GN_LAUNCHES_PER_FORWARD,
                     "gn_silu_fwd.smem": GN_FWD_SMEM_PER_FORWARD[TRAIN_BATCH],
                     "gn_silu_fwd.reread": (GN_LAUNCHES_PER_FORWARD
                                            - GN_FWD_SMEM_PER_FORWARD[TRAIN_BATCH]),
                     "gn_silu_bwd": GN_LAUNCHES_PER_FORWARD,
                     "gn_silu_bwd_dtb": GN_DTB_LAUNCHES_PER_STEP,
                     "gn_silu_bwd.smem": GN_BWD_SMEM_PER_STEP,
                     "gn_silu_bwd.reread": GN_BWD_REREAD_PER_STEP,
                     "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD,
                     "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD,
                     "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD,
                     # bf16 at N = 256 and 64: mma.sync only
                     "flash_attn_fwd.tc": FLASH_LAUNCHES_PER_FORWARD,
                     "flash_attn_fwd.fma": 0,
                     "flash_attn_bwd_dq.tc": FLASH_LAUNCHES_PER_FORWARD,
                     "flash_attn_bwd_dq.wgmma": 0,
                     "flash_attn_bwd_dq.fma": 0,
                     "flash_attn_bwd_dkv.tc": FLASH_LAUNCHES_PER_FORWARD,
                     "flash_attn_bwd_dkv.wgmma": 0,
                     "flash_attn_bwd_dkv.fma": 0,
                     "grouped_mm": 0,
                     **UPDATE_LAUNCHES_PER_STEP}


def log(msg: str = "") -> None:
    print(msg, flush=True)


class PartClock:
    """Seconds of a phase's parts on the host's clock: ``clock("name")``
    closes the part that began at the last mark; ``done()`` logs them."""

    def __init__(self, tag: str):
        self.tag, self.seconds, self.t = tag, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name], self.t = now - self.t, now

    def done(self) -> dict:
        log(f"[{self.tag}] seconds by part: "
            + ", ".join(f"{k} {v:.1f}" for k, v in self.seconds.items()))
        return self.seconds


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere."""
    import torch

    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond atol {atol} "
                             f"rtol {rtol} (or non-finite output)")
    return err


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Wall time per call of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events (includes the host's launch overhead when the host
    cannot keep the device busy)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


#: profiler traces that came back without device time, and traces in which
#: some kernel's event count was not a multiple of the calls traced (both
#: are traced again); and the device_ms calls whose traces all came back
#: empty, by the source that timed them instead (``device_ms``); printed in
#: the JSON line
TRACE_RETRIES = {"empty": 0, "uneven": 0, "queued_events": 0, "events": 0}
TRACE_ATTEMPTS = 4
# traces in a row without any device time before device_ms times the calls
# by CUDA events instead: CUPTI's empty traces come in runs
EMPTY_ATTEMPTS = 2
#: every device_ms call not timed by a profiler trace: where it was called,
#: its source and its ms; printed in the JSON line
NOT_PROFILED = []
#: the table row that names a device time's source when it is not a trace
SOURCE_ROWS = {"queued_events": "(CUDA events around calls queued behind a busy device)",
               "events": "(CUDA events, the host's launch gaps included)"}
CLOCK_HZ = 2.0e9  # at least the H100's SM clock: a spin of n cycles lasts >= n / CLOCK_HZ s


def ms_source(table) -> str:
    """Where :func:`device_ms`'s time came from, given its table:
    ``"profiler"`` (a CUPTI trace's kernel durations), ``"queued_events"``
    (CUDA events around back-to-back calls the host had queued before the
    device reached them: the device's span over the calls, no host launch
    gap, but the device's own few microseconds between one kernel and the
    next included) or ``"events"`` (CUDA events with the host's launch
    gaps in: an upper bound, not device time)."""
    for source, row in SOURCE_ROWS.items():
        if table and table[0][0] == row:
            return source
    return "profiler"


def idle_of(dev: float, wall: float, table):
    """The device's idle share of ``wall`` given :func:`device_ms`'s
    ``(dev, table)`` for the same work; None when ``dev`` came from CUDA
    events with the launch gaps in (no device time to set against the
    wall)."""
    return None if ms_source(table) == "events" else max(0.0, 1.0 - dev / wall)


def pct(share) -> str:
    return "not measured" if share is None else f"{100 * share:.1f}%"


def worst_source(*sources) -> str:
    """The least exact of several sources (of the terms of a sum)."""
    order = ("profiler", "queued_events", "events")
    return max(sources, key=order.index)


def _queued_ms(fn, iters: int, tries: int = 3):
    """Device ms per call of ``fn()`` from CUDA events, without the host's
    launch gaps: the device spins (``torch.cuda._sleep``) while the host
    queues ``iters`` calls between two events, so the calls run back to
    back (the device's own gap between consecutive kernels stays in; the
    size of it is what :func:`check_queued_timing` records).  Kept only when the first event had not run yet once the host had
    queued the last call (else the spin is made longer, ``tries`` times in
    all); None when that never held (``fn`` waits for the device, or the
    spin is not there)."""
    import torch

    spin = getattr(torch.cuda, "_sleep", None)
    if spin is None:
        return None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0  # the host's time to queue the calls, at most
    torch.cuda.synchronize()
    hold = 2 * host_s + 1e-3
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        spin(int(hold * CLOCK_HZ))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        queued = not start.query()  # the device still spun when the last call was queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / iters
        hold *= 4
    return None


def _trace_rows(fn, iters):
    """One ``torch.profiler`` (CUPTI) trace of ``iters`` calls of ``fn()``:
    [(kernel, ms per call, launches per call, launches in the trace)].  A
    kernel's ms per call is its mean launch's duration times its launches
    per call, the trace's count over ``iters`` rounded up: a trace that lost
    some of a kernel's events (its count no whole multiple of ``iters``)
    then still gives that kernel's whole time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            per_call = -(-e.count // iters)
            rows.append((e.key, us / 1e3 / e.count * per_call, per_call, e.count))
    return rows


def device_ms(fn, iters: int = 20, warmup: int = 3, gaps_ok: bool = True):
    """Device time per call of ``fn()``: the sum of its kernels' durations
    in a ``torch.profiler`` trace (CUPTI) over ``iters`` calls, without
    the host's launch gaps.  Returns ``(ms, kernel table)``;
    :func:`ms_source` of the table says where the time came from.

    CUPTI now and then hands back a trace without the device's events, or
    with some of them missing; such a trace is taken again, up to
    ``TRACE_ATTEMPTS`` times in all (``EMPTY_ATTEMPTS`` while none held any
    device time), and counted in ``TRACE_RETRIES``.  If no trace comes back
    whole, the last one that held device time is used (each kernel's time
    scaled to its whole launches per call, ``_trace_rows``).  If none held
    any, the calls are timed by CUDA events queued behind a busy device
    (:func:`_queued_ms`: device time, back to back); if that cannot hold
    the device, by CUDA events with the launch gaps in (an upper bound,
    ``"events"``), or, with ``gaps_ok=False``, it raises.  Either is logged,
    counted in ``TRACE_RETRIES`` and listed in ``NOT_PROFILED``, and the
    table's one row names the source."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    kept = None  # the last trace with device time, whole or not
    attempt = 0
    while True:
        attempt += 1
        rows = _trace_rows(fn, iters)
        total = sum(r[1] for r in rows)
        uneven = [r[0] for r in rows if r[3] % iters]
        if total > 0:
            kept = total, rows
            if not uneven:
                break
        limit = TRACE_ATTEMPTS if kept is not None else EMPTY_ATTEMPTS
        if attempt >= limit:
            break
        why = "empty" if total <= 0 else "uneven"
        TRACE_RETRIES[why] += 1
        what = ("without device time" if why == "empty" else "with uneven counts ("
                + ", ".join(u[:60] for u in uneven[:3]) + ")")
        log(f"[times] profiler trace {attempt}/{limit} came back {what}; tracing again")
    if kept is not None:
        total, rows = kept
        return total, sorted(((k, ms, n) for k, ms, n, _ in rows), key=lambda r: -r[1])
    at = f"chip_smoke.py:{sys._getframe(1).f_lineno}"
    ms, source = _queued_ms(fn, iters), "queued_events"
    if ms is None:
        if not gaps_ok:
            raise RuntimeError(f"{at}: {EMPTY_ATTEMPTS} profiler traces held no device time "
                               "and the calls could not be queued behind a busy device: no "
                               "device time for a number the kernels line reports")
        ms, source = cuda_time_ms(fn, iters=iters, warmup=0), "events"
    TRACE_RETRIES[source] += 1
    NOT_PROFILED.append({"at": at, "source": source, "ms": ms})
    log(f"[times] {EMPTY_ATTEMPTS} profiler traces in a row held no device time: {ms:.4f} ms "
        f"a call from {SOURCE_ROWS[source]} ({at})")
    return ms, [(SOURCE_ROWS[source], ms, 1)]


QUEUED_RATIO = (0.95, 1.25)  # a one-kernel call's queued-event time over its traced time


def check_queued_timing() -> dict:
    """The queued-event fallback of :func:`device_ms` held on this card:
    a call that reads a value back (so the device cannot be kept ahead of
    the host) must be refused; one 4096^2 bf16 matmul's queued time must lie
    within ``QUEUED_RATIO`` of its traced time (not below: the span of a
    stream's kernels is never shorter than their durations; a little
    above: the device's own gap); and 30 chained elementwise ops'
    queued and traced times are recorded, their gap per kernel too."""
    import torch

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    x = torch.randn(1 << 22, device="cuda")

    def chain():
        y = x
        for _ in range(30):
            y = y * 1.0001 + 1e-4
        return y

    if _queued_ms(lambda: float((x * 2).sum()), 5) is not None:
        raise AssertionError("queued CUDA events accepted a call that waits for the device")
    out = {}
    for what, fn, kernels in (("matmul_4096_bf16", lambda: a @ a, 1),
                              ("elementwise_x30", chain, 30)):
        fn()
        torch.cuda.synchronize()
        rows = next((r for r in (_trace_rows(fn, 10) for _ in range(TRACE_ATTEMPTS))
                     if sum(x_[1] for x_ in r) > 0), None)
        traced = None if rows is None else sum(r[1] for r in rows)
        queued = _queued_ms(fn, 10)
        if queued is None:
            raise AssertionError(f"queued CUDA events could not hold the device ahead of "
                                 f"{what}")
        out[what] = dict(traced_ms=traced, queued_ms=queued, kernels=kernels,
                         gap_us_per_kernel=(None if traced is None
                                            else 1e3 * (queued - traced) / kernels))
        if traced is not None and kernels == 1 and not (
                QUEUED_RATIO[0] <= queued / traced <= QUEUED_RATIO[1]):
            raise AssertionError(f"{what}: queued CUDA events {queued:.4f} ms against the "
                                 f"trace's {traced:.4f} ms, beyond {QUEUED_RATIO}")
    log("[times] queued CUDA events against the trace: " + "; ".join(
        f"{k} {v['queued_ms']:.4f} against "
        + ("no trace" if v["traced_ms"] is None else
           f"{v['traced_ms']:.4f} ms ({v['gap_us_per_kernel']:.2f} us a kernel over)")
        for k, v in out.items()) + "; a call that reads back refused")
    return out


def _kernel_modules():
    from ddpm_diffusion_model_tpu_torch.ops import flash_attention, fused_norm

    return fused_norm, flash_attention


def _update_module():
    from ddpm_diffusion_model_tpu_torch.ops import fused_update

    return fused_update


# the wrapper names the model's differentiable ops and the update look up
# when called, and their plain versions
_WRAPPERS = (("fn", "gn_silu_fwd", "gn_silu_reference"),
             ("fn", "gn_silu_bwd", "gn_silu_bwd_reference"),
             ("fa", "flash_attn_fwd", "flash_attn_reference"),
             ("fa", "flash_attn_bwd_dq", "flash_attn_bwd_dq_reference"),
             ("fa", "flash_attn_bwd_dkv", "flash_attn_bwd_dkv_reference"),
             ("fu", "adamw_", "adamw_reference"),
             ("fu", "ema_lerp_", "ema_lerp_reference"))


@contextlib.contextmanager
def _rebound(replace):
    """Rebind each wrapper name to ``replace(module, name, plain_name)``
    for the duration."""
    fn, fa = _kernel_modules()
    mods = {"fn": fn, "fa": fa, "fu": _update_module()}
    saved = [(mods[m], name, getattr(mods[m], name)) for m, name, _ in _WRAPPERS]
    for m, name, plain in _WRAPPERS:
        setattr(mods[m], name, replace(mods[m], name, plain))
    try:
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def plain_path():
    """Route the model's kernel call sites (forward and backward) to the
    plain versions for the duration (the kernel-vs-plain comparison of a
    whole forward or train step)."""
    return _rebound(lambda mod, name, plain: getattr(mod, plain))


def record_calls(calls):
    """Record (kind, shape, ...) of every kernel-wrapper call the model
    makes, forward and backward (the update's calls are not the model's:
    they pass unrecorded)."""

    def rec(mod, name, _plain):
        f = getattr(mod, name)
        if mod is _update_module():
            return f

        def wrapped(*args, **kw):
            if name == "gn_silu_fwd":
                x, groups = args[0], args[3]
                tb = args[5] if len(args) > 5 else kw.get("time_bias")
                calls.append(("gn", tuple(x.shape), groups, tb is not None))
            elif name == "gn_silu_bwd":
                x, groups = args[0], args[6]
                tb = args[7] if len(args) > 7 else kw.get("time_bias")
                want = args[8] if len(args) > 8 else kw.get("want_dtb")
                want = tb is not None if want is None else bool(want)
                calls.append(("gn_bwd", tuple(x.shape), groups, tb is not None, want))
            else:
                calls.append((name, tuple(args[0].shape)))
            return f(*args, **kw)

        return wrapped

    return _rebound(rec)


def _launch_counts():
    from ddpm_diffusion_model_tpu_torch.utils.observe import launch_counts

    return launch_counts


def reset_counts():
    """Set every launch and layout-copy count to 0."""
    _launch_counts().clear()


def read_counts():
    """A snapshot of the launch table, every key 0 until counted, with each
    op's launches on all its routes under the op's name (``gn_silu_fwd``,
    ``grouped_mm``, ``adamw``)."""
    from ddpm_diffusion_model_tpu_torch.utils.observe import op_total

    out = collections.Counter(_launch_counts())
    for op in KERNELS + ("grouped_mm", "adamw", "grad_norm", "ema_lerp"):
        out[op] = op_total(op, out)
    return out


# ------------------------------------------------------------------ phases


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name} | count {torch.cuda.device_count()} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from ddpm_diffusion_model_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
        f"under {cuda_build.build_dir()}")
    for ln in cuda_build.ptxas_report():
        log(f"[build] {ln}")


def main_path_shapes(model):
    """The wrappers' argument shapes in one full-width forward at BATCH."""
    import torch

    calls = []
    x = torch.randn(BATCH, 64, 64, 3, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), device="cuda")
    with record_calls(calls), torch.inference_mode():
        model(x, t)
    torch.cuda.synchronize()
    gn = [c for c in calls if c[0] == "gn"]
    fl = [c for c in calls if c[0] == "flash_attn_fwd"]
    if len(gn) != GN_LAUNCHES_PER_FORWARD or len(fl) != FLASH_LAUNCHES_PER_FORWARD \
            or len(calls) != len(gn) + len(fl):
        raise AssertionError(f"forward made {len(gn)} GN and {len(fl)} flash "
                             f"calls (of {len(calls)}), expected "
                             f"{GN_LAUNCHES_PER_FORWARD} and {FLASH_LAUNCHES_PER_FORWARD}")
    for batch in GN_FWD_SMEM_PER_FORWARD:
        check_fwd_routes(gn, batch)
    return gn, fl


def check_fwd_routes(gn_calls, batch):
    """Raise unless the GN forward plan keeps GN_FWD_SMEM_PER_FORWARD[batch]
    of a forward's recorded calls, taken at ``batch``, in shared memory."""
    import torch

    smem = sum(_gn_fwd_plan((c[0], (batch,) + c[1][1:], c[2]), torch.bfloat16)[2]
               for c in gn_calls)
    if smem != GN_FWD_SMEM_PER_FORWARD[batch]:
        raise AssertionError(f"the GN forward plan puts {smem} of a forward's launches at "
                             f"batch {batch} in shared memory, expected "
                             f"{GN_FWD_SMEM_PER_FORWARD[batch]}")
    log(f"[kernels] GN forward routes by the plan at batch {batch}: {smem} in shared "
        f"memory, {len(gn_calls) - smem} re-read")


def train_path_shapes(model):
    """The wrappers' argument shapes in one train step's forward and
    backward at TRAIN_BATCH (the model's weights are left as they were)."""
    import torch

    calls = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(TRAIN_BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(1, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    model.train()
    with record_calls(calls):
        model(x, t, generator=gen).float().square().mean().backward()
    torch.cuda.synchronize()
    model.eval()
    for p in model.parameters():
        p.grad = None
    kinds = {}
    for c in calls:
        kinds[c[0]] = kinds.get(c[0], 0) + 1
    kinds["gn_bwd_dtb"] = sum(1 for c in calls if c[0] == "gn_bwd" and c[4])
    want = {"gn": GN_LAUNCHES_PER_FORWARD, "gn_bwd": GN_LAUNCHES_PER_FORWARD,
            "gn_bwd_dtb": GN_DTB_LAUNCHES_PER_STEP,
            "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD,
            "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD,
            "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD}
    if kinds != want:
        raise AssertionError(f"a train step made the calls {kinds}, expected {want}")
    smem = sum(_gn_plan(c, torch.bfloat16)[2] for c in calls if c[0] == "gn_bwd")
    if (smem, kinds["gn_bwd"] - smem) != (GN_BWD_SMEM_PER_STEP, GN_BWD_REREAD_PER_STEP):
        raise AssertionError(f"the GN backward plan puts {smem} of a step's launches in "
                             f"shared memory, expected {GN_BWD_SMEM_PER_STEP}")
    log(f"[kernels] a train step at batch {TRAIN_BATCH} calls {kinds}; GN backward "
        f"routes by the plan: {smem} in shared memory, {kinds['gn_bwd'] - smem} re-read")
    return calls


def _gn_plan(call, dtype):
    """The GN backward plan (cluster, chunk, in_smem) of a recorded call."""
    fn = _kernel_modules()[0]
    B, H, W, C = call[1]
    return fn._gn_bwd_plan(B, H * W, C, call[2], dtype)


def _gn_fwd_plan(call, dtype):
    """The GN forward plan (cluster, chunk, in_smem) of a recorded call."""
    fn = _kernel_modules()[0]
    B, H, W, C = call[1]
    return fn._gn_fwd_plan(B, H * W, C, call[2], dtype)


def gn_inputs(shape, groups, with_tb, dtype, gen, mean=0.0):
    import torch

    B, H, W, C = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + mean).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(C, generator=gen, device="cuda")
    tb = torch.randn(B, C, generator=gen, device="cuda") if with_tb else None
    return x, scale, bias, groups, 1e-6, tb


def gn_bwd_inputs(shape, groups, with_tb, dtype, gen, mean=0.0):
    """(x, scale, bias, mean, rstd, dy, groups, time_bias): the statistics
    from the plain forward, dy standard normal in x's dtype."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import fused_norm as fn

    x, s, b, g, eps, tb = gn_inputs(shape, groups, with_tb, dtype, gen, mean)
    _, mean, rstd = fn.gn_silu_reference(x, s, b, g, eps, tb)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return x, s, b, mean, rstd, dy, g, tb


def flash_inputs(shape, dtype, gen):
    import torch

    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def flash_bwd_inputs(shape, dtype, gen):
    """(q, k, v, dO, lse, delta): LSE and O from the plain forward, delta =
    rowsum(dO * O) in fp32 as the autograd backward forms it."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import flash_attention as fa

    q, k, v = flash_inputs(shape, dtype, gen)
    o, lse = fa.flash_attn_reference(q, k, v)
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1)


# the ragged attention length's head dims: the model's 64, then 32, 128 and
# 40 (not a multiple of 16: the tensor-core kernels pad it to 64)
RAGGED_DIMS = (64, 32, 128, 40)


@contextlib.contextmanager
def variant_used(op, dtype):
    """Raise unless the flash wrapper call inside launched a tensor-core
    kernel (bf16: mma.sync or wgmma) or the FMA kernel (fp32) once, and
    not the other."""
    import torch

    before = collections.Counter(_launch_counts())
    yield
    grown = _launch_counts() - before
    got = (grown[f"{op}.tc"] + grown[f"{op}.wgmma"], grown[f"{op}.fma"])
    want = (1, 0) if dtype == torch.bfloat16 else (0, 1)
    if got != want:
        raise AssertionError(f"{op} {dtype}: (tensor-core, FMA) launches {got}, "
                             f"expected {want}")


# bf16 outputs may differ by one rounding (2^-8 relative) between two
# correct fp32 computations; fp32 only by the order of the sums
TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
# backward outputs, as a share of the largest |value| of the output (at
# least 1): sums over up to B*H*W terms whose order differs between the two
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}


def check_scaled(name, got, want, tol) -> float:
    """Raise unless |got - want| <= tol * max(max |want|, 1) everywhere;
    returns max |got - want|."""
    import torch

    err = max_err(got, want)
    scale = max(float(want.float().abs().max()), 1.0)
    if not torch.isfinite(got.float()).all() or err > tol * scale:
        raise AssertionError(f"{name}: max |err| {err:.3e} beyond {tol} x "
                             f"{scale:.3e} (or non-finite output)")
    return err


def gn_fwd_checked(args, plan=None):
    """``gn_silu_fwd(*args)`` (or, given ``plan``, the kernel on that
    plan), raising unless it launched once on the route the plan names and
    a second identical call gives the same bits (no atomics)."""
    import torch

    fn = _kernel_modules()[0]
    x = args[0]
    call = ("gn", tuple(x.shape), args[3])
    want = plan or _gn_fwd_plan(call, x.dtype)
    run = (lambda: fn.gn_silu_fwd(*args)) if plan is None else (
        lambda: fn._gn_fwd_launch(*args, plan))
    before = read_counts()
    got = run()
    grown = read_counts() - before
    routes = (grown["gn_silu_fwd.smem"], grown["gn_silu_fwd.reread"])
    if routes != (int(want[2]), int(not want[2])):
        raise AssertionError(f"gn_silu_fwd {tuple(x.shape)}: (smem, re-read) launches "
                             f"{routes}, the plan {want}")
    again = run()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gn_silu_fwd {tuple(x.shape)} plan {want}: two identical "
                             "calls differ")
    return got


#: GN forward cases beyond the main paths' shapes: (shape, groups, case)
GN_FWD_EXTRA = [((BATCH, 16, 16, 96), 32, ""), ((4, 3, 7, 30), 30, ""),
                ((BATCH, 16, 16, 64), 32, "unaligned")]
#: the shape at which every forward plan is held against the plain version
GN_FWD_PLANS_SHAPE = (4, 16, 16, 128)


def check_gn_fwd_extra(gen):
    """The GN forward at C = 96, odd C, unaligned operands; mean 1000 at
    64x64x384 against float64 on both routes in bf16 (fp32's chunk does
    not fit a block there) and re-read in fp32; every plan (cluster 1-16,
    resident where the chunk fits a block, and re-read) at one shape."""
    import torch

    fn = _kernel_modules()[0]

    def check(label, args, plan=None, mean1000=False):
        dn = str(args[0].dtype).split(".")[1]
        y, mu, rs = gn_fwd_checked(args, plan)
        x, s, b, g, eps, tb = args
        if mean1000:
            y0, mu0, rs0 = fn.gn_silu_reference(x.double(), s.double(), b.double(), g, eps,
                                                None if tb is None else tb.double())
            tol = (1e-3, 1e-3) if dn == "float32" else TOL[dn]
        else:
            y0, mu0, rs0 = fn.gn_silu_reference(*args)
            tol = TOL[dn]
        torch.cuda.synchronize()
        e = check_close(f"gn_silu {label}", y, y0, *tol)
        em = check_close(f"gn mean {label}", mu, mu0, 1e-5, 1e-5)
        er = check_close(f"gn rstd {label}", rs, rs0, 1e-5, 1e-4)
        plan = plan or _gn_fwd_plan(("gn", tuple(x.shape), g), x.dtype)
        log(f"[kernels] gn_silu_fwd {label} {dn} plan {plan}: max|err| {e:.2e} (mean "
            f"{em:.2e}, rstd {er:.2e}); a second call bit-equal")

    for shape, groups, case in GN_FWD_EXTRA:
        for dtype in (torch.bfloat16, torch.float32):
            for with_tb in (False, True):
                args = gn_inputs(shape, groups, with_tb, dtype, gen)
                if case == "unaligned":
                    args = (_unaligned(args[0]),) + args[1:]
                check(f"{shape} G={groups} {case or 'main'} tb={with_tb}", args)
    shape = (BATCH, 64, 64, 384)
    for dtype, routes in ((torch.bfloat16, (True, False)), (torch.float32, (False,))):
        args = gn_inputs(shape, 32, True, dtype, gen, mean=1000.0)
        for resident in routes:
            check(f"{shape} mean 1000 vs float64 resident={resident}", args,
                  (16, 64 * 64 // 16, resident), mean1000=True)
    B, H, W, C = GN_FWD_PLANS_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        args = gn_inputs(GN_FWD_PLANS_SHAPE, 32, True, dtype, gen)
        for cluster in (1, 2, 4, 8, 16):
            chunk = -(-H * W // cluster)
            for resident in (True, False):
                nbytes = fn._gn_fwd_smem(C, 32, chunk, resident, args[0].element_size())[2]
                if nbytes <= fn._SMEM_MAX:
                    check(f"{GN_FWD_PLANS_SHAPE} every plan", args, (cluster, chunk, resident))


#: GN backward cases beyond the train step's shapes: (shape, groups, case)
GN_BWD_EXTRA = [((BATCH, 16, 16, 96), 32, ""), ((BATCH, 32, 32, 256), 32, "mean1000"),
                ((BATCH, 16, 16, 64), 32, "unaligned"), ((4, 3, 7, 30), 30, "")]


def _unaligned(t):
    """A contiguous copy of ``t`` whose data pointer is not 16-byte aligned."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def gn_bwd_checked(args, dtype):
    """``gn_silu_bwd(*args)``, raising unless it launched once on the route
    its plan names and a second identical call gives the same bits (the
    kernel has no atomics)."""
    import torch

    fn = _kernel_modules()[0]
    x = args[0]
    plan = _gn_plan(("gn_bwd", tuple(x.shape), args[6]), dtype)
    before = read_counts()
    got = fn.gn_silu_bwd(*args)
    grown = read_counts() - before
    routes = (grown["gn_silu_bwd.smem"], grown["gn_silu_bwd.reread"])
    if routes != (int(plan[2]), int(not plan[2])):
        raise AssertionError(f"gn_silu_bwd {tuple(x.shape)}: (smem, re-read) launches "
                             f"{routes}, the plan {plan}")
    again = fn.gn_silu_bwd(*args)
    if not all(a is None and b is None or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"gn_silu_bwd {tuple(x.shape)}: two identical calls differ")
    return got


def check_plain_backwards_float64():
    """The plain backward versions are the derivatives of the plain
    forwards: float64 autograd on the card, to 1e-9."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import flash_attention as fa
    from ddpm_diffusion_model_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(8)
    f64 = dict(dtype=torch.float64, device="cuda")
    x, s, b, tb = (torch.randn(sh, generator=gen, **f64).requires_grad_()
                   for sh in ((2, 8, 8, 64), (64,), (64,), (2, 64)))
    y, mean, rstd = fn.gn_silu_reference(x, s, b, 32, 1e-6, tb)
    dy = torch.randn(y.shape, generator=gen, **f64)
    want = torch.autograd.grad(y, (x, s, b, tb), dy)
    got = fn.gn_silu_bwd_reference(x.detach(), s.detach(), b.detach(), mean.detach(),
                                   rstd.detach(), dy, 32, tb.detach())
    errs = [check_scaled("gn plain bwd vs float64 autograd", g_, w, 1e-9)
            for g_, w in zip(got, want)]
    q, k, v = (torch.randn((4, 100, 64), generator=gen, **f64).requires_grad_()
               for _ in range(3))
    o, lse = fa.flash_attn_reference(q, k, v)
    do = torch.randn(o.shape, generator=gen, **f64)
    want = torch.autograd.grad(o, (q, k, v), do)
    qd, kd, vd, od, ld = (t_.detach() for t_ in (q, k, v, o, lse))
    delta = (do * od).sum(-1)
    got = (fa.flash_attn_bwd_dq_reference(qd, kd, vd, do, ld, delta),
           *fa.flash_attn_bwd_dkv_reference(qd, kd, vd, do, ld, delta))
    errs += [check_scaled("flash plain bwd vs float64 autograd", g_, w, 1e-9)
             for g_, w in zip(got, want)]
    log(f"[kernels] plain backward versions vs float64 autograd of the plain "
        f"forwards (GN+SiLU+tb (2,8,8,64); flash (4,100,64)): max|err| "
        f"{max(errs):.2e}")


def hold_gn_fwd(shape, groups, with_tb, dtype, gen, label=""):
    """The GN forward at ``shape`` against its plain version, on the route
    its plan names and bit-equal on a repeat; returns max |err| of y."""
    import torch

    fn = _kernel_modules()[0]
    dn = str(dtype).split(".")[1]
    args = gn_inputs(shape, groups, with_tb, dtype, gen)
    y, mu, rs = gn_fwd_checked(args)
    y0, mu0, rs0 = fn.gn_silu_reference(*args)
    torch.cuda.synchronize()
    e = check_close(f"gn_silu {shape} {dn} tb={with_tb}", y, y0, *TOL[dn])
    em = check_close(f"gn mean {shape} {dn} tb={with_tb}", mu, mu0, 1e-5, 1e-5)
    er = check_close(f"gn rstd {shape} {dn} tb={with_tb}", rs, rs0, 1e-5, 1e-4)
    log(f"[kernels] {label}gn_silu_fwd {shape} G={groups} {dn} tb={with_tb} plan "
        f"{_gn_fwd_plan(('gn', shape, groups), dtype)}: max|err| {e:.2e} (mean "
        f"{em:.2e}, rstd {er:.2e}); a second call bit-equal")
    return e


def hold_gn_bwd(shape, groups, with_tb, dtype, gen, case="", label=""):
    """The GN backward at ``shape`` (``case``: "", "mean1000" against
    float64 from the same statistics, "unaligned") against its plain
    version, on the route its plan names and bit-equal on a repeat;
    returns the max |err| of (dx, dgamma, dbeta[, dtb])."""
    import torch

    fn = _kernel_modules()[0]
    dn = str(dtype).split(".")[1]
    args = gn_bwd_inputs(shape, groups, with_tb, dtype, gen,
                         1000.0 if case == "mean1000" else 0.0)
    if case == "unaligned":
        args = (_unaligned(args[0]),) + args[1:5] + (_unaligned(args[5]),) + args[6:]
    got = gn_bwd_checked(args, dtype)
    if case == "mean1000":
        x, s_, b_, mu, rs, dy, g, tb = args
        want = fn.gn_silu_bwd_reference(x.double(), s_.double(), b_.double(), mu, rs,
                                        dy.double(), g, None if tb is None else tb.double())
    else:
        want = fn.gn_silu_bwd_reference(*args)
    torch.cuda.synchronize()
    if (got[3] is None) != (not with_tb) or got[0].dtype != dtype:
        raise AssertionError(f"gn_silu_bwd {shape} {dn} tb={with_tb}: wrong outputs")
    errs = [check_scaled(f"gn_silu_bwd {shape} {case} {dn} tb={with_tb} {nm}",
                         a, w, BWD_TOL[dn if nm == "dx" else "float32"])
            for nm, a, w in zip(("dx", "dgamma", "dbeta", "dtb"), got, want)
            if w is not None]
    log(f"[kernels] {label}gn_silu_bwd {shape} G={groups} {case or 'main'} {dn} "
        f"tb={with_tb} plan {_gn_plan(('gn_bwd', shape, groups), dtype)}: "
        f"max|err| (dx, dgamma, dbeta[, dtb]) "
        f"{', '.join(f'{v:.2e}' for v in errs)}; a second call bit-equal")
    return max(errs)


def hold_flash_fwd(shape, dtype, gen, label=""):
    """The flash forward at ``shape`` against its plain version, on the
    tensor cores (bf16) or FMA (fp32); returns max |err| of O."""
    import torch

    fa = _kernel_modules()[1]
    dn = str(dtype).split(".")[1]
    q, k, v = flash_inputs(shape, dtype, gen)
    with variant_used("flash_attn_fwd", dtype):
        o, lse = fa.flash_attn_fwd(q, k, v)
    o0, lse0 = fa.flash_attn_reference(q, k, v)
    torch.cuda.synchronize()
    e = check_close(f"flash O {shape} {dn}", o, o0, *TOL[dn])
    el = check_close(f"flash LSE {shape} {dn}", lse, lse0, 1e-4, 1e-5)
    log(f"[kernels] {label}flash_attn_fwd {shape} {dn}: O max|err| {e:.2e}, "
        f"LSE max|err| {el:.2e}")
    return e


def hold_flash_bwd(shape, dtype, gen, label=""):
    """dQ and dK/dV at ``shape`` against their plain versions, on the
    tensor cores (bf16) or FMA (fp32); returns (max |err| of dQ, of dK and
    dV)."""
    import torch

    fa = _kernel_modules()[1]
    dn = str(dtype).split(".")[1]
    args = flash_bwd_inputs(shape, dtype, gen)
    with variant_used("flash_attn_bwd_dq", dtype):
        dq = fa.flash_attn_bwd_dq(*args)
    with variant_used("flash_attn_bwd_dkv", dtype):
        dk, dv = fa.flash_attn_bwd_dkv(*args)
    dq0 = fa.flash_attn_bwd_dq_reference(*args)
    dk0, dv0 = fa.flash_attn_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    e_dq = check_scaled(f"flash dQ {shape} {dn}", dq, dq0, BWD_TOL[dn])
    e_dk = check_scaled(f"flash dK {shape} {dn}", dk, dk0, BWD_TOL[dn])
    e_dv = check_scaled(f"flash dV {shape} {dn}", dv, dv0, BWD_TOL[dn])
    log(f"[kernels] {label}flash_attn_bwd {shape} {dn}: max|err| dQ {e_dq:.2e}, "
        f"dK {e_dk:.2e}, dV {e_dv:.2e}")
    return e_dq, max(e_dk, e_dv)


def hold_calls(calls, gen, label=""):
    """Every distinct recorded wrapper call against its plain version in
    bf16 and fp32 (the route each GN call's plan names, the flash variant
    each dtype takes); returns the worst bf16 error of each kernel."""
    import torch

    worst = dict.fromkeys(KERNELS, 0.0)
    gn_fwd = sorted({(c[1], c[2], c[3]) for c in calls if c[0] == "gn"},
                    key=lambda s: (s[0][0], s[0][3], s[0][1], s[2]))
    gn_bwd = sorted({(c[1], c[2], c[3]) for c in calls if c[0] == "gn_bwd"},
                    key=lambda s: (s[0][3], s[0][1], s[2]))
    fl_fwd = sorted({c[1] for c in calls if c[0] == "flash_attn_fwd"})
    fl_bwd = sorted({c[1] for c in calls if c[0] == "flash_attn_bwd_dq"})
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        for shape, groups, with_tb in gn_fwd:
            e = hold_gn_fwd(shape, groups, with_tb, dtype, gen, label)
            worst["gn_silu_fwd"] = max(worst["gn_silu_fwd"], e if bf16 else 0.0)
        for shape, groups, with_tb in gn_bwd:
            e = hold_gn_bwd(shape, groups, with_tb, dtype, gen, label=label)
            worst["gn_silu_bwd"] = max(worst["gn_silu_bwd"], e if bf16 else 0.0)
        for shape in fl_fwd:
            e = hold_flash_fwd(shape, dtype, gen, label)
            worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], e if bf16 else 0.0)
        for shape in fl_bwd:
            e_dq, e_dkv = hold_flash_bwd(shape, dtype, gen, label)
            if bf16:
                worst["flash_attn_bwd_dq"] = max(worst["flash_attn_bwd_dq"], e_dq)
                worst["flash_attn_bwd_dkv"] = max(worst["flash_attn_bwd_dkv"], e_dkv)
    return worst


def phase_kernels(gn_calls, fl_calls, train_calls):
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import fused_norm as fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = dict.fromkeys(KERNELS, 0.0)
    gn_fwd = [c for c in gn_calls + train_calls if c[0] == "gn"]
    shapes = sorted({(c[1], c[2]) for c in gn_fwd}, key=lambda s: (s[0][0], s[0][3], s[0][1]))
    for shape, groups in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for with_tb in (False, True):
                e = hold_gn_fwd(shape, groups, with_tb, dtype, gen)
                if dtype == torch.bfloat16:
                    worst["gn_silu_fwd"] = max(worst["gn_silu_fwd"], e)
    # large-mean input: the two-pass variance against a float64 reference
    args = gn_inputs((BATCH, 32, 32, 256), 32, True, torch.float32, gen, mean=1000.0)
    y = fn.gn_silu_fwd(*args)[0]
    x, s, b, g, eps, tb = args
    y64 = fn.gn_silu_reference(x.double(), s.double(), b.double(), g, eps,
                               tb.double())[0]
    e = check_close("gn_silu large-mean vs float64", y, y64, 1e-3, 1e-3)
    log(f"[kernels] gn_silu_fwd large-mean (mean 1000, std 2) fp32 vs float64: "
        f"max|err| {e:.2e}")
    check_gn_fwd_extra(gen)

    # the GN backward at every train-step shape, with and without dtb, then
    # C = 96, a large mean (against float64 from the same statistics),
    # unaligned operands and odd C (element copies)
    shapes = sorted({(c[1], c[2]) for c in train_calls if c[0] == "gn_bwd"},
                    key=lambda s: (s[0][3], s[0][1]))
    cases = [(shape, groups, "") for shape, groups in shapes] + GN_BWD_EXTRA
    for shape, groups, case in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for with_tb in (False, True):
                e = hold_gn_bwd(shape, groups, with_tb, dtype, gen, case)
                if dtype == torch.bfloat16 and not case:
                    worst["gn_silu_bwd"] = max(worst["gn_silu_bwd"], e)

    fl_fwd = [c for c in fl_calls + train_calls if c[0] == "flash_attn_fwd"]
    # the ragged length at the serving batch (64-row blocks) and, for d <= 64,
    # at the train batch (the bf16 kernel's 128-row blocks)
    shapes = sorted({c[1] for c in fl_fwd}) + [(BATCH * 4, 100, d) for d in RAGGED_DIMS] \
        + [(TRAIN_BATCH * 4, 100, d) for d in RAGGED_DIMS if d <= 64]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            e = hold_flash_fwd(shape, dtype, gen)
            if dtype == torch.bfloat16 and shape[1] in (64, 256):
                worst["flash_attn_fwd"] = max(worst["flash_attn_fwd"], e)

    # the flash backward at every train-step shape and at a ragged N = 100
    shapes = sorted({c[1] for c in train_calls if c[0] == "flash_attn_bwd_dq"}) \
        + [(TRAIN_BATCH // 2, 100, d) for d in RAGGED_DIMS]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            e_dq, e_dkv = hold_flash_bwd(shape, dtype, gen)
            if dtype == torch.bfloat16 and shape[1] in (64, 256):
                worst["flash_attn_bwd_dq"] = max(worst["flash_attn_bwd_dq"], e_dq)
                worst["flash_attn_bwd_dkv"] = max(worst["flash_attn_bwd_dkv"], e_dkv)
    check_plain_backwards_float64()
    return worst


def build_model():
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser, count_params
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    preset = get_preset("celeba64_attn")
    torch.manual_seed(0)
    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
    n = count_params(model)
    if n != 31_312_131:
        raise AssertionError(f"celeba64_attn has {n} params, expected 31,312,131")
    # non-trivial GroupNorm affines, so a swapped scale/bias would show
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    model = model.to(memory_format=torch.channels_last).eval()
    log(f"[unet] celeba64_attn: {n:,} params (seed 0)")
    return preset, model


def phase_unet(model):
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = UNetDenoiser(model.config, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict(), strict=True)
    model32 = model32.to(memory_format=torch.channels_last).eval()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    with torch.inference_mode():
        k32 = model32(x, t)
        k16 = model(x, t)
        with plain_path():
            p32 = model32(x, t)
            p16 = model(x, t)
    torch.cuda.synchronize()

    def rel(a, b):  # relative RMS error
        return float((a.float() - b.float()).norm() / b.float().norm())

    out = {"fp32_kernel_vs_plain": rel(k32, p32),
           "bf16_kernel_vs_fp32": rel(k16, p32), "bf16_plain_vs_fp32": rel(p16, p32),
           "bf16_kernel_vs_plain": rel(k16, p16)}
    log(f"[unet] forward on the card, relative RMS errors: {out}")
    if not (torch.isfinite(k16).all() and torch.isfinite(k32).all()):
        raise AssertionError("U-Net forward on the kernels is not finite")
    # fp32: the kernels and the plain versions differ only in summation
    # order.  bf16: both paths round at the same places, so the kernel path
    # must be about as close to the fp32 forward as the plain path is.
    if out["fp32_kernel_vs_plain"] > 1e-5:
        raise AssertionError(f"U-Net fp32 kernels vs plain: {out}")
    if out["bf16_kernel_vs_fp32"] > 1.25 * out["bf16_plain_vs_fp32"] + 1e-3:
        raise AssertionError(f"U-Net bf16 kernel path less accurate than plain: {out}")
    del model32
    return out


def _get(url, timeout=600):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def phase_serving(preset, model):
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server

    result = {}
    with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
        sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
        ckpt = os.path.join(tmp, "celeba64_attn.pt")
        torch.save({
            "model": sd,
            "ema": {"decay": 0.9997, "shadow": [v.clone() for v in sd.values()]},
            "step": 0,
            "extra": {"experiment": {"model": preset.model.to_dict(),
                                     "diffusion": preset.diffusion.to_dict(),
                                     "img_size": preset.img_size}},
        }, ckpt)
        svc = SamplerService.from_checkpoint(ckpt, device="cuda")
        svc.COALESCE_WINDOW_S = 0.25  # wide, so the two requests surely meet
        batches = []  # the batch of every U-Net forward
        svc.model.register_forward_hook(lambda _m, inp, _o: batches.append(inp[0].shape[0]))
        server = make_server(svc, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            code, _, body = _get(base + "/healthz")
            health = json.loads(body)
            assert code == 200 and health["status"] == "ok" and health["img_size"] == 64
            log(f"[serving] /healthz {health}")

            def sample(seed, eta=0.0, n=8, steps=50):
                t0 = time.perf_counter()
                code, hdr, body = _get(f"{base}/sample?n={n}&steps={steps}&eta={eta}"
                                       f"&seed={seed}&format=npy")
                assert code == 200 and hdr["X-Used-N"] == str(n)
                x = np.load(io.BytesIO(body))
                if x.shape != (n, 64, 64, 3) or not np.isfinite(x).all() \
                        or x.min() < 0.0 or x.max() > 1.0:
                    raise AssertionError(f"seed {seed}: bad samples {x.shape} "
                                         f"[{x.min()}, {x.max()}]")
                return x, time.perf_counter() - t0

            # launch counts: reset just before driving the path, read just after
            reset_counts()
            batches.clear()
            before = svc.metrics()["multi_request_batches"]
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                futs = {s: ex.submit(sample, s) for s in (1, 2)}
                merged = {s: f.result()[0] for s, f in futs.items()}
            coalesced = svc.metrics()["multi_request_batches"] - before
            if coalesced < 1:
                raise AssertionError("the two eta=0 requests did not coalesce")
            solo_err = 0.0
            for s in (1, 2):
                solo, _ = sample(s)
                solo_err = max(solo_err, float(np.abs(solo - merged[s]).max()))
            eta_x, _ = sample(3, eta=0.5)
            n_fwd = len(batches)
            counts = read_counts()
            launches = {"gn_silu_fwd": counts["gn_silu_fwd"],
                        "flash_attn_fwd": counts["flash_attn_fwd"]}
            if any(counts[k] for k in KERNELS if k not in launches):
                raise AssertionError(f"serving launched a backward kernel: {counts}")
            if (counts["flash_attn_fwd.tc"] != counts["flash_attn_fwd"]
                    or counts["flash_attn_fwd.fma"]):
                raise AssertionError(f"serving's bf16 flash forwards missed the "
                                     f"tensor-core kernel: {counts}")
            metrics = json.loads(_get(base + "/metrics")[2])
            log(f"[serving] /metrics {metrics}")
            # bitwise equality is not promised: cuDNN may pick another conv
            # algorithm at batch 8 than at batch 16; in bf16 over 49 steps
            # that reassociation stays far below one 8-bit pixel level
            if solo_err > 2e-2:
                raise AssertionError(f"coalesced vs solo: max diff {solo_err}")
            log(f"[serving] 2 concurrent eta=0 requests coalesced "
                f"({coalesced} multi-request batch); coalesced vs solo re-run "
                f"max |diff| {solo_err:.3e} in [0,1] pixels; eta=0.5 ok, "
                f"range [{eta_x.min():.3f}, {eta_x.max():.3f}]")
            if (launches["gn_silu_fwd"] != GN_LAUNCHES_PER_FORWARD * n_fwd
                    or launches["flash_attn_fwd"] != FLASH_LAUNCHES_PER_FORWARD * n_fwd
                    or n_fwd == 0):
                raise AssertionError(f"launches {launches} after {n_fwd} forwards")
            by_batch = {b: batches.count(b) for b in sorted(set(batches))}
            smem = sum(GN_FWD_SMEM_PER_FORWARD.get(b, -1) * n for b, n in by_batch.items())
            routes = (counts["gn_silu_fwd.smem"], counts["gn_silu_fwd.reread"])
            if routes != (smem, GN_LAUNCHES_PER_FORWARD * n_fwd - smem):
                raise AssertionError(f"GN forward (smem, re-read) launches {routes} after "
                                     f"forwards {by_batch} by batch")
            launches.update({"gn_silu_fwd.smem": routes[0], "gn_silu_fwd.reread": routes[1]})
            log(f"[serving] {n_fwd} U-Net forwards (by batch {by_batch}); launches "
                f"{launches} = {GN_LAUNCHES_PER_FORWARD} (in shared memory "
                f"{GN_FWD_SMEM_PER_FORWARD[BATCH]} at batch {BATCH}, "
                f"{GN_FWD_SMEM_PER_FORWARD[BATCH // 2]} at {BATCH // 2}) and "
                f"{FLASH_LAUNCHES_PER_FORWARD} per forward (flash forward on the tensor cores "
                f"{counts['flash_attn_fwd.tc']}, on FMA {counts['flash_attn_fwd.fma']})")
            result.update(launches=launches, forwards=n_fwd, solo_err=solo_err)

            # request latency at n=16, 50 steps (warm), default window
            del svc.COALESCE_WINDOW_S
            lat = [sample(10 + i, n=16)[1] for i in range(3)]
            result["latency_s_n16_steps50"] = lat
            log(f"[serving] n=16 steps=50 eta=0 request latency (s): "
                f"{', '.join(f'{v:.3f}' for v in lat)}")
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)
    return result


def gn_bytes_flops(shape, dtype_bytes, with_tb):
    """Forward: read x, write y; the (C,) affine, the (B, C) time bias and
    the (B, C) mean and rstd in fp32; ~10 flops per element."""
    B, H, W, C = shape
    n = B * H * W * C
    small = (2 * C + (B * C if with_tb else 0) + 2 * B * C) * 4
    return 2 * n * dtype_bytes + small, 10 * n


def gn_bwd_bytes_flops(shape, dtype_bytes, with_tb, want_dtb):
    """Backward: read x and dy, write dx; read the affine, the time bias,
    mean and rstd, write the two (B, C) partial sums and dtb, all fp32;
    ~30 flops and two exps per element over the two sweeps."""
    B, H, W, C = shape
    n = B * H * W * C
    small = (2 * C + (B * C if with_tb else 0) + 2 * B * C + 2 * B * C
             + (B * C if want_dtb else 0)) * 4
    return 3 * n * dtype_bytes + small, 30 * n


def flash_bytes_flops(shape, dtype_bytes):
    """Forward: read q, k, v, write O and the fp32 LSE; QK^T and PV."""
    BH, N, d = shape
    return 4 * BH * N * d * dtype_bytes + BH * N * 4, 4 * BH * N * N * d


def flash_dq_bytes_flops(shape, dtype_bytes):
    """dQ: read q, k, v, dO and the fp32 LSE and delta, write dQ; QK^T, dO V^T
    and dS K."""
    BH, N, d = shape
    return 5 * BH * N * d * dtype_bytes + 2 * BH * N * 4, 6 * BH * N * N * d


def flash_dkv_bytes_flops(shape, dtype_bytes):
    """dK, dV: read q, k, v, dO, LSE and delta, write dK and dV; QK^T,
    dO V^T, P^T dO and dS^T Q."""
    BH, N, d = shape
    return 6 * BH * N * d * dtype_bytes + 2 * BH * N * 4, 8 * BH * N * N * d


def bounds(nbytes, flops, dtype):
    """The least time for the work: the larger of bytes over HBM bandwidth
    and flops over the dtype's peak."""
    b_ms, f_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dtype]
    return dict(bound_ms=max(b_ms, f_ms), bytes_ms=b_ms, flops_ms=f_ms,
                bytes=nbytes, flops=flops)


FIELDS = ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
          "flops_ms", "bytes", "flops")
HEADS = 4  # celeba64_attn: (B * 4, N, 64) flash operands


def _measure(kernel, plain, library, nbytes, flops, iters=(20, 5, 10)):
    """The kernel's device and wall ms, its plain version's and the
    library's device ms (fewer calls traced: the plain versions are 10-40x
    slower and vary less than the gap to the kernel), each a device time
    (never CUDA events with launch gaps: these feed the kernels line), and
    ``ms_source``: where each of the three came from (:func:`ms_source`)."""
    out, sources = {}, {}
    for key, fn, n in zip(("ms", "plain_ms", "library_ms"), (kernel, plain, library), iters):
        if fn is None:  # not timed
            out[key] = sources[key] = None
            continue
        ms, table = device_ms(fn, iters=n, gaps_ok=False)
        out[key], sources[key] = ms, ms_source(table)
    return dict(out, wall_ms=cuda_time_ms(kernel, iters=20), ms_source=sources,
                **bounds(nbytes, flops, "bfloat16"))


def merge_sources(a: dict, b: dict) -> dict:
    """Two ``ms_source`` dicts of the terms of a sum, key by key."""
    return {k: worst_source(a.get(k, "profiler"), b.get(k, "profiler"))
            for k in set(a) | set(b)}


def _call_row(call, gen, heads=HEADS, iters=(20, 5, 10), with_plain=True):
    """(kernel name, times) of one recorded wrapper call, on fresh bf16
    inputs of its shape: the kernel, its plain version, the one PyTorch
    call that computes the same function (SDPA on the (B, heads, N, d)
    view of flash operands), and the bound."""
    import torch
    import torch.nn.functional as F

    from ddpm_diffusion_model_tpu_torch.ops import flash_attention as fa
    from ddpm_diffusion_model_tpu_torch.ops import fused_norm as fn

    dt = torch.bfloat16
    kind, shape = call[0], call[1]
    if kind == "gn":
        groups, with_tb = call[2], call[3]
        args = gn_inputs(shape, groups, with_tb, dt, gen)
        x, s, b, g, eps, tb = args
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view

        def lib():
            u = xc if tb is None else xc + tb.to(dt)[:, :, None, None]
            return F.silu(F.group_norm(u, g, s.to(dt), b.to(dt), eps))

        return "gn_silu_fwd", _measure(lambda: fn.gn_silu_fwd(*args),
                                       lambda: fn.gn_silu_reference(*args), lib,
                                       *gn_bytes_flops(shape, 2, with_tb))
    if kind == "gn_bwd":
        groups, with_tb, want = call[2], call[3], call[4]
        args = gn_bwd_inputs(shape, groups, with_tb, dt, gen)
        x, s, b, mean, rstd, dy, g, tb = args
        # the library: autograd's backward of group_norm + silu (+ the add)
        xl = x.detach().requires_grad_()
        sl, bl = s.to(dt).requires_grad_(), b.to(dt).requires_grad_()
        tl = None if tb is None else tb.detach().requires_grad_()
        u = xl.permute(0, 3, 1, 2)
        if tl is not None:
            u = u + tl.to(dt)[:, :, None, None]
        y = F.silu(F.group_norm(u, g, sl, bl, 1e-6))
        wrt = (xl, sl, bl) + ((tl,) if want else ())
        dyc = dy.permute(0, 3, 1, 2)
        return "gn_silu_bwd", _measure(
            lambda: fn.gn_silu_bwd(*args, want),
            lambda: fn.gn_silu_bwd_reference(*args, want),
            lambda: torch.autograd.grad(y, wrt, dyc, retain_graph=True),
            *gn_bwd_bytes_flops(shape, 2, with_tb, want))
    if kind == "flash_attn_fwd":
        q, k, v = flash_inputs(shape, dt, gen)
        q4, k4, v4 = (t.reshape(shape[0] // heads, heads, *shape[1:]) for t in (q, k, v))
        return kind, _measure(lambda: fa.flash_attn_fwd(q, k, v),
                              (lambda: fa.flash_attn_reference(q, k, v)) if with_plain else None,
                              lambda: F.scaled_dot_product_attention(q4, k4, v4),
                              *flash_bytes_flops(shape, 2), iters=iters)
    args = flash_bwd_inputs(shape, dt, gen)
    # the library: the backward of SDPA, which forms dQ, dK and dV in one
    # call (the same time stands beside both backward kernels)
    q4, k4, v4 = (t.reshape(shape[0] // heads, heads, *shape[1:]).detach().requires_grad_()
                  for t in args[:3])
    o4 = F.scaled_dot_product_attention(q4, k4, v4)
    do4 = args[3].reshape(o4.shape)
    lib = lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)  # noqa: E731
    if kind == "flash_attn_bwd_dq":
        return kind, _measure(lambda: fa.flash_attn_bwd_dq(*args),
                              (lambda: fa.flash_attn_bwd_dq_reference(*args)) if with_plain
                              else None, lib,
                              *flash_dq_bytes_flops(shape, 2), iters=iters)
    return kind, _measure(lambda: fa.flash_attn_bwd_dkv(*args),
                          (lambda: fa.flash_attn_bwd_dkv_reference(*args)) if with_plain
                          else None, lib,
                          *flash_dkv_bytes_flops(shape, 2), iters=iters)


#: the GN backward shape that takes most of a step's time, and the plans
#: timed against the one _gn_bwd_plan picks: (cluster, in_smem)
GN_ROUTE_SHAPE = (TRAIN_BATCH, 64, 64, 128)
GN_ROUTES = [(1, False), (2, False), (4, False), (8, False), (16, False), (16, True)]


def gn_bwd_routes():
    """Device ms of the GN backward at GN_ROUTE_SHAPE (bf16, with dtb) on
    each plan of GN_ROUTES, beside the plan's pick."""
    import torch

    fn = _kernel_modules()[0]
    B, H, W, C = GN_ROUTE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, s, b, mean, rstd, dy, g, tb = gn_bwd_inputs(GN_ROUTE_SHAPE, 32, True, torch.bfloat16,
                                                   gen)
    out = {}
    for cluster, in_smem in GN_ROUTES:
        plan = (cluster, -(-H * W // cluster), in_smem)
        out[f"{cluster}{'s' if in_smem else 'r'}"] = device_ms(
            lambda: fn._gn_bwd_launch(x, s, b, mean, rstd, dy, g, tb, True, plan),
            gaps_ok=False)[0]
    pick = fn._gn_bwd_plan(B, H * W, C, g, torch.bfloat16)
    log(f"[times] gn_silu_bwd {GN_ROUTE_SHAPE} bf16 by plan (cluster, s = chunk in "
        f"shared memory, r = re-read), device ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
        + f"; the plan picks {pick[0]}{'s' if pick[2] else 'r'}")
    return out


#: the GN forward shapes of the route table (batch 128, bf16, time bias):
#: the one the plan re-reads and the one with most of a step's bytes
GN_FWD_ROUTE_SHAPES = [(TRAIN_BATCH, 64, 64, 384), (TRAIN_BATCH, 64, 64, 128)]


def gn_fwd_routes():
    """Device ms of the GN forward at each of GN_FWD_ROUTE_SHAPES (bf16,
    with the time bias) on every cluster size, re-read and, where the chunk
    fits a block, resident, beside the plan's pick."""
    import torch

    fn = _kernel_modules()[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for shape in GN_FWD_ROUTE_SHAPES:
        B, H, W, C = shape
        x, s, b, g, eps, tb = gn_inputs(shape, 32, True, torch.bfloat16, gen)
        row = {}
        for cluster in (1, 2, 4, 8, 16):
            chunk = -(-H * W // cluster)
            for resident in (False, True):
                if fn._gn_fwd_smem(C, g, chunk, resident, 2)[2] > fn._SMEM_MAX:
                    continue
                plan = (cluster, chunk, resident)
                row[f"{cluster}{'s' if resident else 'r'}"] = device_ms(
                    lambda: fn._gn_fwd_launch(x, s, b, g, eps, tb, plan), gaps_ok=False)[0]
        pick = fn._gn_fwd_plan(B, H * W, C, g, torch.bfloat16)
        row["pick"] = f"{pick[0]}{'s' if pick[2] else 'r'}"
        out["x".join(map(str, shape))] = row
        log(f"[times] gn_silu_fwd {shape} bf16 by plan (cluster, s = chunk resident in "
            f"shared memory, r = re-read), device ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items() if k != "pick")
            + f"; the plan picks {row['pick']}")
    return out


def kernel_totals(calls, what, heads=HEADS):
    """Each kernel's times summed over the recorded calls (each distinct
    call measured once), logged per call shape and in total; flash
    operands are (B * ``heads``, N, d)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, tot = {}, {}
    for call in calls:
        if call not in rows:
            rows[call] = _call_row(call, gen, heads)
        name, r = rows[call]
        acc = tot.setdefault(name, dict(dict.fromkeys(FIELDS, 0.0), ms_source={}))
        for f in FIELDS:
            acc[f] += r[f]
        acc["ms_source"] = merge_sources(acc["ms_source"], r["ms_source"])
    for call, (name, r) in rows.items():
        log(f"[times] {name} {call[1:]}: kernel {r['ms']:.4f} ms (wall "
            f"{r['wall_ms']:.4f}) | plain {r['plain_ms']:.4f} | library "
            f"{r['library_ms']:.4f} | bound {r['bound_ms']:.4f} ({int(r['bytes'])} B, "
            f"{int(r['flops'])} flop)")
    for name, r in tot.items():
        log(f"[times] {name} per {what} (bf16, device time): kernel {r['ms']:.4f} ms "
            f"| plain {r['plain_ms']:.4f} | library {r['library_ms']:.4f} | bound "
            f"{r['bound_ms']:.4f} ({int(r['bytes'])} B) | kernel wall {r['wall_ms']:.4f}")
    return tot


def phase_times(model, gn_calls, fl_calls):
    """Per-kernel device times summed over one U-Net forward's launches,
    beside the bound, the plain version and the PyTorch yardstick; then the
    whole forward's wall and device time and its top kernels."""
    import torch

    tot = kernel_totals(gn_calls + fl_calls, f"U-Net forward (batch {BATCH})")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    fwd = {}
    with torch.inference_mode():
        for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_path)):
            with ctx():
                wall = cuda_time_ms(lambda: model(x, t), iters=20)
                dev, table = device_ms(lambda: model(x, t), iters=5)
            fwd[path] = dict(wall_ms=wall, device_ms=dev, device_ms_source=ms_source(table),
                             idle_share=idle_of(dev, wall, table))
            log(f"[times] U-Net forward batch {BATCH} bf16 on the {path}: wall "
                f"{wall:.3f} ms ({1e3 / wall:.1f} forwards/s, "
                f"{BATCH * 1e3 / wall:.1f} images/s), device {dev:.3f} ms, "
                f"device idle {pct(fwd[path]['idle_share'])}")
            for name, ms, count in table[:12]:
                log(f"[times]   {ms:8.4f} ms  x{count:<3d} {name[:110]}")
    return tot, fwd


def _flat(tensors):
    import torch

    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def _one_step(preset, base_sd, dtype, ctx, x, draws, labels=None, wrap=None):
    """From ``base_sd``, with dropout off: the grads of L_simple on the
    given draws (and ``labels``, for a class-conditional ``preset``),
    summed over the preset's micro-batches as the step sums them, then one
    train step on them; on the kernels or, under ``ctx = plain_path``, on
    the plain versions (``ctx`` may also be a parallel context; ``wrap``
    wraps the model, as ``PipelinedDiT`` does).  The preset's ``remat`` and
    super-resolution training (``superres_factor``, ``cond_aug``) hold in
    both."""
    import dataclasses

    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, make_loss_fn,
                                                         make_train_step)
    from ddpm_diffusion_model_tpu_torch.training.step import _micro

    cfg = dataclasses.replace(preset.model, dropout=0.0)
    model = build_denoiser(cfg, dtype=dtype, device="cuda", remat=preset.remat)
    model.load_state_dict(base_sd, strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    if wrap is not None:
        model = wrap(model)
    sched = make_schedule(preset.diffusion, device="cuda")
    start = _flat(model.parameters())
    batch = x if labels is None else (x, labels)
    tc = preset.train
    accum = max(1, int(tc.grad_accum_steps))
    mb = x.shape[0] // accum
    reset_counts()
    with ctx():
        loss_fn = make_loss_fn(model, sched, cond_dropout=tc.cond_dropout,
                               superres_factor=tc.superres_factor, cond_aug=tc.cond_aug)
        loss = 0.0
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            part = loss_fn(x[sl] if labels is None else (x[sl], labels[sl]),
                           _micro(draws, sl)) / accum
            part.backward()
            loss = loss + part.detach()
        grads = _flat(p.grad for p in model.parameters())
        class_grad = (None if labels is None
                      else model.class_emb.weight.grad.detach().float().clone())
        stem_grad = (model.in_conv.weight.grad.detach().float().clone()
                     if getattr(cfg, "cond_channels", 0) else None)
        routers = [p for n, p in model.named_parameters() if ".moe.router." in n]
        router_grad = _flat(p.grad for p in routers) if routers else None
        kbias = None  # a DiT's key-bias gradient over its query-bias gradient
        if hasattr(cfg, "hidden_size"):
            H = cfg.hidden_size
            g = [p.grad.float() for n, p in model.named_parameters()
                 if n.endswith(".qkv.bias")]
            kbias = float(torch.cat([b[H:2 * H] for b in g]).norm()
                          / torch.cat([b[:H] for b in g]).norm())
        for p in model.parameters():
            p.grad = None
        state, tx = init_train_state(model, preset.train)
        state, m = make_train_step(model, sched, tx, preset.train)(state, batch, draws)
    torch.cuda.synchronize()
    counts = read_counts()
    keep = _compared_params(model)
    return dict(counts=counts, loss=float(m["loss"]), grad_loss=float(loss.detach()),
                grad_norm=float(m["grad_norm"]), lr=m["lr"], grads=grads,
                move=(_flat(model.parameters()) - start)[keep],
                params=_flat(model.parameters())[keep], class_grad=class_grad,
                stem_grad=stem_grad, router_grad=router_grad, kbias=kbias)


def _compared_params(model):
    """A mask over the flat params whose update the parity steps compare:
    all of them, but a DiT's key biases (``qkv.bias[H:2H]``).  Those add
    q.b to every logit of a row, which the softmax removes: their gradient
    is 0 up to rounding (held in phase_train_parity), and Adam's first step
    may turn that rounding into a move either way."""
    import torch

    keep = []
    for name, p in model.named_parameters():
        m = torch.ones(p.numel(), dtype=torch.bool, device=p.device)
        if name.endswith(".qkv.bias") and hasattr(model.config, "hidden_size"):
            H = model.config.hidden_size
            m[H:2 * H] = False
        keep.append(m)
    return torch.cat(keep)


def phase_train_parity(preset, base_sd, images, labels=None, tag="train",
                       flash_per_forward=FLASH_LAUNCHES_PER_FORWARD):
    """(a) one step from the same weights and injected (t, noise), dropout
    off: kernels vs plain in fp32 (summation order only), and in bf16 the
    kernel path no less accurate than the plain path against fp32.  With
    ``labels`` (a class-conditional ``preset``) the draws hold a drop mask
    too, and the class table's gradient is held on its own as well."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops.diffusion import sample_timesteps
    from ddpm_diffusion_model_tpu_torch.training import StepDraws

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.from_numpy(images[:TRAIN_BATCH]).cuda()
    draws = StepDraws(sample_timesteps(TRAIN_BATCH, preset.diffusion.T, gen, "cuda"),
                      torch.randn(x.shape, generator=gen, device="cuda"))
    if labels is not None:
        labels = torch.from_numpy(labels[:TRAIN_BATCH]).cuda()
        draws.drop = torch.rand((TRAIN_BATCH,), generator=gen, device="cuda") \
            < preset.train.cond_dropout
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_path)):
            runs[(str(dtype).split(".")[1], path)] = _one_step(preset, base_sd, dtype, ctx,
                                                                x, draws, labels)
            torch.cuda.empty_cache()
    ref = runs[("float32", "plain")]
    eps32 = float(torch.finfo(torch.float32).eps)

    def errs(r):
        e = {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
             "grad_norm": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
             "grads": float((r["grads"] - ref["grads"]).norm() / ref["grads"].norm()),
             "params": float((r["params"] - ref["params"]).norm()
                             / (ref["move"].norm() + eps32 * ref["params"].norm()))}
        if labels is not None:
            e["class_emb_grad"] = float((r["class_grad"] - ref["class_grad"]).norm()
                                        / ref["class_grad"].norm())
        if ref["router_grad"] is not None:
            e["router_grad"] = float((r["router_grad"] - ref["router_grad"]).norm()
                                     / ref["router_grad"].norm())
        return e

    out = {f"{dn}_{path}": errs(r) for (dn, path), r in runs.items() if (dn, path) !=
           ("float32", "plain")}
    what = "" if labels is None else (f", {int(draws.drop.sum())} of {TRAIN_BATCH} labels "
                                      "dropped to the NULL token")
    log(f"[{tag}] one step at batch {TRAIN_BATCH} from the same weights and draws{what}, "
        f"dropout off: loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f}, "
        f"lr {ref['lr']:.3e} (fp32 plain); relative errors against it: {out}")
    # two forwards and backwards each (the grads, then the step): on the
    # kernels, fp32 goes through the FMA flash kernels and bf16 through the
    # tensor-core ones; the plain path launches nothing
    for (dn, path), r in runs.items():
        c = r["counts"]
        n = 2 * flash_per_forward if path == "kernels" else 0
        want = {"flash_attn_fwd": n, "flash_attn_bwd_dq": n, "flash_attn_bwd_dkv": n}
        for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
            want[f"{k}.tc"] = n if dn == "bfloat16" else 0
            want[f"{k}.fma"] = n if dn == "float32" else 0
        got = {k: c[k] for k in want}
        if got != want:
            raise AssertionError(f"{dn} train step on the {path}: flash launches {got}, "
                                 f"expected {want}")
    log(f"[{tag}] flash launches of the two parity steps on the kernels, (tensor-core, "
        "FMA): " + "; ".join(
            f"{dn} forward ({c['flash_attn_fwd.tc']}, {c['flash_attn_fwd.fma']}), dQ "
            f"({c['flash_attn_bwd_dq.tc']}, {c['flash_attn_bwd_dq.fma']}), dK/dV "
            f"({c['flash_attn_bwd_dkv.tc']}, {c['flash_attn_bwd_dkv.fma']})"
            for dn in ("float32", "bfloat16") for c in [runs[(dn, "kernels")]["counts"]]))
    for r in runs.values():
        if not all(torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]]))) \
                or abs(r["loss"] - r["grad_loss"]) > 1e-6 * abs(r["loss"]):
            raise AssertionError(f"train step: bad loss {r['loss']} / {r['grad_loss']}")
    for path in ("kernels", "plain"):
        kb = runs[("float32", path)]["kbias"]
        if kb is not None and kb > 1e-3:
            raise AssertionError(f"fp32 step on the {path}: the key biases' gradient is "
                                 f"{kb:.2e} of the query biases', not 0 up to rounding")
    k32 = out["float32_kernels"]
    # fp32: the kernels and the plain versions differ in summation order
    # only.  The params' bar is looser than the grads': the first Adam step
    # moves every element by about lr * sign(g), so an element whose grad
    # lies within summation noise of 0 may move the other way.
    if (k32["loss"] > 1e-5 or k32["grad_norm"] > 1e-4 or k32["grads"] > 1e-4
            or k32["params"] > 1e-2 or k32.get("class_emb_grad", 0.0) > 1e-4
            or k32.get("router_grad", 0.0) > 1e-4):
        raise AssertionError(f"fp32 train step on the kernels vs plain: {k32}")
    kb, pb = out["bfloat16_kernels"], out["bfloat16_plain"]
    for key in kb:
        if kb[key] > 1.25 * pb[key] + 1e-3:
            raise AssertionError(f"bf16 train step: the kernel path is less accurate "
                                 f"than the plain path in {key}: {out}")
    return out


def phase_train_epoch(preset, model, images, labels=None, tag="train",
                      per_step=LAUNCHES_PER_STEP, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH):
    """(b) train_one_epoch for ``steps`` steps with dropout on: finite
    loss and exactly ``per_step`` kernel launches per step; (c) the
    step's wall and device time, idle share, top kernels and peak memory.
    With ``labels`` (a class-conditional model) the batches are (images,
    labels)."""
    import math

    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, make_train_step,
                                                         train_one_epoch)

    torch.backends.cudnn.allow_tf32 = True  # the library defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    n_batches = len(images) // batch_size

    def batch(i):
        sl = slice((i % n_batches) * batch_size, (i % n_batches + 1) * batch_size)
        return images[sl] if labels is None else (images[sl], labels[sl])

    loader = [batch(i) for i in range(steps)]
    model.train()
    state, tx = init_train_state(model, preset.train, seed=5)
    step = make_train_step(model, make_schedule(preset.diffusion, device="cuda"), tx,
                           preset.train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # launch counts: reset just before driving the path, read just after
    reset_counts()
    t0 = time.perf_counter()
    state, avg, nb, ni = train_one_epoch(step, state, loader, labeled=labels is not None,
                                         log_every=5, log_grad_norm=True, log_mem=True,
                                         epoch_header_printed=[False])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * nb for k, v in per_step.items()}
    got = {k: counts[k] for k in want}
    log(f"[{tag}] train_one_epoch: {nb} steps, {ni} images, avg loss {avg:.5f}, "
        f"{epoch_s:.2f} s; launches {got}; layout copies: dy "
        f"{counts['gn_dy_layout_copies']}, dO {counts['flash_do_layout_copies']}; "
        f"peak memory {peak_gb:.2f} GiB")
    if nb != steps or state.step != steps or not math.isfinite(avg):
        raise AssertionError(f"epoch: {nb} steps, state.step {state.step}, loss {avg}")
    if got != want:
        raise AssertionError(f"launches {got} over {nb} steps, expected {want}")

    x = torch.from_numpy(np.ascontiguousarray(images[:batch_size])).cuda()
    if labels is not None:
        x = (x, torch.from_numpy(labels[:batch_size]).cuda())
    wall = cuda_time_ms(lambda: step(state, x), iters=10, warmup=2)
    dev, table = device_ms(lambda: step(state, x), iters=3, warmup=1)
    res = dict(launches=got, launches_per_step={k: v // nb for k, v in got.items()},
               layout_copies={"dy": counts["gn_dy_layout_copies"],
                              "dO": counts["flash_do_layout_copies"]},
               avg_loss=avg, step_wall_ms=wall, images_per_s=batch_size * 1e3 / wall,
               step_device_ms=dev, device_ms_source=ms_source(table),
               idle_share=idle_of(dev, wall, table), peak_mem_gib=peak_gb, epoch_s=epoch_s)
    log(f"[{tag}] step at batch {batch_size} bf16: wall {wall:.3f} ms "
        f"({res['images_per_s']:.1f} images/s), device {dev:.3f} ms, device idle "
        f"{pct(res['idle_share'])}, peak memory {peak_gb:.2f} GiB")
    for name, ms, count in table[:15]:
        log(f"[{tag}]   {ms:8.4f} ms  x{count:<4d} {name[:110]}")
    model.eval()
    return res


# ------------------------------------------------------------------ the update

UPDATE_PRESET = "imagenet256_dit_moe_xl2"
UPDATE_DEPTH = 7  # the benchmark's MoE cell: one pipeline stage of 7 blocks


def _library_update(tx, params, grads, opt, shadow, steps, decay):
    """The library's nearest tail, for its time alone: the metric's norm
    (``_foreach_norm``), the clip as the fused AdamW's ``grad_scale``, the
    fused multi-tensor AdamW (decoupled decay, its own bias corrections:
    not the optax rounding the port keeps) and a multi-tensor lerp."""
    import torch

    cfg = tx.cfg
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = None if cfg.grad_clip is None else torch.clamp(norm / cfg.grad_clip, min=1.0)
    torch._fused_adamw_(params, grads, opt["mu"], opt["nu"], [], steps, lr=tx.scalars(opt)[2],
                        beta1=cfg.adam_b1, beta2=cfg.adam_b2,
                        weight_decay=float(cfg.weight_decay or 0.0), eps=1e-8, amsgrad=False,
                        maximize=False, grad_scale=scale, found_inf=None)
    torch._foreach_lerp_(shadow, params, float(1.0 - decay))
    return norm


def phase_update():
    """The update's tail at the MoE cell's parameter list (DiT-MoE-XL/2,
    one 7-block stage: 1,046,066,704 fp32 params), without the clip (the
    cell's recipe) and with it.  First one update by the kernels and one by
    the plain multi-tensor sequence from the same params, moments, shadow
    and grads (moments and shadow moved off their init): params, moments
    and shadow bit-equal (the plain sequence clipped by the kernel's norm,
    whose last bits may differ from its own), the norm within 1e-6 of the
    multi-tensor one, else it raises.  Then device ms per update of the
    kernels against their bytes bound (40 B a param, 44 with the clip's
    norm pass first, at HBM_BYTES_PER_S), of the plain sequence, and of the
    library's fused AdamW with a multi-tensor lerp (:func:`_library_update`,
    timed only), and the kernels' launches per update.  Timed by CUDA
    events queued behind a busy device (device time, no launch gaps) where
    the calls let the host run ahead, else by the profiler: its traces of
    these long calls come back short of events, which once read the kernel
    at twice its bound's speed, so a kernel time under the bound raises."""
    import dataclasses

    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.training import make_optimizer
    from ddpm_diffusion_model_tpu_torch.training.state import global_norm
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    fu = _update_module()
    exp = get_preset(UPDATE_PRESET)
    model = build_denoiser(dataclasses.replace(exp.model, depth=UPDATE_DEPTH),
                           dtype=torch.bfloat16, device="cuda")
    params = [p.detach() for p in model.parameters()]
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def rand(like, scale):
        return torch.randn(like.shape, generator=gen, device="cuda").mul_(scale)

    grads = [rand(p, 1e-3) for p in params]
    res = {"params": n, "tensors": len(params)}
    for clip in (None, 1.0):
        cfg = dataclasses.replace(exp.train, grad_clip=clip)
        tx = make_optimizer(cfg)
        opt = tx.init(params)
        opt["count"] = opt["schedule_count"] = 10
        for m, v in zip(opt["mu"], opt["nu"]):
            m.copy_(rand(m, 1e-4))
            v.copy_(rand(v, 1e-3).square_())
        shadow = [p + rand(p, 1e-3) for p in params]
        # one update each from one start: the kernels on a copy
        twin = ([p.clone() for p in params], dict(opt, mu=[m.clone() for m in opt["mu"]],
                                                  nu=[v.clone() for v in opt["nu"]]),
                [e.clone() for e in shadow])
        own = float(global_norm(grads))
        reset_counts()
        norm = fu.adamw_(tx, twin[0], grads, twin[1])
        fu.ema_lerp_(twin[2], twin[0], cfg.ema_decay)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = [counts["adamw"], counts["grad_norm"], counts["ema_lerp"]]
        # the plain clip scales its grads in place: a copy of them
        fu.adamw_reference(tx, params, [g.clone() for g in grads], opt, grad_norm=norm)
        fu.ema_lerp_reference(shadow, params, cfg.ema_decay)
        torch.cuda.synchronize()
        differ = {what: sum(not torch.equal(a, b) for a, b in zip(x, y))
                  for what, x, y in (("params", twin[0], params), ("mu", twin[1]["mu"], opt["mu"]),
                                     ("nu", twin[1]["nu"], opt["nu"]),
                                     ("shadow", twin[2], shadow))}
        norm_rel = abs(float(norm) - own) / own
        del twin
        row = {"bound_ms": n * (44 if clip else 40) / HBM_BYTES_PER_S * 1e3,
               "parity": dict(tensors_differ=differ, norm_rel=norm_rel), "launches": launches}
        want = [1, int(clip is not None), 1]
        if any(differ.values()) or norm_rel > 1e-6 or launches != want:
            raise AssertionError(f"update (clip {clip}): {row}; the kernels should match the "
                                 f"plain sequence bit for bit, the norm within 1e-6, with "
                                 f"launches {want}")
        steps = [torch.full((), float(opt["count"]), device="cuda") for _ in params]

        def fused():
            fu.adamw_(tx, params, grads, opt)
            fu.ema_lerp_(shadow, params, cfg.ema_decay)

        def plain():
            fu.adamw_reference(tx, params, grads, opt)
            fu.ema_lerp_reference(shadow, params, cfg.ema_decay)

        def library():
            _library_update(tx, params, grads, opt, shadow, steps, cfg.ema_decay)

        for name, call in (("fused", fused), ("plain", plain), ("library", library)):
            ms, source = _queued_ms(call, iters=3), "queued_events"
            if ms is None:
                ms, table = device_ms(call, iters=3, warmup=1)
                source = ms_source(table)
            row[name] = dict(ms=ms, ms_source=source)
        if row["fused"]["ms"] < row["bound_ms"]:
            raise AssertionError(f"update (clip {clip}): {row}; the kernels' time is under "
                                 "their bound")
        tag = "clip 1.0" if clip else "no clip"
        log(f"[update] {tag}, {n:,} params in {len(params)} tensors: kernels bit-equal to the "
            f"multi-tensor sequence, norm within {norm_rel:.1e}; fused "
            f"{row['fused']['ms']:.3f} ms ({row['fused']['ms_source']}) against the "
            f"{44 if clip else 40} B/param bound {row['bound_ms']:.3f} ms "
            f"({100 * row['bound_ms'] / row['fused']['ms']:.1f}%), the multi-tensor sequence "
            f"{row['plain']['ms']:.3f} ms ({row['plain']['ms_source']}), the library's fused "
            f"AdamW and lerp {row['library']['ms']:.3f} ms ({row['library']['ms_source']}); "
            f"launches adamw/grad_norm/ema_lerp {want}")
        res["clip" if clip else "no_clip"] = row
        del opt, shadow, tx, steps
    del model, params, grads
    torch.cuda.empty_cache()
    return res


# ------------------------------------------- the run, sampling, remat, hq256

RUN_PRESET = "celeba64_attn"
RUN_BATCHES = 4  # batches of blob faces per epoch of the [run] phase
RUN_EPOCHS = 3
RUN_TRIP = (1, 3)  # (epoch, batch) at whose draw run (b)'s flag trips
RUN_PREFETCH = 2  # train_one_epoch's device_prefetch depth: draws run this far ahead
RUN_PARTIAL = RUN_TRIP[1] - RUN_PREFETCH  # epoch 1's batches trained before the stop
SAMPLE_N = 16
DDIM_STEPS = 50  # the ladders of ddim_sample (the hook) and of the DDIM entry points
HQ_PRESET = "celebahq256"
HQ_STEPS = 3


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms, chosen without benchmarking: the
    same work gives the same bits."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def no_tf32():
    """fp32 without TF32 for the comparisons; the settings found are
    restored after."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class RunLoader:
    """The [run] phase's loader: fixed batches in an order shuffled by
    ``set_epoch``; trips ``flag`` when batch RUN_TRIP[1] of epoch
    RUN_TRIP[0] is drawn.  The loop reads the flag before each step and
    draws RUN_PREFETCH batches ahead, so the run stops after that epoch's
    first batch (RUN_PARTIAL)."""

    def __init__(self, batches, flag=None):
        self.batches, self.flag, self.epoch = batches, flag, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        import numpy as np

        order = np.random.default_rng(self.epoch).permutation(len(self.batches))
        for i, j in enumerate(order):
            if self.flag is not None and (self.epoch, i) == RUN_TRIP:
                self.flag()
            yield self.batches[j]


def count_forwards(model):
    """A list whose first item counts ``model``'s forwards (its
    ``functional_call``s too), and whose second the images they took."""
    seen = [0, 0]

    def hook(_m, inp, _o):
        seen[0] += 1
        seen[1] += inp[0].shape[0]

    model.register_forward_hook(hook)
    return seen


def state_differences(a, b):
    """The parts of two train states that are not bit-equal, each with its
    max |difference| over the tensor's norm."""
    import torch

    out = {}
    for key in ("step", "count", "schedule_count"):
        va = a.step if key == "step" else a.opt_state[key]
        vb = b.step if key == "step" else b.opt_state[key]
        if va != vb:
            out[key] = f"{va} vs {vb}"
    names = [n for n, _ in a.model.named_parameters()]
    pairs = [(f"params[{n}]", p, q) for n, p, q in
             zip(names, a.model.parameters(), b.model.parameters())]
    for kind in ("mu", "nu"):
        pairs += [(f"{kind}[{n}]", m, v) for n, m, v in
                  zip(names, a.opt_state[kind], b.opt_state[kind])]
    pairs += [(f"ema[{n}]", a.ema_params[n], b.ema_params[n]) for n in names]
    pairs.append(("generator", a.generator.get_state(), b.generator.get_state()))
    for name, p, q in pairs:
        if not torch.equal(p, q):
            d = (p.double() - q.double()).abs().max() / max(float(q.double().norm()), 1e-30)
            out[name] = f"{float(d):.3e}"
    return out


def _dir_mib(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path)
               for f in fs) / 2**20


def ddim_ladder(sched, kind):
    from ddpm_diffusion_model_tpu_torch.sampling import build_ddim_schedule

    return build_ddim_schedule(kind, DDIM_STEPS, sched.T,
                               alphas_cumprod=sched.alphas_cumprod.cpu().numpy())


def phase_run(preset, base_sd, images, tmp):
    """train_ddpm on celeba64_attn at batch 128 with the preset's
    TrainConfig: (a) RUN_EPOCHS epochs of RUN_BATCHES batches with a
    checkpoint and a DDIM grid per epoch and the eval pass; (b) the same
    run stopped by a PreemptionFlag after epoch 1's first batch; (c)
    resume_path="auto" from (b)'s _preempt save.  (c) must equal (a) bit
    for bit.  Returns the phase's numbers and (a)'s checkpoint dir."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import ddim_sample
    from ddpm_diffusion_model_tpu_torch.training import (PreemptionFlag, read_meta,
                                                         save_checkpoint, train_ddpm,
                                                         wait_for_checkpoints)

    batches = [np.ascontiguousarray(images[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(RUN_BATCHES)]
    sched = make_schedule(preset.diffusion, device="cuda")
    configs = {"model": preset.model.to_dict(), "diffusion": preset.diffusion.to_dict(),
               "train": preset.train.to_dict()}
    forwards = {}

    def run(tag, ckpt_dir, loader, flag=False, **kw):
        model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
        model = model.to(memory_format=torch.channels_last)
        forwards[tag] = count_forwards(model)
        log(f"[run] ({tag}) train_ddpm {RUN_PRESET}, batch {TRAIN_BATCH}, bf16, "
            f"{RUN_EPOCHS} epochs of {RUN_BATCHES} batches -> {ckpt_dir}")
        t0 = time.perf_counter()
        with cudnn_deterministic():
            state, summary = train_ddpm(
                model, sched, loader, train_config=preset.train, init_params=base_sd,
                init_seed=5, epochs=RUN_EPOCHS, sample_every=1, sample_n=SAMPLE_N,
                img_size=preset.img_size, sample_fn=ddim_sample, eval_loader=batches[:1],
                ckpt_dir=ckpt_dir, run_name=RUN_PRESET, save_every=1,
                configs_for_ckpt=configs, handle_preemption=flag, **kw)
        torch.cuda.synchronize()
        sys.stdout.flush()
        return state, summary, time.perf_counter() - t0

    dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    # the slice's main path: counts set to 0 just before, read just after
    reset_counts()
    a, sum_a, sec_a = run("a", dir_a, RunLoader(batches))
    counts = read_counts()
    n_fwd, steps = forwards["a"][0], RUN_EPOCHS * RUN_BATCHES
    # a DDIM grid steps once per rung of the ladder but the last
    hook_fwd = RUN_EPOCHS * (len(ddim_ladder(sched, "karras")) - 1)
    eval_fwd = 2 * RUN_EPOCHS
    if a.step != steps or n_fwd != steps + eval_fwd + hook_fwd:
        raise AssertionError(f"run (a): {a.step} steps and {n_fwd} forwards, expected "
                             f"{steps} and {steps + eval_fwd + hook_fwd}")
    want = {"gn_silu_fwd": GN_LAUNCHES_PER_FORWARD * n_fwd,
            "gn_silu_fwd.smem": GN_FWD_SMEM_PER_FORWARD[BATCH] * hook_fwd,
            "gn_silu_bwd": GN_LAUNCHES_PER_FORWARD * steps,
            "gn_silu_bwd_dtb": GN_DTB_LAUNCHES_PER_STEP * steps,
            "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD * n_fwd,
            "flash_attn_fwd.tc": FLASH_LAUNCHES_PER_FORWARD * n_fwd,
            "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD * steps,
            "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD * steps,
            "flash_attn_bwd_dkv.tc": FLASH_LAUNCHES_PER_FORWARD * steps}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"run (a) launches {got}, expected {want}")
    log(f"[run] (a) {sec_a:.1f} s: {steps} steps, {n_fwd} U-Net forwards ({steps} train, "
        f"{eval_fwd} eval, {hook_fwd} in the sample hooks); launches {got}")

    flag = PreemptionFlag()
    b, sum_b, sec_b = run("b", dir_b, RunLoader(batches, flag), flag=flag)
    meta = read_meta(os.path.join(dir_b, f"{RUN_PRESET}_preempt"))
    if not (sum_b.get("preempted") and b.step == RUN_BATCHES + RUN_PARTIAL
            and (meta["epoch"], meta["global_step"]) == (RUN_TRIP[0] - 1, b.step)
            and meta["extra"].get("partial_batches") == RUN_PARTIAL):
        raise AssertionError(f"run (b): step {b.step}, summary {sum_b}, meta {meta}")
    log(f"[run] (b) {sec_b:.1f} s: preempted at step {b.step}; _preempt meta epoch "
        f"{meta['epoch']}, global_step {meta['global_step']}, extra {meta['extra']}")
    c, sum_c, sec_c = run("c", dir_b, RunLoader(batches), resume_path="auto")
    diff = state_differences(c, a)
    if diff:
        raise AssertionError(f"the resumed run (c) differs from the uninterrupted (a): "
                             f"{dict(list(diff.items())[:8])} ({len(diff)} parts)")
    log(f"[run] (c) {sec_c:.1f} s: resumed at epoch {sum_c['epochs'][0]['epoch']}; params, "
        f"EMA, mu, nu, count {c.opt_state['count']}, schedule_count "
        f"{c.opt_state['schedule_count']}, step {c.step} and the generator equal (a)'s "
        "bit for bit")
    for d in (dir_a, dir_b):
        log(f"[run] on disk in {os.path.basename(d)}/: " + ", ".join(
            f"{n} ({_dir_mib(os.path.join(d, n)):.1f} MiB)" for n in sorted(os.listdir(d))))
    # one more save of (a)'s state: the call's return, then durable on disk
    path = os.path.join(tmp, "timed")
    t0 = time.perf_counter()
    save_checkpoint(path, a, epoch=RUN_EPOCHS - 1, configs=configs, block=False)
    dispatch = time.perf_counter() - t0
    wait_for_checkpoints()
    durable = time.perf_counter() - t0
    size = _dir_mib(path)
    log(f"[run] checkpoint of {size:.1f} MiB: dispatched in {1e3 * dispatch:.1f} ms, "
        f"durable in {1e3 * durable:.1f} ms")
    return dict(seconds={"a": sec_a, "b": sec_b, "c": sec_c}, launches=got, forwards=n_fwd,
                resumed_bit_equal=True, ckpt_mib=size, save_dispatch_ms=1e3 * dispatch,
                save_durable_ms=1e3 * durable,
                epochs=[dict(e) for e in sum_a["epochs"]]), dir_a


def phase_sample(preset, ckpt_dir, tmp):
    """The four sampling entry points from the run's _last checkpoint (EMA
    weights): a full T=1000 DDPM grid and a DDIM grid of SAMPLE_N, both
    denoise strips; the PNGs against grid_nrow/make_grid."""
    import numpy as np
    import torch
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import (ddim_infer_sample,
                                                         ddpm_infer_sample,
                                                         render_denoise_strip,
                                                         render_denoise_strip_ddim)
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, load_checkpoint
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
    model = model.to(memory_format=torch.channels_last)
    state, meta = load_checkpoint(os.path.join(ckpt_dir, f"{RUN_PRESET}_last"),
                                  init_train_state(model, preset.train)[0],
                                  components=("params", "ema_params"))
    sched = make_schedule(preset.diffusion, device="cuda")
    seen = count_forwards(model)
    T, S = preset.diffusion.T, preset.img_size
    kw = dict(img_size=S, ema_params=state.ema_params, seed=3)
    blank = lambda n: np.zeros((n, S, S, 3), np.float32)  # noqa: E731
    rungs = len(ddim_ladder(sched, "t_linear"))
    # (entry point, U-Net forwards, the PNG's shape): the grids step once per
    # rung but the last, the strips (which capture) once per rung; 20 DDPM
    # frames, at most 17 DDIM ones, one row
    jobs = [("ddpm_infer_sample", lambda p: ddpm_infer_sample(
                model, None, sched, n=SAMPLE_N, out_path=p, **kw),
             T, make_grid(blank(SAMPLE_N), nrow=grid_nrow(SAMPLE_N)).shape),
            ("ddim_infer_sample", lambda p: ddim_infer_sample(
                model, None, sched, n=SAMPLE_N, out_path=p, steps=DDIM_STEPS, **kw),
             rungs - 1, make_grid(blank(SAMPLE_N), nrow=grid_nrow(SAMPLE_N)).shape),
            ("render_denoise_strip", lambda p: render_denoise_strip(
                model, None, sched, out_path=p, **kw),
             T, make_grid(blank(20), nrow=20, padding=2).shape),
            ("render_denoise_strip_ddim", lambda p: render_denoise_strip_ddim(
                model, None, sched, out_path=p, steps=DDIM_STEPS, **kw),
             rungs, make_grid(blank(min(17, rungs)), nrow=min(17, rungs), padding=2).shape)]
    out = {}
    reset_counts()
    for name, fn, n_fwd, shape in jobs:
        path = os.path.join(tmp, f"{name}.png")
        before = seen[0]
        t0 = time.perf_counter()
        grid = fn(path)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        png = np.asarray(Image.open(path))
        want_png = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if (grid.shape != shape or png.shape != shape or not np.isfinite(grid).all()
                or grid.min() < 0.0 or grid.max() > 1.0 or not np.array_equal(png, want_png)
                or seen[0] - before != n_fwd):
            raise AssertionError(f"{name}: grid {grid.shape} (want {shape}), PNG {png.shape}, "
                                 f"range [{grid.min()}, {grid.max()}], "
                                 f"{seen[0] - before} forwards (want {n_fwd})")
        out[name] = dict(seconds=sec, forwards=n_fwd, forwards_per_s=n_fwd / sec,
                         shape=list(shape))
        log(f"[sample] {name}: {sec:.2f} s per grid, {n_fwd} U-Net forwards, "
            f"{n_fwd / sec:.1f} forwards/s; PNG {png.shape} as grid_nrow/make_grid say, "
            f"range [{grid.min():.3f}, {grid.max():.3f}]")
    counts = read_counts()
    got = {k: counts[k] for k in KERNELS}
    want = {k: 0 for k in KERNELS}
    want.update(gn_silu_fwd=GN_LAUNCHES_PER_FORWARD * seen[0],
                flash_attn_fwd=FLASH_LAUNCHES_PER_FORWARD * seen[0])
    if got != want:
        raise AssertionError(f"sampling launches {got}, expected {want}")
    log(f"[sample] from {RUN_PRESET}_last (EMA weights, step {meta['global_step']}): "
        f"{seen[0]} forwards, launches {got}")
    out["launches"] = got
    return out


# ------------------------------------------------------------------ solvers

SOLVER_STEPS = 20  # DPM-Solver++(2M): 19 forwards
REFRESH_EVERY = 2  # encoder-cached DDIM-50: 25 full + 24 decode forwards
STRENGTH = 0.6  # img2img: the last 30 rungs of the 50-rung ladder, 29 forwards
INPAINT_BOX = (16, 16, 48, 48)
RESAMPLES = 2  # inpaint: 49 steps x 2 repeats = 98 forwards
# 12 decoder ResBlocks x 2 GN+SiLU, and out_norm; the decoder has no attention
DECODE_GN_PER_FORWARD = 25
# max |cached - plain| DDIM-50 in [0, 1] pixels, from the same x_T: the bar
# tests/test_torch_fast_sampling.py holds refresh_every=2 to
CACHED_DIFF_BOUND = 0.25
SOLVER_PORT_WINDOW_S = 0.25  # the service's coalescing window here: the requests surely meet


def _forward_modes(model):
    """{"full": n, "decode": n, "batches": [...]} of ``model``'s forwards
    (its ``functional_call``s too), filled by a pre-hook."""
    seen = {"full": 0, "decode": 0, "batches": []}

    def hook(_m, args, kwargs):
        seen[kwargs.get("mode", "full")] += 1
        seen["batches"].append(args[0].shape[0])

    model.register_forward_pre_hook(hook, with_kwargs=True)
    return seen


def _window(model_seen, fn):
    """Counts set to 0 just before ``fn()`` and read just after; returns
    (fn's result, seconds, launches, full forwards, decode forwards)."""
    import torch

    f0, d0 = model_seen["full"], model_seen["decode"]
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return out, sec, read_counts(), model_seen["full"] - f0, model_seen["decode"] - d0


def check_launches(name, counts, full, decode=0, dec_smem=0, rows=BATCH):
    """Raise unless ``counts`` are exactly what ``full`` U-Net forwards at
    ``rows`` rows and ``decode`` decode forwards at BATCH launch: 45 GN and
    5 flash per full forward (a guided forward is ONE forward of the
    doubled batch), 25 GN per decode forward (``dec_smem`` of them in
    shared memory), on the routes the GN plan names, the flash forward on
    the tensor cores, no backward."""
    want = {k: 0 for k in KERNELS}
    want.update(gn_silu_fwd=GN_LAUNCHES_PER_FORWARD * full + DECODE_GN_PER_FORWARD * decode,
                flash_attn_fwd=FLASH_LAUNCHES_PER_FORWARD * full)
    got = {k: counts[k] for k in KERNELS}
    smem = GN_FWD_SMEM_PER_FORWARD[rows] * full + dec_smem * decode
    routes = (counts["gn_silu_fwd.smem"], counts["gn_silu_fwd.reread"])
    if (got != want or routes != (smem, want["gn_silu_fwd"] - smem)
            or counts["flash_attn_fwd.tc"] != want["flash_attn_fwd"]):
        raise AssertionError(f"{name}: launches {got} (GN routes {routes}, flash on the tensor "
                             f"cores {counts['flash_attn_fwd.tc']}), expected {want} after "
                             f"{full} forwards at {rows} rows and {decode} decode forwards "
                             f"({smem} GN in shared memory)")
    return dict(got, **{"gn_silu_fwd.smem": routes[0], "gn_silu_fwd.reread": routes[1]})


def _decode_checks(model):
    """The decode forward at BATCH: its recorded kernel calls against their
    plain versions (phase 3's tolerances), the whole decode forward on the
    kernels against the plain versions in fp32 and bf16 (phase 4's bars),
    decode of a forward's own features equal to that forward, and the
    decode and full forwards' wall and device times."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser

    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    t2 = (t - 20).clamp(min=0)  # the next rung of a 50-step ladder
    calls = []
    with torch.inference_mode():
        _, feats = model(x, t, return_features=True)
        with record_calls(calls):
            model(x, t2, mode="decode", cached=feats)
    torch.cuda.synchronize()
    gn = [c for c in calls if c[0] == "gn"]
    if len(gn) != DECODE_GN_PER_FORWARD or len(calls) != len(gn):
        raise AssertionError(f"a decode forward made {len(gn)} GN calls of {len(calls)}, "
                             f"expected {DECODE_GN_PER_FORWARD} and no attention")
    dec_smem = sum(_gn_fwd_plan(c, torch.bfloat16)[2] for c in gn)
    log(f"[solvers] a decode forward at batch {BATCH} calls gn_silu_fwd {len(gn)} times "
        f"({dec_smem} in shared memory by the plan) and flash_attn_fwd 0 times")
    with no_tf32():
        worst = hold_calls(calls, gen, label="decode path: ")
        model32 = UNetDenoiser(model.config, dtype=torch.float32, device="cuda")
        model32.load_state_dict(model.state_dict(), strict=True)
        model32 = model32.to(memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            _, f32 = model32(x, t, return_features=True)
            k32 = model32(x, t2, mode="decode", cached=f32)
            k16 = model(x, t2, mode="decode", cached=f32)
            with plain_path():
                p32 = model32(x, t2, mode="decode", cached=f32)
                p16 = model(x, t2, mode="decode", cached=f32)
            own = {}
            with cudnn_deterministic():
                for name, m in (("fp32", model32), ("bf16", model)):
                    full, f = m(x, t, return_features=True)
                    dec = m(x, t, mode="decode", cached=f)
                    own[name] = bool(torch.equal(dec, full))
                    if not all(v.dtype == m.dtype for v in (f[0], *f[1])):
                        raise AssertionError(f"{name}: the cache is not in the compute dtype")
        torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    err = {"fp32_kernel_vs_plain": rel(k32, p32), "bf16_kernel_vs_fp32": rel(k16, p32),
           "bf16_plain_vs_fp32": rel(p16, p32), "bf16_kernel_vs_plain": rel(k16, p16)}
    log(f"[solvers] decode forward on the card, relative RMS errors: {err}; decode of its "
        f"own features equals the full forward: {own}")
    if not all(own.values()):
        raise AssertionError(f"decode of a forward's own features differs from it: {own}")
    if not (torch.isfinite(k16).all() and torch.isfinite(k32).all()):
        raise AssertionError("decode forward on the kernels is not finite")
    if err["fp32_kernel_vs_plain"] > 1e-5:
        raise AssertionError(f"decode fp32 kernels vs plain: {err}")
    if err["bf16_kernel_vs_fp32"] > 1.25 * err["bf16_plain_vs_fp32"] + 1e-3:
        raise AssertionError(f"decode bf16 kernel path less accurate than plain: {err}")
    del model32
    times = {}
    with torch.inference_mode():
        for name, fn in (("full", lambda: model(x, t)),
                         ("decode", lambda: model(x, t2, mode="decode", cached=feats))):
            wall = cuda_time_ms(fn, iters=20)
            dev, table = device_ms(fn, iters=5)
            times[name] = dict(wall_ms=wall, device_ms=dev, device_ms_source=ms_source(table),
                               idle_share=idle_of(dev, wall, table),
                               gn_silu_fwd_ms=sum(ms for k, ms, _ in table
                                                  if "gn_silu_fwd" in k))
            log(f"[solvers] {name} forward batch {BATCH} bf16: wall {wall:.3f} ms, device "
                f"{dev:.3f} ms (gn_silu_fwd {times[name]['gn_silu_fwd_ms']:.4f}), device "
                f"idle {pct(times[name]['idle_share'])}")
    return dict(errors=err, own_features_equal=own, worst=worst, times=times,
                gn_calls=len(gn), gn_smem=dec_smem), dec_smem


def _png_ok(name, path, out, n):
    """The grid PNG at ``path`` against make_grid(nrow=grid_nrow(n)):
    ``out`` is the entry point's return, the (n, 64, 64, 3) [0, 1] batch or
    its grid; finite, in [0, 1], and the PNG its 8-bit image."""
    import numpy as np
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    shape = make_grid(np.zeros((n, 64, 64, 3), np.float32), nrow=grid_nrow(n)).shape
    grid = make_grid(out, nrow=grid_nrow(n)) if out.ndim == 4 else out
    png = np.asarray(Image.open(path))
    want = np.clip(grid * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if (out.ndim == 4 and out.shape != (n, 64, 64, 3)) or grid.shape != shape \
            or not np.isfinite(grid).all() or grid.min() < 0.0 or grid.max() > 1.0 \
            or png.shape != shape or not np.array_equal(png, want):
        raise AssertionError(f"{name}: output {out.shape} [{out.min()}, {out.max()}], "
                             f"PNG {png.shape} (make_grid gives {shape})")
    return list(shape)


def _solver_http(model, sched, ema_sd, dec_smem):
    """POST /edit and sampler=dpmpp through make_server over the EMA
    weights: coalescing per sampler, /edit's answers, /healthz."""
    import base64

    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
    from ddpm_diffusion_model_tpu_torch.utils.images import encode_png

    served = UNetDenoiser(model.config, dtype=torch.bfloat16, device="cuda")
    served.load_state_dict(ema_sd, strict=True)
    svc = SamplerService(served, sched, 64, device="cuda")
    svc.COALESCE_WINDOW_S = SOLVER_PORT_WINDOW_S
    seen = _forward_modes(svc.model)
    server = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    res = {}

    def sample(seed, sampler, n=8, steps=25):
        code, hdr, body = _get(f"{base}/sample?n={n}&steps={steps}&seed={seed}"
                               f"&sampler={sampler}&format=npy")
        x = np.load(io.BytesIO(body))
        if code != 200 or hdr["X-Used-N"] != str(n) or x.shape != (n, 64, 64, 3) \
                or not np.isfinite(x).all():
            raise AssertionError(f"sampler={sampler} seed {seed}: {code} {x.shape}")
        return x

    def post(body):
        req = urllib.request.Request(base + "/edit", data=json.dumps(body).encode(),
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()

    try:
        health = json.loads(_get(base + "/healthz")[2])
        if health["edit_modes"] != ["img2img", "inpaint"]:
            raise AssertionError(f"/healthz: {health}")

        def dpm_pair():
            m0 = svc.metrics()
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                futs = {s: ex.submit(sample, s, "dpmpp") for s in (1, 2)}
                merged = {s: f.result() for s, f in futs.items()}
            return merged, svc.metrics()["multi_request_batches"] - m0["multi_request_batches"]

        (merged, multi), sec_pair, counts, full, dec = _window(seen, dpm_pair)
        if multi != 1:
            raise AssertionError(f"two concurrent sampler=dpmpp requests made {multi} "
                                 "multi-request batches, expected 1")
        launches = check_launches("HTTP dpmpp pair", counts, full, dec, dec_smem)
        solo_err = max(float(np.abs(sample(s, "dpmpp") - merged[s]).max()) for s in (1, 2))
        if solo_err > 2e-2:
            raise AssertionError(f"coalesced dpmpp vs solo: max diff {solo_err}")
        log(f"[solvers] HTTP: 2 concurrent sampler=dpmpp requests (n=8, 25 steps) coalesced "
            f"into 1 batch of 16 in {sec_pair:.2f} s ({full} forwards, launches "
            f"{launches['gn_silu_fwd']}/{launches['flash_attn_fwd']}); vs their solo re-runs "
            f"max |diff| {solo_err:.3e} in [0,1] pixels")
        m0 = svc.metrics()
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            fd = ex.submit(sample, 3, "ddim")
            fp = ex.submit(sample, 3, "dpmpp")
            fd.result(), fp.result()
        m1 = svc.metrics()
        mixed = (m1["coalesced_batches"] - m0["coalesced_batches"],
                 m1["multi_request_batches"] - m0["multi_request_batches"])
        if mixed != (2, 0):
            raise AssertionError(f"a DDIM and a DPM request in one window: (batches, "
                                 f"multi-request batches) {mixed}, expected (2, 0)")
        log("[solvers] HTTP: a DDIM and a DPM request in one window ran as 2 batches, "
            "none shared")
        face = _faces(1)[0] * 0.5 + 0.5
        img = base64.b64encode(encode_png(face)).decode()
        edits = {}
        for mode, body in (("img2img", {"mode": "img2img", "strength": STRENGTH, "n": 4,
                                        "steps": 50}),
                           ("inpaint", {"mode": "inpaint", "box": list(INPAINT_BOX), "n": 4,
                                        "steps": 10, "resamples": RESAMPLES})):
            t0 = time.perf_counter()
            code, hdr, out = post(dict(body, image=img, seed=7, format="npy"))
            sec = time.perf_counter() - t0
            x = np.load(io.BytesIO(out)) if code == 200 else None
            if (code != 200 or hdr.get("X-Used-N") != "4"
                    or hdr.get("X-Used-Steps") != str(body["steps"])
                    or x.shape != (4, 64, 64, 3) or not np.isfinite(x).all()):
                raise AssertionError(f"POST /edit {mode}: {code} {hdr} {out[:200]!r}")
            edits[mode] = dict(code=code, seconds=sec, used_n=hdr["X-Used-N"],
                               used_steps=hdr["X-Used-Steps"])
            log(f"[solvers] HTTP: POST /edit {mode} -> 200, X-Used-N {hdr['X-Used-N']}, "
                f"X-Used-Steps {hdr['X-Used-Steps']}, {sec:.2f} s")
        code, _h, out = post({"image": img, "mode": "inpaint", "box": [40, 8, 20, 30]})
        if code != 400 or "out of bounds" not in json.loads(out)["error"]:
            raise AssertionError(f"POST /edit with a bad box: {code} {out[:200]!r}")
        edits["bad_box"] = dict(code=code)
        log("[solvers] HTTP: POST /edit with a bad box -> 400")
        metrics = svc.metrics()
        if metrics["edits"] != 2:
            raise AssertionError(f"/metrics edits {metrics['edits']}, expected 2")
        res.update(dpmpp_pair=dict(seconds=sec_pair, launches=launches, forwards=full,
                                   solo_err=solo_err), mixed_batches=mixed, edits=edits,
                   healthz_edit_modes=health["edit_modes"])
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    return res


def _faces(n):
    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array

    return blob_faces_array(n, img_size=64, seed=11)


def phase_solvers(preset, ckpt_dir, tmp):
    """DPM-Solver++, encoder-cached DDIM and editing on celeba64_attn at
    full width from the run's _last checkpoint (EMA weights), bf16, T =
    1000, batch 16: (a) the decode forward, kernels against plain; (b)
    DPM-Solver++(2M) 20 steps, ODE and SDE; (c) encoder-cached DDIM-50 at
    refresh_every=2 against plain DDIM-50 from the same x_T; (d) img2img at
    strength 0.6 and inpaint with a box at resamples=2; (e) sampler=dpmpp
    and POST /edit through make_server; (f) the CLI commands.  Every path's
    launches exact, its counts set to 0 just before it and read just after."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import (box_mask, ddim_sample,
                                                         ddim_sample_fast,
                                                         dpmpp_infer_sample,
                                                         img2img_infer_sample,
                                                         inpaint_infer_sample,
                                                         to_unit_interval)
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, load_checkpoint
    from ddpm_diffusion_model_tpu_torch.utils.images import save_image

    last = os.path.join(ckpt_dir, f"{RUN_PRESET}_last")
    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
    model = model.to(memory_format=torch.channels_last)
    state, meta = load_checkpoint(last, init_train_state(model, preset.train)[0],
                                  components=("params", "ema_params"))
    ema_sd = {k: v.detach().clone() for k, v in state.ema_params.items()}
    model.load_state_dict(ema_sd, strict=True)
    model.eval()
    sched = make_schedule(preset.diffusion, device="cuda")
    res = {"checkpoint_step": meta["global_step"]}

    # (a) the decode forward
    res["decode"], dec_smem = _decode_checks(model)
    worst = res["decode"].pop("worst")
    seen = _forward_modes(model)
    S, n = preset.img_size, SAMPLE_N
    kw = dict(n=n, seed=3, device="cuda")

    # (b) DPM-Solver++(2M), ODE and SDE
    paths = {}
    for name, sde in (("dpmpp", False), ("dpmpp_sde", True)):
        png = os.path.join(tmp, f"{name}.png")
        grid, sec, counts, full, dec = _window(seen, lambda: dpmpp_infer_sample(
            model, None, sched, img_size=S, steps=SOLVER_STEPS, sde=sde, out_path=png, **kw))
        if (full, dec) != (SOLVER_STEPS - 1, 0):
            raise AssertionError(f"{name}: {full} full and {dec} decode forwards")
        launches = check_launches(name, counts, full, dec, dec_smem)
        paths[name] = dict(seconds=sec, forwards=full, forwards_per_s=full / sec,
                           launches=launches, png=_png_ok(name, png, grid, n))
        log(f"[solvers] {name} {SOLVER_STEPS} steps, n={n}: {sec:.2f} s, {full} forwards "
            f"({full / sec:.1f}/s); launches gn_silu_fwd {launches['gn_silu_fwd']}, "
            f"flash_attn_fwd {launches['flash_attn_fwd']}; PNG {paths[name]['png']} as "
            "grid_nrow/make_grid give")

    # (c) encoder-cached DDIM-50 against plain DDIM-50 from the same x_T
    ddim_kw = dict(img_size=S, steps=DDIM_STEPS, **kw)
    cached = lambda p=None: ddim_sample_fast(  # noqa: E731
        model, None, sched, refresh_every=REFRESH_EVERY, schedule_kind="t_linear",
        save_path=p, **ddim_kw)
    plain = lambda: ddim_sample(model, None, sched, schedule="t_linear",  # noqa: E731
                                **ddim_kw)
    png = os.path.join(tmp, "ddim_cached.png")
    xc, sec_c, counts, full, dec = _window(seen, lambda: cached(png))
    want = (-(-(DDIM_STEPS - 1) // REFRESH_EVERY), (DDIM_STEPS - 1) // REFRESH_EVERY)
    if (full, dec) != want:
        raise AssertionError(f"cached DDIM: {full} full and {dec} decode forwards, "
                             f"expected {want}")
    paths["ddim_cached"] = dict(seconds=sec_c, full=full, decode=dec,
                                launches=check_launches("cached DDIM", counts, full, dec,
                                                        dec_smem),
                                png=_png_ok("cached DDIM", png, xc, n))
    xp, sec_p, counts, full, dec = _window(seen, plain)
    if (full, dec) != (DDIM_STEPS - 1, 0):
        raise AssertionError(f"plain DDIM: {full} full and {dec} decode forwards")
    paths["ddim_plain"] = dict(seconds=sec_p, full=full,
                               launches=check_launches("plain DDIM", counts, full, dec,
                                                       dec_smem))
    diff = float(np.abs(xc - xp).max())
    mean_diff = float(np.abs(xc - xp).mean())
    with torch.inference_mode():
        dev_c, table_c = device_ms(lambda: cached(), iters=1, warmup=0)
        dev_p, table_p = device_ms(plain, iters=1, warmup=0)
    paths["ddim_cached"].update(device_ms=dev_c, device_ms_source=ms_source(table_c),
                                max_abs_diff_vs_plain=diff, mean_abs_diff_vs_plain=mean_diff)
    paths["ddim_plain"].update(device_ms=dev_p, device_ms_source=ms_source(table_p))
    log(f"[solvers] DDIM-50 n={n}: encoder-cached 1/{REFRESH_EVERY} wall {sec_c:.2f} s, "
        f"device {dev_c:.1f} ms, {paths['ddim_cached']['full']} full + "
        f"{paths['ddim_cached']['decode']} decode forwards, launches "
        f"{paths['ddim_cached']['launches']['gn_silu_fwd']}/"
        f"{paths['ddim_cached']['launches']['flash_attn_fwd']}; plain wall {sec_p:.2f} s, "
        f"device {dev_p:.1f} ms, launches {paths['ddim_plain']['launches']['gn_silu_fwd']}/"
        f"{paths['ddim_plain']['launches']['flash_attn_fwd']}; cached vs plain max |diff| "
        f"{diff:.4f} (mean {mean_diff:.5f}) in [0,1] pixels (bar {CACHED_DIFF_BOUND})")
    if diff > CACHED_DIFF_BOUND:
        raise AssertionError(f"cached vs plain DDIM-50: max |diff| {diff} > "
                             f"{CACHED_DIFF_BOUND}")

    # (d) img2img and inpaint of blob faces
    faces = _faces(n)
    png = os.path.join(tmp, "img2img.png")
    x, sec, counts, full, dec = _window(seen, lambda: img2img_infer_sample(
        model, None, sched, faces, strength=STRENGTH, steps=DDIM_STEPS, out_path=png,
        **kw))
    rungs = len(ddim_ladder(sched, "t_linear"))
    if (full, dec) != (int(round(STRENGTH * rungs)) - 1, 0):
        raise AssertionError(f"img2img: {full} full and {dec} decode forwards")
    paths["img2img"] = dict(seconds=sec, forwards=full,
                            launches=check_launches("img2img", counts, full, dec, dec_smem),
                            png=_png_ok("img2img", png, x, n))
    mask = box_mask(S, INPAINT_BOX)
    png = os.path.join(tmp, "inpaint.png")
    x, sec, counts, full, dec = _window(seen, lambda: inpaint_infer_sample(
        model, None, sched, faces, mask, steps=DDIM_STEPS, resamples=RESAMPLES,
        out_path=png, **kw))
    if (full, dec) != ((rungs - 1) * RESAMPLES, 0):
        raise AssertionError(f"inpaint: {full} full and {dec} decode forwards")
    keep = np.broadcast_to(mask, x.shape) == 1.0
    known = to_unit_interval(torch.from_numpy(faces).cuda()).cpu().numpy()
    if not np.array_equal(x[keep], known[keep]):
        raise AssertionError("inpaint: the known region differs from the input")
    paths["inpaint"] = dict(seconds=sec, forwards=full, known_region_bit_equal=True,
                            launches=check_launches("inpaint", counts, full, dec, dec_smem),
                            png=_png_ok("inpaint", png, x, n))
    for name in ("img2img", "inpaint"):
        p = paths[name]
        log(f"[solvers] {name} n={n}: {p['seconds']:.2f} s, {p['forwards']} forwards, "
            f"launches {p['launches']['gn_silu_fwd']}/{p['launches']['flash_attn_fwd']}"
            + ("; known region bit-equal to the input" if name == "inpaint" else ""))

    # (e) HTTP
    res["http"] = _solver_http(model, sched, ema_sd, dec_smem)

    # (f) the CLI commands from the checkpoint
    save_image(faces[0] * 0.5 + 0.5, os.path.join(tmp, "face.png"))
    cli_jobs = [("sample-dpmpp", ["--steps", str(SOLVER_STEPS)], SOLVER_STEPS - 1, 0),
                ("sample-dpmpp", ["--steps", str(SOLVER_STEPS), "--sde"], SOLVER_STEPS - 1, 0),
                ("img2img", ["--init", "face.png", "--strength", str(STRENGTH)],
                 int(round(STRENGTH * rungs)) - 1, 0),
                ("inpaint", ["--init", "face.png", "--box", ",".join(map(str, INPAINT_BOX)),
                             "--resamples", str(RESAMPLES)], (rungs - 1) * RESAMPLES, 0),
                ("sample-ddim", ["--steps", str(DDIM_STEPS), "--refresh-every",
                                 str(REFRESH_EVERY)], *want)]
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    shape = make_grid(np.zeros((n, S, S, 3), np.float32), nrow=grid_nrow(n)).shape
    cmds, full_all, dec_all = [], 0, 0
    reset_counts()
    for i, (cmd, extra, full, dec) in enumerate(cli_jobs):
        png = os.path.join(tmp, f"cli_{i}.png")
        t0 = time.perf_counter()
        with _cwd(tmp):
            out = run_cli([cmd, "--preset", RUN_PRESET, "--ckpt", last, "--ema", "--n",
                           str(n), *extra, "--out", png])
        sec = time.perf_counter() - t0
        got = np.asarray(Image.open(png)).shape
        if got != shape:
            raise AssertionError(f"cli {cmd}: PNG {got}, make_grid gives {shape}")
        full_all, dec_all = full_all + full, dec_all + dec
        cmds.append(dict(cmd=" ".join([cmd, *extra]), exit=0, seconds=sec, png=list(got),
                         said=out.strip().splitlines()[-1]))
        log(f"[solvers] cli {cmd} {' '.join(extra)}: exit 0, PNG {got} as make_grid gives, "
            f"{sec:.2f} s")
    res["cli"] = dict(commands=cmds, launches=check_launches(
        "the CLI commands", read_counts(), full_all, dec_all, dec_smem))
    res["paths"] = paths
    launches = {k: {p: v["launches"][k] for p, v in paths.items()} for k in KERNELS}
    for k in KERNELS:
        launches[k].update(http_dpmpp_pair=res["http"]["dpmpp_pair"]["launches"][k],
                           cli=res["cli"]["launches"][k])
    res["launches"] = launches
    log(f"[solvers] launches by path (gn_silu_fwd, flash_attn_fwd): " + ", ".join(
        f"{p} {launches['gn_silu_fwd'][p]}/{launches['flash_attn_fwd'][p]}"
        for p in launches["gn_silu_fwd"]))
    return res, worst


# ------------------------------------------- class conditioning and guidance

NUM_CLASSES = 10
CFG_PARAMS = 31_312_131 + (NUM_CLASSES + 1) * 512  # the table: 10 classes + NULL
GUIDANCE = 3.0
# (e) a coalesced request against its re-run beside another request, at the
# same rows in a batch of the same shape: the same kernels on the same bits
PAIR_BAR = 1e-5
PAIR_CONTROL = 100  # the labels swapped must move the rows by 100 x PAIR_BAR
RERUN_COMPANY = (9, 5)  # (seed, class) of the re-runs' other request
# (d) the conditional bound on the card (fp32, guidance 1, as ``eval --nll``
# scores it) on injected timesteps and noises: t = 0's decoder term and t
# up to 999, where predict_x0 divides by sqrt(ab_t) ~ 0.0064
NLL_CHECK_N, NLL_CHECK_TS = 4, (0, 1, 10, 100, 500, 900, 999)
NLL_PLAIN_BAR = 1e-4  # relative, per image: the kernels against the plain versions
NLL_CPU_BAR = 1e-3  # relative, per image: the card against a CPU copy (erf differs)
CFG_CLI_BATCHES = 3  # --max-batches of the conditional CLI run
CFG_SAMPLE_N = NUM_CLASSES  # its class-cycled grid: one image of each class
NLL_MC_T, NLL_MC_N, NLL_FULL_N = 50, 16, 8


def cond_experiment(preset):
    """``celeba64_attn``'s experiment with ``model.num_classes = 10``, as the
    JSON a user passes with ``--config`` (the run's grid cut to 10 images,
    one per class, for the card's time)."""
    d = preset.to_dict()
    d["model"]["num_classes"] = NUM_CLASSES
    d.update(run_name="celeba64_attn_cond", sample_n=CFG_SAMPLE_N)
    return d


def build_cond_model(cond, base_sd):
    """The conditional U-Net at full width: ``base_sd`` and a seeded class
    table (scaled so the classes visibly differ); bf16 compute,
    channels_last, eval mode."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser, count_params

    torch.manual_seed(7)
    model = UNetDenoiser(cond.model, dtype=torch.bfloat16, device="cuda")
    n = count_params(model)
    if n != CFG_PARAMS:
        raise AssertionError(f"celeba64_attn with {NUM_CLASSES} classes has {n} params, "
                             f"expected {CFG_PARAMS:,}")
    model.load_state_dict({**model.state_dict(), **base_sd}, strict=True)
    with torch.no_grad():
        model.class_emb.weight.mul_(8.0)
    return model.to(memory_format=torch.channels_last).eval()


def _cfg_forward_checks(model, sched):
    """(a) At BATCH: the conditional forward (labels 0-9 and NULL) and the
    guided eps (guidance 3, one forward of 2 x BATCH rows) on the kernels
    against the plain versions, fp32 and bf16 at phase 4's bars; every
    kernel call of the guided forward against its plain version (phase 3's
    tolerances, each GN call on its plan's route); its launches; guided and
    unguided wall and device time."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.sampling import cfg_eps_fn

    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    y = torch.arange(BATCH, device="cuda") % (NUM_CLASSES + 1)  # 0-9 and NULL
    guided = lambda m: cfg_eps_fn(m, sched, y=y, guidance=GUIDANCE)(x, t)  # noqa: E731
    calls = []
    with torch.inference_mode(), record_calls(calls):
        guided(model)
    torch.cuda.synchronize()
    gn = [c for c in calls if c[0] == "gn"]
    fl = [c for c in calls if c[0] == "flash_attn_fwd"]
    if (len(gn), len(fl), len(calls)) != (GN_LAUNCHES_PER_FORWARD, FLASH_LAUNCHES_PER_FORWARD,
                                          len(gn) + len(fl)) \
            or {c[1][0] for c in gn} != {2 * BATCH} or {c[1][0] for c in fl} != {8 * BATCH}:
        raise AssertionError(f"a guided forward at n={BATCH} made {len(gn)} GN and {len(fl)} "
                             f"flash calls of {len(calls)} (GN batches "
                             f"{sorted({c[1][0] for c in gn})})")
    with no_tf32():
        worst = hold_calls(calls, gen, label="cfg guided forward: ")
        model32 = UNetDenoiser(model.config, dtype=torch.float32, device="cuda")
        model32.load_state_dict(model.state_dict(), strict=True)
        model32 = model32.to(memory_format=torch.channels_last).eval()
        outs = {}
        with torch.inference_mode():
            for name, run in (("conditional", lambda m: m(x, t, y)), ("guided", guided)):
                k32, k16 = run(model32), run(model)
                with plain_path():
                    p32, p16 = run(model32), run(model)
                outs[name] = (k32, k16, p32, p16)
            null = model(x, t)
        torch.cuda.synchronize()

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    errs = {}
    for name, (k32, k16, p32, p16) in outs.items():
        e = {"fp32_kernel_vs_plain": rel(k32, p32), "bf16_kernel_vs_fp32": rel(k16, p32),
             "bf16_plain_vs_fp32": rel(p16, p32), "bf16_kernel_vs_plain": rel(k16, p16)}
        errs[name] = e
        if not (torch.isfinite(k16).all() and torch.isfinite(k32).all()):
            raise AssertionError(f"{name} forward on the kernels is not finite")
        if e["fp32_kernel_vs_plain"] > 1e-5:
            raise AssertionError(f"{name} fp32 kernels vs plain: {e}")
        if e["bf16_kernel_vs_fp32"] > 1.25 * e["bf16_plain_vs_fp32"] + 1e-3:
            raise AssertionError(f"{name} bf16 kernel path less accurate than plain: {e}")
    label_effect = rel(outs["conditional"][1], null)
    log(f"[cfg] (a) the conditional forward (labels 0-9 and NULL) and the guided eps (w "
        f"{GUIDANCE}, {2 * BATCH} rows) on the card, relative RMS errors: {errs}; the labels "
        f"move the bf16 output by {label_effect:.3e} (relative RMS) from the NULL forward")
    if label_effect < 1e-3:
        raise AssertionError(f"the labels barely move the forward: {label_effect}")
    del model32
    reset_counts()
    with torch.inference_mode():
        guided(model)
    torch.cuda.synchronize()
    launches = check_launches("one guided eps", read_counts(), 1, rows=2 * BATCH)
    log(f"[cfg] (a) one guided eps at n={BATCH}: launches gn_silu_fwd "
        f"{launches['gn_silu_fwd']} ({launches['gn_silu_fwd.smem']} in shared memory, as "
        f"the plan gives at {2 * BATCH} rows), flash_attn_fwd {launches['flash_attn_fwd']}: "
        "one forward")
    times = {}
    with torch.inference_mode():
        for name, fn in (("unguided", lambda: model(x, t)), ("guided", lambda: guided(model))):
            wall = cuda_time_ms(fn, iters=20)
            dev, table = device_ms(fn, iters=5)
            times[name] = dict(wall_ms=wall, device_ms=dev, device_ms_source=ms_source(table),
                               idle_share=idle_of(dev, wall, table))
            log(f"[cfg] (a) {name} eps at n={BATCH} bf16: wall {wall:.3f} ms, device "
                f"{dev:.3f} ms, device idle {pct(times[name]['idle_share'])}")
    return dict(errors=errs, label_effect=label_effect, launches=launches, times=times), worst


def _cond_step_calls(model, sched, images, labels):
    """Every kernel-wrapper call of one conditional train step's forward
    and backward at TRAIN_BATCH (dropout on); the weights are left."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import draw_step_inputs, make_loss_fn

    calls = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.from_numpy(images[:TRAIN_BATCH]).cuda()
    y = torch.from_numpy(labels[:TRAIN_BATCH]).cuda()
    d = draw_step_inputs(gen, x.shape, sched.T, "cuda", cond_dropout=0.1)
    model.train()
    with record_calls(calls):
        make_loss_fn(model, sched)((x, y), d).backward()
    torch.cuda.synchronize()
    model.eval()
    for p in model.parameters():
        p.grad = None
    return calls


def phase_cfg(preset, base_sd, images, tmp):
    """Class conditioning and classifier-free guidance on celeba64_attn with
    10 classes at full width: (a) the conditional and the guided forward
    against the plain versions, every kernel call of the guided forward;
    (b) a conditional train step on injected (t, noise, drop) against the
    plain versions, every kernel call of the step, 20 steps of
    train_one_epoch; (c) ``cli train --config cond.json --data blobs
    --device-cache``; (d) sampling and editing from its checkpoint at
    guidance 1 and 3; (e) the server; (f) the CLI's class flags and ``eval
    --nll``.  Launches exact on every path, its counts set to 0 just before
    it and read just after."""
    import numpy as np
    import torch
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import (box_mask, ddim_infer_sample,
                                                         ddpm_infer_sample,
                                                         dpmpp_infer_sample,
                                                         img2img_infer_sample,
                                                         inpaint_infer_sample)
    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, load_checkpoint,
                                                         read_meta)
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid, save_image

    exp_d = cond_experiment(preset)
    cond = ExperimentConfig.from_dict(exp_d)
    sched = make_schedule(cond.diffusion, device="cuda")
    res = {"params": CFG_PARAMS}
    labels = (np.arange(len(images)) % NUM_CLASSES).astype(np.int64)

    # (a) the forwards
    model = build_cond_model(cond, base_sd)
    cond_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res["forward"], worst = _cfg_forward_checks(model, sched)

    # (b) the train step: parity, its kernel calls, 20 steps
    torch.cuda.empty_cache()
    res["step_parity"] = phase_train_parity(cond, cond_sd, images, labels, tag="cfg")
    torch.backends.cudnn.allow_tf32 = True  # the library default, as phase 6c
    calls = _cond_step_calls(model, sched, images, labels)
    with no_tf32():
        step_worst = hold_calls(calls, torch.Generator(device="cuda").manual_seed(32),
                                label="cfg conditional step: ")
    worst = {k: max(worst[k], step_worst[k]) for k in KERNELS}
    train_model = build_cond_model(cond, base_sd)
    res["train"] = phase_train_epoch(cond, train_model, images, labels, tag="cfg")
    del train_model, model
    torch.cuda.empty_cache()

    # (c) the CLI trains a conditional model from labelled blob faces on the card
    cfg_json = os.path.join(tmp, "cond.json")
    with open(cfg_json, "w") as f:
        json.dump(exp_d, f)
    ck = os.path.join(tmp, "ck_cond")
    size = CFG_CLI_BATCHES * TRAIN_BATCH
    n_eval = max(size // 8 // TRAIN_BATCH, 1) * TRAIN_BATCH  # the CLI's held-out set
    argv = ["train", "--config", cfg_json, "--data", "blobs", "--synthetic-size", str(size),
            "--device-cache", "--eval-every", "1", "--max-batches", str(CFG_CLI_BATCHES),
            "--ckpt-dir", ck]
    reset_counts()
    t0 = time.perf_counter()
    with _cwd(tmp):
        out1 = run_cli([*argv, "--epochs", "1", "--no-samples"])
        out2 = run_cli([*argv, "--epochs", "2", "--resume", "auto"])
    sec = time.perf_counter() - t0
    counts = read_counts()
    steps = 2 * CFG_CLI_BATCHES
    evals = 2 * 2 * (n_eval // TRAIN_BATCH)  # raw and EMA, each epoch
    sample_fwd = cond.diffusion.T  # the class-cycled DDPM grid after epoch 2
    fwd = steps + evals + sample_fwd
    want = {"gn_silu_fwd": GN_LAUNCHES_PER_FORWARD * fwd,
            "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD * fwd,
            "gn_silu_bwd": GN_LAUNCHES_PER_FORWARD * steps,
            "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD * steps,
            "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD * steps}
    got = {k: counts[k] for k in KERNELS}
    last = os.path.join(ck, f"{exp_d['run_name']}_last")
    exp_back = ExperimentConfig.from_dict(read_meta(last)["configs"]["experiment"])
    grid_png = os.path.join(ck, f"{exp_d['run_name']}_samples_e001.png")
    final = json.loads(out2.strip().splitlines()[-1])
    grid_shape = make_grid(np.zeros((CFG_SAMPLE_N, 64, 64, 3), np.float32),
                           nrow=int(CFG_SAMPLE_N ** 0.5)).shape
    if (got != want or exp_back.model.num_classes != NUM_CLASSES
            or "[RESUME] auto -> " not in out2 or "[EVAL]" not in out1
            or out2.count("[EVAL]") != 1 or not os.path.exists(grid_png)
            or np.asarray(Image.open(grid_png)).shape != grid_shape
            or not np.isfinite(final["final_loss"]) or "rfid_last" not in final):
        raise AssertionError(f"cli train (conditional): launches {got} (want {want}), "
                             f"num_classes {exp_back.model.num_classes}, result {final}")
    res["cli_train"] = dict(seconds=sec, steps=steps, eval_forwards=evals,
                            sample_forwards=sample_fwd, launches=got,
                            final_loss=final["final_loss"], rfid=final["rfid_last"])
    log(f"[cfg] (c) cli train --config cond.json --data blobs --device-cache: 2 epochs of "
        f"{CFG_CLI_BATCHES} steps at batch {TRAIN_BATCH} (the second resumed), the eval "
        f"pass each epoch, the class-cycled DDPM grid of {CFG_SAMPLE_N} after the last "
        f"({sample_fwd} forwards): {sec:.1f} s, launches {got}, final loss "
        f"{final['final_loss']:.5f}, rFID {final['rfid_last']:.3f}; its _last rebuilds "
        f"num_classes {exp_back.model.num_classes}")

    # (d) sampling and editing from that checkpoint (EMA weights), n = 16
    model = UNetDenoiser(exp_back.model, dtype=torch.bfloat16, device="cuda")
    model = model.to(memory_format=torch.channels_last)
    state, _meta = load_checkpoint(last, init_train_state(model, exp_back.train)[0],
                                   components=("params", "ema_params"))
    ema_sd = {k: v.detach().clone() for k, v in state.ema_params.items()}
    model.load_state_dict(ema_sd, strict=True)
    model.eval()
    del state
    seen = _forward_modes(model)
    n, S = SAMPLE_N, 64
    faces = _faces(n)
    mask = box_mask(S, INPAINT_BOX)
    rungs = len(ddim_ladder(sched, "t_linear"))
    cls_all = np.arange(n) % NUM_CLASSES
    kw = dict(seed=3, device="cuda")
    jobs = [
        ("ddim50", DDIM_STEPS - 1, lambda g, p: ddim_infer_sample(
            model, None, sched, n=n, img_size=S, steps=DDIM_STEPS, class_id=cls_all,
            guidance=g, out_path=p, **kw)),
        ("dpmpp20", SOLVER_STEPS - 1, lambda g, p: dpmpp_infer_sample(
            model, None, sched, n=n, img_size=S, steps=SOLVER_STEPS, class_id=cls_all,
            guidance=g, out_path=p, **kw)),
        ("dpmpp20_sde", SOLVER_STEPS - 1, lambda g, p: dpmpp_infer_sample(
            model, None, sched, n=n, img_size=S, steps=SOLVER_STEPS, class_id=cls_all,
            guidance=g, sde=True, out_path=p, **kw)),
        ("img2img", int(round(STRENGTH * rungs)) - 1, lambda g, p: img2img_infer_sample(
            model, None, sched, faces, strength=STRENGTH, steps=DDIM_STEPS, class_id=2,
            guidance=g, out_path=p, **kw)),
        ("inpaint", (rungs - 1) * RESAMPLES, lambda g, p: inpaint_infer_sample(
            model, None, sched, faces, mask, steps=DDIM_STEPS, resamples=RESAMPLES,
            class_id=2, guidance=g, out_path=p, **kw)),
    ]
    paths, grids = {}, {}
    for guidance in (1.0, GUIDANCE):
        rows = n if guidance == 1.0 else 2 * n
        for name, forwards, run in jobs:
            key = f"{name}_g{guidance:g}"
            png = os.path.join(tmp, f"cfg_{key}.png")
            b0 = len(seen["batches"])
            out, sec, counts, full, dec = _window(seen, lambda: run(guidance, png))
            if (full, dec) != (forwards, 0) or set(seen["batches"][b0:]) != {rows}:
                raise AssertionError(f"{key}: {full} full and {dec} decode forwards at "
                                     f"{sorted(set(seen['batches'][b0:]))} rows")
            paths[key] = dict(seconds=sec, forwards=full, rows=rows,
                              launches=check_launches(key, counts, full, rows=rows),
                              png=_png_ok(key, png, out, n))
            grids[key] = out
            if name in ("ddim50", "dpmpp20", "img2img"):
                with torch.inference_mode():
                    dev, table = device_ms(lambda: run(guidance, None if name == "img2img"
                                                       else png), iters=1, warmup=0)
                paths[key].update(device_ms=dev, device_ms_source=ms_source(table))
            p = paths[key]
            log(f"[cfg] (d) {key} n={n} ({rows} rows a forward): {sec:.2f} s"
                + (f", device {p['device_ms']:.1f} ms" if "device_ms" in p else "")
                + f", {full} forwards, launches {p['launches']['gn_silu_fwd']}/"
                f"{p['launches']['flash_attn_fwd']}")
    for name, _f, _r in jobs:
        g1, g3 = paths[f"{name}_g1"]["launches"], paths[f"{name}_g{GUIDANCE:g}"]["launches"]
        if {k: g1[k] for k in KERNELS} != {k: g3[k] for k in KERNELS}:
            raise AssertionError(f"{name}: launches at guidance {GUIDANCE} {g3}, at 1 {g1}")
    diff = float(np.abs(grids[f"ddim50_g{GUIDANCE:g}"] - grids["ddim50_g1"]).max())
    if diff < 1e-3:
        raise AssertionError(f"guidance {GUIDANCE} leaves the DDIM grid as it was: {diff}")
    keep = np.broadcast_to(mask, grids[f"inpaint_g{GUIDANCE:g}"].shape) == 1.0
    if not np.allclose(grids[f"inpaint_g{GUIDANCE:g}"][keep], ((faces + 1.0) / 2.0)[keep],
                       atol=1e-6):
        raise AssertionError("guided inpaint: the known region differs from the input")
    png = os.path.join(tmp, "cfg_ddpm_all.png")
    out, sec, counts, full, dec = _window(seen, lambda: ddpm_infer_sample(
        model, None, sched, n=n, img_size=S, class_id=cls_all, guidance=GUIDANCE,
        out_path=png, **kw))
    if (full, dec) != (sched.T, 0):
        raise AssertionError(f"ddpm_infer_sample: {full} forwards")
    paths["ddpm_all"] = dict(seconds=sec, forwards=full, rows=2 * n,
                             launches=check_launches("ddpm all", counts, full, rows=2 * n),
                             png=_png_ok("ddpm all", png, out, n))
    log(f"[cfg] (d) ddpm_infer_sample class_id all (0-9 cycled), w {GUIDANCE}, n={n}: "
        f"{sec:.2f} s, {full} forwards at {2 * n} rows, launches "
        f"{paths['ddpm_all']['launches']['gn_silu_fwd']}/"
        f"{paths['ddpm_all']['launches']['flash_attn_fwd']}; the guided DDIM-50 grid "
        f"against the unguided one: max |diff| {diff:.3f}")
    res["paths"] = paths
    res["nll_check"] = _cfg_nll_check(exp_back, ema_sd, faces)
    del model
    torch.cuda.empty_cache()

    # (e) the server
    res["http"] = _cfg_http(exp_back, sched, ema_sd)

    # (f) the CLI
    save_image(faces[0] * 0.5 + 0.5, os.path.join(tmp, "face.png"))
    shape = make_grid(np.zeros((n, S, S, 3), np.float32), nrow=grid_nrow(n)).shape
    cli_jobs = [("sample-ddim", ["--class-id", "all", "--guidance", f"{GUIDANCE:g}", "--n",
                                 str(n), "--steps", str(DDIM_STEPS)]),
                ("sample-dpmpp", ["--class-id", "2", "--n", str(n), "--steps",
                                  str(SOLVER_STEPS)]),
                ("img2img", ["--init", "face.png", "--class-id", "1", "--n", str(n),
                             "--strength", str(STRENGTH)])]
    cmds = {}
    for i, (cmd, extra) in enumerate(cli_jobs):
        png = os.path.join(tmp, f"cfg_cli_{i}.png")
        t0 = time.perf_counter()
        with _cwd(tmp):
            said = run_cli([cmd, "--ckpt", last, "--ema", *extra, "--out", png])
        sec = time.perf_counter() - t0
        got_shape = np.asarray(Image.open(png)).shape
        if got_shape != shape or "(class=" not in said:
            raise AssertionError(f"cli {cmd}: PNG {got_shape} (make_grid gives {shape}), "
                                 f"said {said[-300:]!r}")
        cmds[f"{cmd} {' '.join(extra)}"] = dict(exit=0, seconds=sec, png=list(got_shape))
        log(f"[cfg] (f) cli {cmd} {' '.join(extra)}: exit 0, PNG {got_shape} as make_grid "
            f"gives, {sec:.2f} s")
    for extra, key, m in ((["--nll", str(NLL_MC_T), "--nll-n", str(NLL_MC_N)],
                           f"nll_bpd_mc{NLL_MC_T}", NLL_MC_N),
                          (["--nll-full", "--nll-n", str(NLL_FULL_N)], "nll_bpd_full",
                           NLL_FULL_N)):
        t0 = time.perf_counter()
        with _cwd(tmp):
            ev = json.loads(run_cli(["eval", "--ckpt", last, "--data", "blobs", "--eval-size",
                                     str(TRAIN_BATCH), "--rfid-n", "0", *extra]
                                    ).strip().splitlines()[-1])
        sec = time.perf_counter() - t0
        if (not np.isfinite(ev.get(key, np.nan)) or ev[key] <= 0 or ev["nll_n"] != m
                or ev["nll_conditional"] is not True):
            raise AssertionError(f"eval {' '.join(extra)}: {ev}")
        cmds[f"eval {' '.join(extra)}"] = dict(exit=0, seconds=sec, bits_per_dim=ev[key],
                                               val_loss=ev["val_loss"])
        log(f"[cfg] (f) cli eval {' '.join(extra)}: exit 0, {key} {ev[key]:.4f} bits/dim "
            f"over {m} labelled images (the conditional bound), val_loss "
            f"{ev['val_loss']:.5f}, {sec:.2f} s")
    res["cli"] = cmds
    launches = {k: {"train": res["train"]["launches"][k],
                    "cli_train": res["cli_train"]["launches"][k],
                    **{p: v["launches"][k] for p, v in paths.items()},
                    "http_pair": res["http"]["pair"]["launches"][k]} for k in KERNELS}
    res["launches"] = launches
    log("[cfg] launches by path (gn_silu_fwd, flash_attn_fwd): " + ", ".join(
        f"{p} {launches['gn_silu_fwd'][p]}/{launches['flash_attn_fwd'][p]}"
        for p in launches["gn_silu_fwd"]))
    return res, worst


def _cfg_nll_check(exp, ema_sd, faces):
    """(d) The conditional bound in bits/dim, as ``eval --nll`` scores it
    (guidance 1, the images' labels), from the EMA weights in fp32 on
    NLL_CHECK_N faces at the injected timesteps NLL_CHECK_TS and seeded
    noises: on the kernels against the plain versions (NLL_PLAIN_BAR) and
    against a CPU copy of the model and schedule (NLL_CPU_BAR), each per
    image and relative."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.ops.likelihood import vlb_bits_per_dim_mc
    from ddpm_diffusion_model_tpu_torch.sampling import cfg_eps_fn

    n = NLL_CHECK_N
    x0 = torch.from_numpy(np.ascontiguousarray(faces[:n])).float()
    y = torch.arange(n) % NUM_CLASSES
    ts = torch.tensor(NLL_CHECK_TS)[:, None].expand(len(NLL_CHECK_TS), n)
    noises = torch.randn((len(NLL_CHECK_TS), *x0.shape),
                         generator=torch.Generator().manual_seed(41))
    bpd = {}
    t0 = time.perf_counter()
    for where in ("cuda", "cpu"):
        model = UNetDenoiser(exp.model, dtype=torch.float32, device=where)
        model.load_state_dict(ema_sd, strict=True)
        if where == "cuda":
            model = model.to(memory_format=torch.channels_last)
        model.eval()
        sched = make_schedule(exp.diffusion, device=where)

        def bound():
            eps = cfg_eps_fn(model, sched, y=y.to(where))
            return vlb_bits_per_dim_mc(sched, eps, x0.to(where), ts=ts, noises=noises).cpu()

        with no_tf32():
            bpd[where] = bound()
            if where == "cuda":
                with plain_path():
                    bpd["plain"] = bound()
        del model
    sec = time.perf_counter() - t0
    rel = {k: float(((bpd[k] - bpd["cuda"]).abs() / bpd[k].abs()).max())
           for k in ("plain", "cpu")}
    if (not torch.isfinite(bpd["cuda"]).all() or (bpd["cuda"] <= 0).any()
            or rel["plain"] > NLL_PLAIN_BAR or rel["cpu"] > NLL_CPU_BAR):
        raise AssertionError(f"the conditional bound on the card: bits/dim {bpd}, relative "
                             f"max |diff| {rel} (bars {NLL_PLAIN_BAR}, {NLL_CPU_BAR})")
    log(f"[cfg] (d) the conditional bound (vlb_bits_per_dim_mc, fp32, t {NLL_CHECK_TS}, "
        f"{n} faces) on the kernels: {[round(float(v), 4) for v in bpd['cuda']]} bits/dim; "
        f"relative max |diff| against the plain versions {rel['plain']:.3e} (bar "
        f"{NLL_PLAIN_BAR:g}), against a CPU copy {rel['cpu']:.3e} (bar {NLL_CPU_BAR:g}); "
        f"{sec:.2f} s")
    return dict(bits_per_dim=bpd["cuda"].tolist(), rel_vs_plain=rel["plain"],
                rel_vs_cpu=rel["cpu"], seconds=sec)


def _cfg_http(exp, sched, ema_sd):
    """(e) make_server over the conditional EMA weights: two classes at one
    guidance in one batch, each equal to its re-run beside another request
    at the same rows (PAIR_BAR), and far from the pair with the labels
    swapped (PAIR_CONTROL x PAIR_BAR); two guidances never batched
    together; POST /edit with a class; class 10 is 400; /healthz reports
    the classes."""
    import base64

    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
    from ddpm_diffusion_model_tpu_torch.utils.images import encode_png

    served = UNetDenoiser(exp.model, dtype=torch.bfloat16, device="cuda")
    served.load_state_dict(ema_sd, strict=True)
    svc = SamplerService(served, sched, 64, device="cuda")
    svc.COALESCE_WINDOW_S = SOLVER_PORT_WINDOW_S
    seen = _forward_modes(svc.model)
    server = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    res = {}

    def sample(seed, cls, guidance, n=8):
        code, hdr, body = _get(f"{base}/sample?n={n}&steps=25&seed={seed}&class_id={cls}"
                               f"&guidance={guidance}&format=npy")
        x = np.load(io.BytesIO(body))
        if code != 200 or hdr["X-Used-N"] != str(n) or x.shape != (n, 64, 64, 3) \
                or not np.isfinite(x).all():
            raise AssertionError(f"/sample class {cls} w {guidance}: {code} {x.shape}")
        return x

    def concurrent_pair(a, b):
        """``a`` and ``b`` in one window; ``b`` leaves a fifth of the window
        after ``a``, so ``a`` takes the batch's first rows."""
        m0 = svc.metrics()
        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
            fa = ex.submit(sample, *a)
            time.sleep(SOLVER_PORT_WINDOW_S / 5)
            fb = ex.submit(sample, *b)
            got = fa.result(), fb.result()
        m1 = svc.metrics()
        return got, (m1["coalesced_batches"] - m0["coalesced_batches"],
                     m1["multi_request_batches"] - m0["multi_request_batches"])

    try:
        health = json.loads(_get(base + "/healthz")[2])
        if health["num_classes"] != NUM_CLASSES:
            raise AssertionError(f"/healthz: {health}")
        b0 = len(seen["batches"])
        ((xa, xb), batches), sec, counts, full, _dec = _window(
            seen, lambda: concurrent_pair((1, 0, GUIDANCE), (2, 7, GUIDANCE)))
        if batches != (1, 1) or set(seen["batches"][b0:]) != {2 * BATCH}:
            raise AssertionError(f"two classes at one guidance: (batches, multi-request) "
                                 f"{batches}, rows {sorted(set(seen['batches'][b0:]))}")
        launches = check_launches("HTTP pair", counts, full, rows=2 * BATCH)
        # each request again at its rows, beside a request of another seed
        # and class: the batch has the pair's shape, so only the company moved
        company = (*RERUN_COMPANY, GUIDANCE)
        (ra, _c), b_a = concurrent_pair((1, 0, GUIDANCE), company)
        (_c, rb), b_b = concurrent_pair(company, (2, 7, GUIDANCE))
        (sa, sb), b_s = concurrent_pair((1, 7, GUIDANCE), (2, 0, GUIDANCE))
        if {b_a, b_b, b_s} != {(1, 1)}:
            raise AssertionError(f"re-runs and the swap: (batches, multi-request) "
                                 f"{b_a}, {b_b}, {b_s}, each expected (1, 1)")
        rerun_err = max(float(np.abs(ra - xa).max()), float(np.abs(rb - xb).max()))
        swap_diff = min(float(np.abs(sa - xa).max()), float(np.abs(sb - xb).max()))
        if rerun_err > PAIR_BAR or swap_diff <= PAIR_CONTROL * PAIR_BAR:
            raise AssertionError(f"coalesced classes: vs their re-runs max |diff| "
                                 f"{rerun_err} (bar {PAIR_BAR}), labels swapped {swap_diff} "
                                 f"(must exceed {PAIR_CONTROL * PAIR_BAR})")
        _pair, split = concurrent_pair((3, 4, 1.0), (3, 4, GUIDANCE))
        if split != (2, 0):
            raise AssertionError(f"two guidances in one window: (batches, multi-request) "
                                 f"{split}, expected (2, 0)")
        face = _faces(1)[0] * 0.5 + 0.5
        req = urllib.request.Request(base + "/edit", data=json.dumps({
            "image": base64.b64encode(encode_png(face)).decode(), "mode": "img2img",
            "strength": STRENGTH, "n": 4, "steps": 50, "class_id": 3,
            "guidance": GUIDANCE, "format": "npy"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            code, edit = r.status, np.load(io.BytesIO(r.read()))
        if code != 200 or edit.shape != (4, 64, 64, 3) or not np.isfinite(edit).all():
            raise AssertionError(f"POST /edit with a class: {code} {edit.shape}")
        msg = ""
        try:
            _get(f"{base}/sample?n=1&steps=1&class_id={NUM_CLASSES}")
            bad = 200
        except urllib.error.HTTPError as e:
            bad, msg = e.code, e.read().decode()
        if bad != 400 or "out of range" not in msg:
            raise AssertionError(f"class_id={NUM_CLASSES}: {bad}")
        res.update(pair=dict(seconds=sec, forwards=full, launches=launches,
                             rerun_err=rerun_err, swap_diff=swap_diff, batches=batches),
                   guidance_split=split, edit_code=code,
                   class_10_code=bad, healthz_num_classes=health["num_classes"])
        log(f"[cfg] (e) HTTP: classes 0 and 7 at w {GUIDANCE:g} (n=8 each, 25 steps) in 1 "
            f"batch of {2 * BATCH} rows, {sec:.2f} s, {full} forwards, launches "
            f"{launches['gn_silu_fwd']}/{launches['flash_attn_fwd']}; vs their re-runs beside "
            f"another request max |diff| {rerun_err:.3e} (bar {PAIR_BAR:g}), with the labels "
            f"swapped {swap_diff:.3e} (must exceed {PAIR_CONTROL * PAIR_BAR:g}); w 1 and "
            f"{GUIDANCE:g} in {split[0]} batches, none shared; POST /edit class "
            f"3 -> {code}; class_id {NUM_CLASSES} -> {bad}; /healthz num_classes "
            f"{health['num_classes']}")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    return res


def _resblocks(model):
    from ddpm_diffusion_model_tpu_torch.models.blocks import ResBlock

    return sum(isinstance(m, ResBlock) for m in model.modules())


def remat_launches(n_res, remat, n_attn):
    """Launches of one forward and backward of a U-Net with ``n_res``
    ResBlocks and ``n_attn`` AttnBlocks: two GN+SiLU per ResBlock and the
    head's, the ResBlocks' again under remat=True (the recompute); the
    AttnBlocks are not rematerialised."""
    gn = 2 * n_res + 1
    return {"gn_silu_fwd": gn + (2 * n_res if remat is True else 0), "gn_silu_bwd": gn,
            "gn_silu_bwd_dtb": n_res, "flash_attn_fwd": n_attn,
            "flash_attn_bwd_dq": n_attn, "flash_attn_bwd_dkv": n_attn}


def _attnblocks(model):
    from ddpm_diffusion_model_tpu_torch.models.blocks import AttnBlock

    return sum(isinstance(m, AttnBlock) for m in model.modules())


# ------------------------------------------------------------------ sr

SR_PRESET = "sr64to256"
SR_PARAMS = 63_100_675 + 3 * 9 * 128  # celebahq256 + the stem's 3 cond channels
SR_FWD_BATCH = 4
SR_ZIP_IMAGES = 128  # 2 batches of 64 at 256 x 256
SR_CLI_BATCHES = 2  # --max-batches of each epoch of the SR CLI run
SR_N = 4  # upsample / cascade grids
SR_HTTP_STEPS = 25
SR_OPS_BAR = 1e-5  # degrade / upsample_cond on the card against the CPU, float32
SR_UPSAMPLE_BAR = 1e-3  # upsample_from_init kernels vs plain, fp32, [0, 1] pixels
SR_UPSAMPLE_PARITY_N = 2
SR_PEAK_SLACK = 1.05  # a micro-batch's peak against celebahq256's, remat
HQ_FORWARD = remat_launches(27, False, 3)  # celebahq256: 27 ResBlocks, 3 AttnBlocks
JAX_INFO_SR = REPO / "tests" / "jax_info_sr64to256.json"


def build_sr():
    """sr64to256 at full width (seed 1, GroupNorm affines perturbed), bf16,
    channels_last, remat as the preset; and celebahq256 holding the same
    weights with the stem's x channels only (the comparison model)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser, count_params
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    preset = get_preset(SR_PRESET)
    torch.manual_seed(1)
    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda",
                         remat=preset.remat)
    n = count_params(model)
    tc = preset.train
    if (n != SR_PARAMS or preset.remat is not True or tc.superres_factor != 4
            or tc.cond_aug != 0.1 or model.in_conv.weight.shape[1] != 6):
        raise AssertionError(f"{SR_PRESET}: {n} params, remat {preset.remat!r}, factor "
                             f"{tc.superres_factor}, cond_aug {tc.cond_aug}, stem "
                             f"{tuple(model.in_conv.weight.shape)}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    hq = UNetDenoiser(get_preset(HQ_PRESET).model, dtype=torch.bfloat16, device="cuda",
                      remat=True)
    sd = dict(model.state_dict())
    sd["in_conv.weight"] = sd["in_conv.weight"][:, :3]
    hq.load_state_dict(sd, strict=True)
    log(f"[sr] {SR_PRESET}: {n:,} params (seed 1; in_conv {tuple(model.in_conv.weight.shape)}"
        f"), remat={preset.remat}, batch {preset.batch_size} = {tc.grad_accum_steps} x "
        f"{preset.batch_size // tc.grad_accum_steps}, superres_factor {tc.superres_factor}, "
        f"cond_aug {tc.cond_aug}")
    return (preset, model.to(memory_format=torch.channels_last).eval(),
            hq.to(memory_format=torch.channels_last).eval())


def _sr_ops_check(faces):
    """degrade and upsample_cond (and so build_cond) on the card against the
    CPU at float32."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops.superres import degrade, upsample_cond

    x = torch.from_numpy(faces[:8])
    errs = {}
    low_cpu = degrade(x, 4)
    low = degrade(x.cuda(), 4)
    errs["degrade"] = float((low.cpu() - low_cpu).abs().max())
    up = upsample_cond(low_cpu.cuda(), 256)
    errs["upsample_cond"] = float((up.cpu() - upsample_cond(low_cpu, 256)).abs().max())
    odd = low_cpu[:, :48, :40]  # a non-square low-res input
    errs["upsample_cond_48x40"] = float((upsample_cond(odd.cuda(), 256).cpu()
                                         - upsample_cond(odd, 256)).abs().max())
    log(f"[sr] (a) the conditioning ops on the card against the CPU, float32, max |diff|: "
        f"{errs} (bar {SR_OPS_BAR:g}); degrade (8, 256, 256, 3) -> {tuple(low.shape)}")
    if max(errs.values()) > SR_OPS_BAR:
        raise AssertionError(f"conditioning ops on the card vs the CPU: {errs}")
    return errs


def _sr_forward_checks(model, hq, faces):
    """(a) The SR forward at SR_FWD_BATCH with x_cond: every kernel call
    against its plain version on its GN plan's route, the whole forward on
    the kernels against the plain versions in fp32 and bf16 (phase 4's
    bars), its launches exact and equal to celebahq256's forward."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops.superres import build_cond

    gen = torch.Generator(device="cuda").manual_seed(41)
    x0 = torch.from_numpy(faces[:SR_FWD_BATCH]).cuda()
    cond = build_cond(x0, 4)
    x = torch.randn(x0.shape, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (SR_FWD_BATCH,), generator=gen, device="cuda")
    calls = []
    with torch.inference_mode(), record_calls(calls):
        model(x, t, x_cond=cond)
    torch.cuda.synchronize()
    gn = [c for c in calls if c[0] == "gn"]
    fl = [c for c in calls if c[0] == "flash_attn_fwd"]
    if (len(gn), len(fl), len(calls)) != (HQ_FORWARD["gn_silu_fwd"],
                                          HQ_FORWARD["flash_attn_fwd"], len(gn) + len(fl)):
        raise AssertionError(f"an SR forward made {len(gn)} GN and {len(fl)} flash calls "
                             f"of {len(calls)}")
    smem = sum(_gn_fwd_plan(c, torch.bfloat16)[2] for c in gn)
    with no_tf32():
        worst = hold_calls(calls, gen, label="sr forward: ")
        model32 = UNetDenoiser(model.config, dtype=torch.float32, device="cuda")
        model32.load_state_dict(model.state_dict(), strict=True)
        model32 = model32.to(memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            k32, k16 = model32(x, t, x_cond=cond), model(x, t, x_cond=cond)
            with plain_path():
                p32, p16 = model32(x, t, x_cond=cond), model(x, t, x_cond=cond)
            other = model(x, t, x_cond=torch.flip(cond, dims=(0,)))
        torch.cuda.synchronize()
    del model32

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    errs = {"fp32_kernel_vs_plain": rel(k32, p32), "bf16_kernel_vs_fp32": rel(k16, p32),
            "bf16_plain_vs_fp32": rel(p16, p32), "bf16_kernel_vs_plain": rel(k16, p16)}
    cond_effect = rel(other, k16)
    log(f"[sr] (a) the SR forward at batch {SR_FWD_BATCH} with x_cond on the card, relative "
        f"RMS errors: {errs}; another cond moves the bf16 output by {cond_effect:.3e}")
    if not (torch.isfinite(k16).all() and torch.isfinite(k32).all()):
        raise AssertionError("SR forward on the kernels is not finite")
    if errs["fp32_kernel_vs_plain"] > 1e-5:
        raise AssertionError(f"SR fp32 kernels vs plain: {errs}")
    if errs["bf16_kernel_vs_fp32"] > 1.25 * errs["bf16_plain_vs_fp32"] + 1e-3:
        raise AssertionError(f"SR bf16 kernel path less accurate than plain: {errs}")
    if cond_effect < 1e-3:
        raise AssertionError(f"the cond barely moves the forward: {cond_effect}")
    launches = {}
    for name, run in (("sr", lambda: model(x, t, x_cond=cond)), ("hq256", lambda: hq(x, t))):
        reset_counts()
        with torch.inference_mode():
            run()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in read_counts().items()
                          if k in KERNELS or k in ("gn_silu_fwd.smem", "flash_attn_fwd.tc")}
    want = dict({k: 0 for k in KERNELS}, gn_silu_fwd=HQ_FORWARD["gn_silu_fwd"],
                flash_attn_fwd=HQ_FORWARD["flash_attn_fwd"],
                **{"gn_silu_fwd.smem": smem, "flash_attn_fwd.tc": HQ_FORWARD["flash_attn_fwd"]})
    if launches["sr"] != want or launches["hq256"] != want:
        raise AssertionError(f"SR forward launches {launches['sr']}, celebahq256's "
                             f"{launches['hq256']}, expected {want}")
    log(f"[sr] (a) one SR forward at batch {SR_FWD_BATCH}: launches {launches['sr']} = a "
        f"celebahq256 forward's ({smem} GN in shared memory, as the plan gives)")
    return dict(errors=errs, cond_effect=cond_effect, launches=launches["sr"]), worst


def _stem_times(model, hq):
    """The stem conv's device time, 6 channels (SR) against 3 (celebahq256),
    bf16 channels_last, at a train micro-batch and at an upsample grid's
    rows."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models.blocks import conv

    out = {}
    with torch.inference_mode():
        for rows in (8, SR_N):
            for name, m in (("sr_6ch", model), ("hq256_3ch", hq)):
                cin = m.in_conv.weight.shape[1]
                h = torch.randn(rows, 256, 256, cin, device="cuda",
                                dtype=torch.bfloat16).permute(0, 3, 1, 2)
                fn = lambda: conv(h, m.in_conv, torch.bfloat16)  # noqa: E731
                dev, _ = device_ms(fn, iters=20, gaps_ok=False)
                out[f"{name}_b{rows}"] = dict(device_ms=dev, wall_ms=cuda_time_ms(fn, 20))
    log("[sr] (b) in_conv forward, bf16 channels_last, device ms (wall): " + "; ".join(
        f"{k} {v['device_ms']:.4f} ({v['wall_ms']:.4f})" for k, v in out.items()))
    return out


def _sr_step(preset, model, hq, faces):
    """(b) One SR step at the preset's batch (8 x 8, remat, cond_aug) on
    injected (t, noise, sigma, cond noise), kernels against plain in fp32
    at phase 6a's bars, the stem's cond slice learning; every kernel call of
    a micro-batch against its plain version; 3 bf16 steps (launches exactly
    celebahq256's per step, wall, device, idle, top kernels); a
    micro-batch's peak memory against celebahq256's."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.ops.diffusion import sample_timesteps
    from ddpm_diffusion_model_tpu_torch.ops.superres import build_cond
    from ddpm_diffusion_model_tpu_torch.training import (StepDraws, draw_step_inputs,
                                                         init_train_state, make_loss_fn,
                                                         make_train_step)

    tc = preset.train
    B, accum = preset.batch_size, tc.grad_accum_steps
    micro = B // accum
    x = torch.from_numpy(np.ascontiguousarray(faces[:B])).cuda()
    gen = torch.Generator(device="cuda").manual_seed(42)
    draws = StepDraws(sample_timesteps(B, preset.diffusion.T, gen, "cuda"),
                      torch.randn(x.shape, generator=gen, device="cuda"), None, None,
                      torch.rand((B,), generator=gen, device="cuda") * tc.cond_aug,
                      torch.randn(x.shape, generator=gen, device="cuda"))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    with no_tf32():
        runs = {path: _one_step(preset, sd, torch.float32, ctx, x, draws)
                for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_path))}
    torch.cuda.empty_cache()
    k, p = runs["kernels"], runs["plain"]
    eps32 = float(torch.finfo(torch.float32).eps)
    stem_cond = p["stem_grad"][:, 3:]
    errs = {"loss": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
            "grad_norm": abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"],
            "grads": float((k["grads"] - p["grads"]).norm() / p["grads"].norm()),
            "params": float((k["params"] - p["params"]).norm()
                            / (p["move"].norm() + eps32 * p["params"].norm())),
            "in_conv_grad": float((k["stem_grad"] - p["stem_grad"]).norm()
                                  / p["stem_grad"].norm())}
    log(f"[sr] (b) one SR step at batch {B} = {accum} x {micro}, remat, cond_aug "
        f"{tc.cond_aug}, from the same weights and draws, dropout off, fp32: loss "
        f"{p['loss']:.6f}, grad norm {p['grad_norm']:.6f} (plain); kernels against plain, "
        f"relative: {errs}; in_conv's cond-slice grad norm {float(stem_cond.norm()):.4e} "
        f"(x slice {float(p['stem_grad'][:, :3].norm()):.4e}); {time.perf_counter() - t0:.1f} s")
    if (errs["loss"] > 1e-5 or errs["grad_norm"] > 1e-4 or errs["grads"] > 1e-4
            or errs["params"] > 1e-2 or errs["in_conv_grad"] > 1e-4):
        raise AssertionError(f"fp32 SR step on the kernels vs plain: {errs}")
    if not float(stem_cond.abs().max()) > 0 or not float(k["stem_grad"][:, 3:].abs().max()) > 0:
        raise AssertionError("in_conv's cond slice got no gradient")
    if k["counts"]["gn_silu_fwd"] == 0 or p["counts"]["gn_silu_fwd"] != 0:
        raise AssertionError(f"parity step launches: kernels {k['counts']['gn_silu_fwd']}, "
                             f"plain {p['counts']['gn_silu_fwd']}")
    del runs, k, p

    # the calls of one micro-batch's loss (forward, remat recompute, backward)
    sched = make_schedule(preset.diffusion, device="cuda")
    per_micro = remat_launches(27, True, 3)
    calls = []
    gen = torch.Generator(device="cuda").manual_seed(43)
    d = draw_step_inputs(gen, (micro, 256, 256, 3), preset.diffusion.T, "cuda",
                         cond_aug=tc.cond_aug)
    model.train()
    with record_calls(calls):
        make_loss_fn(model, sched, superres_factor=tc.superres_factor,
                     cond_aug=tc.cond_aug)(x[:micro], d).backward()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    kinds = {"gn_silu_fwd": "gn", "gn_silu_bwd": "gn_bwd", "flash_attn_fwd": "flash_attn_fwd",
             "flash_attn_bwd_dq": "flash_attn_bwd_dq",
             "flash_attn_bwd_dkv": "flash_attn_bwd_dkv"}
    got = {k_: sum(c[0] == v for c in calls) for k_, v in kinds.items()}
    got["gn_silu_bwd_dtb"] = sum(c[0] == "gn_bwd" and c[4] for c in calls)
    if got != per_micro:
        raise AssertionError(f"an SR micro-batch made the calls {got}, celebahq256's "
                             f"config says {per_micro}")
    with no_tf32():
        worst = hold_calls(calls, torch.Generator(device="cuda").manual_seed(44),
                           "sr micro-batch ")

    # 3 bf16 steps of the preset's batch
    state, tx = init_train_state(model, tc, seed=5)
    step = make_train_step(model, sched, tx, tc)
    state, _ = step(state, x)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(HQ_STEPS):
        state, m = step(state, x)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / HQ_STEPS * 1e3
    counts = read_counts()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k_: v * accum * HQ_STEPS for k_, v in per_micro.items()}
    got = {k_: counts[k_] for k_ in want}
    if got != want or not np.isfinite(loss) or not np.isfinite(float(m["grad_norm"])):
        raise AssertionError(f"{HQ_STEPS} SR steps: launches {got} (want {want}), loss "
                             f"{loss}, grad norm {float(m['grad_norm'])}")
    dev, table = device_ms(lambda: step(state, x), iters=1, warmup=0)
    per_step = {k_: v // HQ_STEPS for k_, v in got.items()}
    log(f"[sr] (b) {HQ_STEPS} SR train steps (bf16): wall {wall:.1f} ms per step "
        f"({B * 1e3 / wall:.1f} images/s), device {dev:.1f} ms, device idle "
        f"{pct(idle_of(dev, wall, table))}, loss {loss:.5f}, peak memory "
        f"{step_peak:.2f} GiB; launches per step {per_step} = celebahq256's")
    for name, ms, count in table[:15]:
        log(f"[sr]   {ms:9.4f} ms  x{count:<5d} {name[:110]}")
    del state, tx, step
    model.eval()

    # a micro-batch's peak over the weights, remat, against celebahq256's
    t = torch.randint(1, 1000, (micro,), device="cuda")
    cond = build_cond(x[:micro], tc.superres_factor)
    peaks = {}
    for name, mdl, kw in (("sr", model, {"x_cond": cond}), ("hq256", hq, {})):
        mdl.train()
        mdl.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mdl(x[:micro], t, **kw).float().square().mean().backward()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        mdl.zero_grad(set_to_none=True)
        mdl.eval()
    torch.cuda.empty_cache()
    log(f"[sr] (b) one micro-batch of {micro}, forward and backward, remat, peak memory over "
        f"the weights: {SR_PRESET} {peaks['sr']:.3f} GiB, {HQ_PRESET} {peaks['hq256']:.3f} "
        f"GiB (bar {SR_PEAK_SLACK} x)")
    if peaks["sr"] > SR_PEAK_SLACK * peaks["hq256"]:
        raise AssertionError(f"SR micro-batch peak {peaks}")
    return dict(parity=errs, step_wall_ms=wall, step_device_ms=dev,
                device_ms_source=ms_source(table), idle_share=idle_of(dev, wall, table),
                images_per_s=B * 1e3 / wall, loss=loss,
                step_peak_gib=step_peak, micro_peak_over_weights_gib=peaks, launches=got,
                launches_per_step=per_step,
                in_conv_cond_grad_norm=float(stem_cond.norm())), worst


def _sr_zip(faces, path):
    """The 256 x 256 blob faces as JPEGs (quality 95) in a zip."""
    import zipfile

    import numpy as np
    from PIL import Image

    u8 = ((faces + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for i, face in enumerate(u8):
            buf = io.BytesIO()
            Image.fromarray(face).save(buf, format="JPEG", quality=95)
            zf.writestr(f"img_align_celeba/{i:06d}.jpg", buf.getvalue())


def _sr_base_checkpoint(preset, base_sd, tmp):
    """The cascade's base: celeba64_attn with 10 classes from seeded weights
    (phase cfg's model), saved as a port checkpoint whose meta holds the
    experiment, EMA = the weights."""
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, save_checkpoint
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig

    exp_d = cond_experiment(preset)
    cond = ExperimentConfig.from_dict(exp_d)
    model = build_cond_model(cond, base_sd)
    state, _tx = init_train_state(model, cond.train)
    path = os.path.join(tmp, "base_last")
    save_checkpoint(path, state, epoch=0, configs={"experiment": exp_d})
    del model, state
    return path


def _check_fwd_launches(name, counts, forwards, gn, flash):
    want = dict({k: 0 for k in KERNELS}, gn_silu_fwd=gn * forwards,
                flash_attn_fwd=flash * forwards)
    got = {k: counts[k] for k in KERNELS}
    if got != want or counts["flash_attn_fwd.tc"] != want["flash_attn_fwd"]:
        raise AssertionError(f"{name}: launches {got} (flash on the tensor cores "
                             f"{counts['flash_attn_fwd.tc']}), expected {want}")
    return got


def _sr_http(exp, sched, ema_sd):
    """(e) make_server over the SR checkpoint's EMA weights: /healthz
    upsampler, POST /upsample 200 with X-Used-* and exact launches, /sample
    400, an image larger than the model 400, /metrics upsamples."""
    import base64

    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
    from ddpm_diffusion_model_tpu_torch.utils.images import encode_png

    served = UNetDenoiser(exp.model, dtype=torch.bfloat16, device="cuda")
    served.load_state_dict(ema_sd, strict=True)
    svc = SamplerService(served, sched, 256, device="cuda")
    seen = _forward_modes(svc.model)
    server = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(img01, **kw):
        body = json.dumps({"image": base64.b64encode(encode_png(img01)).decode(), **kw})
        req = urllib.request.Request(base + "/upsample", data=body.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, dict(r.headers), r.read()

    def refused(fn):
        try:
            fn()
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())["error"]
        return 200, ""

    try:
        health = json.loads(_get(base + "/healthz")[2])
        low = _faces(1)[0] * 0.5 + 0.5
        (code, hdr, body), sec, counts, full, _d = _window(
            seen, lambda: post(low, n=SR_N, steps=SR_HTTP_STEPS, seed=3, format="npy"))
        x = np.load(io.BytesIO(body))
        launches = _check_fwd_launches("POST /upsample", counts, full,
                                       HQ_FORWARD["gn_silu_fwd"], HQ_FORWARD["flash_attn_fwd"])
        if (code != 200 or hdr["X-Used-N"] != str(SR_N)
                or hdr["X-Used-Steps"] != str(SR_HTTP_STEPS) or x.shape != (SR_N, 256, 256, 3)
                or not np.isfinite(x).all() or full != SR_HTTP_STEPS - 1
                or health["upsampler"] is not True):
            raise AssertionError(f"POST /upsample: {code} {hdr} {x.shape}, {full} forwards, "
                                 f"/healthz {health}")
        s_code, s_err = refused(lambda: _get(f"{base}/sample?n=1&steps=1"))
        big = np.full((300, 300, 3), 0.5, np.float32)
        b_code, b_err = refused(lambda: post(big, n=1, steps=1))
        metrics = json.loads(_get(base + "/metrics")[2])
        if (s_code, b_code) != (400, 400) or "use POST /upsample" not in s_err \
                or "got (300, 300, 3)" not in b_err or metrics["upsamples"] != 1:
            raise AssertionError(f"/sample {s_code} {s_err!r}; a 300-px image {b_code} "
                                 f"{b_err!r}; upsamples {metrics['upsamples']}")
        log(f"[sr] (e) HTTP: /healthz upsampler {health['upsampler']}; POST /upsample n={SR_N}"
            f" steps={SR_HTTP_STEPS} -> {code}, X-Used-N {hdr['X-Used-N']}, X-Used-Steps "
            f"{hdr['X-Used-Steps']}, {sec:.2f} s, {full} forwards, launches "
            f"{launches['gn_silu_fwd']}/{launches['flash_attn_fwd']}; /sample -> {s_code}; "
            f"a 300-px image -> {b_code}; /metrics upsamples {metrics['upsamples']}")
        return dict(healthz_upsampler=health["upsampler"], upsample_code=code, seconds=sec,
                    forwards=full, launches=launches, sample_code=s_code, big_code=b_code,
                    upsamples=metrics["upsamples"])
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)


def phase_sr(preset, base_sd, tmp):
    """The super-resolution cascade on sr64to256 at full width: (a) the SR
    forward and the conditioning ops; (b) the SR step (parity, calls,
    3 steps, the stem's time, memory); (c) ``cli train --preset sr64to256
    --data zip``; (d) ``cli upsample`` and ``cli cascade`` from its
    checkpoint and a base checkpoint, the upsampler on the kernels against
    the plain versions; (e) the server.  Launches exact on every path, its
    counts set to 0 just before it and read just after."""
    import numpy as np
    import torch
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import (build_ddim_schedule,
                                                         cascade_infer_sample,
                                                         upsample_from_init,
                                                         upsample_infer_sample)
    from ddpm_diffusion_model_tpu_torch.sampling.superres import _cond_from_low
    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, load_checkpoint,
                                                         read_meta)
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid, save_image

    res = {"params": SR_PARAMS}
    t0 = time.perf_counter()
    faces = blob_faces_array(SR_ZIP_IMAGES, img_size=256, seed=3)
    log(f"[sr] {len(faces)} blob faces at 256x256 in {time.perf_counter() - t0:.1f} s")

    # (a) the conditioning ops and the forward
    res["ops"] = _sr_ops_check(faces)
    sr_preset, model, hq = build_sr()
    res["forward"], worst = _sr_forward_checks(model, hq, faces)
    res["in_conv"] = _stem_times(model, hq)

    # (b) the step
    torch.backends.cudnn.allow_tf32 = True  # the library default, as phase 10
    res["step"], step_worst = _sr_step(sr_preset, model, hq, faces)
    worst = {k: max(worst[k], step_worst[k]) for k in KERNELS}
    del model, hq
    torch.cuda.empty_cache()

    # (c) cli train --preset sr64to256 from a zip of 256-px JPEGs
    zpath = os.path.join(tmp, "faces256.zip")
    _sr_zip(faces, zpath)
    ck = os.path.join(tmp, "ck_sr")
    argv = ["train", "--preset", SR_PRESET, "--data", "zip", "--zip-path", zpath, "--no-crop",
            "--max-batches", str(SR_CLI_BATCHES), "--ckpt-dir", ck]
    reset_counts()
    t0 = time.perf_counter()
    with _cwd(tmp):
        out1 = run_cli([*argv, "--epochs", "1", "--no-samples"])
        out2 = run_cli([*argv, "--epochs", "2", "--resume", "auto"])
    sec = time.perf_counter() - t0
    counts = read_counts()
    steps = 2 * SR_CLI_BATCHES
    per_step = {k: v * sr_preset.train.grad_accum_steps
                for k, v in remat_launches(27, True, 3).items()}
    sample_fwd = min(50, sr_preset.diffusion.T - 1) - 1  # the anchor grid's DDIM ladder
    want = {k: per_step[k] * steps for k in KERNELS}
    want["gn_silu_fwd"] += HQ_FORWARD["gn_silu_fwd"] * sample_fwd
    want["flash_attn_fwd"] += HQ_FORWARD["flash_attn_fwd"] * sample_fwd
    got = {k: counts[k] for k in KERNELS}
    last = os.path.join(ck, f"{SR_PRESET}_last")
    exp_back = ExperimentConfig.from_dict(read_meta(last)["configs"]["experiment"])
    grid_png = os.path.join(ck, f"{SR_PRESET}_samples_e001.png")
    n_grid = sr_preset.sample_n
    grid_shape = make_grid(np.zeros((n_grid, 256, 256, 3), np.float32),
                           nrow=grid_nrow(n_grid)).shape
    final = json.loads(out2.strip().splitlines()[-1])
    if (got != want or exp_back.model.cond_channels != 3
            or exp_back.train.superres_factor != 4 or "[RESUME] auto -> " not in out2
            or not os.path.exists(grid_png)
            or np.asarray(Image.open(grid_png)).shape != grid_shape
            or not np.isfinite(final["final_loss"]) or "decoder" not in out1):
        raise AssertionError(f"cli train --preset {SR_PRESET}: launches {got} (want {want}), "
                             f"cond_channels {exp_back.model.cond_channels}, result {final}")
    res["cli_train"] = dict(seconds=sec, steps=steps, sample_forwards=sample_fwd,
                            launches=got, final_loss=final["final_loss"])
    log(f"[sr] (c) cli train --preset {SR_PRESET} --data zip --no-crop: 2 epochs of "
        f"{SR_CLI_BATCHES} steps at batch {sr_preset.batch_size} (the second resumed), the "
        f"anchor grid of {n_grid} upsampled after the last ({sample_fwd} forwards): "
        f"{sec:.1f} s, launches {got}, final loss {final['final_loss']:.5f}; its _last "
        f"rebuilds cond_channels {exp_back.model.cond_channels}")
    info = run_cli(["info", "--preset", SR_PRESET])
    if info != JAX_INFO_SR.read_text():
        raise AssertionError("info --preset sr64to256 differs from the JAX package's")
    log("[sr] (c) info --preset sr64to256: the JAX package's JSON")

    # (d) upsample and cascade from the checkpoints (EMA weights)
    base_last = _sr_base_checkpoint(preset, base_sd, tmp)
    save_image(_faces(1)[0] * 0.5 + 0.5, os.path.join(tmp, "face64.png"))
    cmds = {}
    sr_shape = make_grid(np.zeros((SR_N, 256, 256, 3), np.float32), nrow=grid_nrow(SR_N)).shape
    low_shape = make_grid(np.zeros((SR_N, 64, 64, 3), np.float32), nrow=grid_nrow(SR_N)).shape
    sr_fwd = DDIM_STEPS - 1
    for name, extra, forwards in (
            ("upsample", ["--init", "face64.png", "--n", str(SR_N), "--steps",
                          str(DDIM_STEPS), "--out", "up.png"], [(sr_fwd, HQ_FORWARD)]),
            ("cascade", ["--base-ckpt", base_last, "--n", str(SR_N), "--class-id", "2",
                         "--guidance", f"{GUIDANCE:g}", "--out", "cas.png", "--out-low",
                         "cas_low.png"],
             [(sr_fwd, HQ_FORWARD), (DDIM_STEPS - 1, LAUNCHES_PER_STEP)])):
        reset_counts()
        t0 = time.perf_counter()
        with _cwd(tmp):
            said = run_cli([name, "--ckpt", last, "--ema", *extra])
        sec = time.perf_counter() - t0
        counts = read_counts()
        want = {k: 0 for k in KERNELS}
        for n_fwd, per in forwards:
            want["gn_silu_fwd"] += n_fwd * per["gn_silu_fwd"]
            want["flash_attn_fwd"] += n_fwd * per["flash_attn_fwd"]
        got = {k: counts[k] for k in KERNELS}
        out_png = os.path.join(tmp, "up.png" if name == "upsample" else "cas.png")
        shapes = [np.asarray(Image.open(out_png)).shape]
        if name == "cascade":
            shapes.append(np.asarray(Image.open(os.path.join(tmp, "cas_low.png"))).shape)
        if got != want or shapes[0] != sr_shape or (name == "cascade"
                                                     and shapes[1] != low_shape):
            raise AssertionError(f"cli {name}: launches {got} (want {want}), PNGs {shapes}, "
                                 f"said {said[-300:]!r}")
        cmds[name] = dict(exit=0, seconds=sec, launches=got, png=[list(s) for s in shapes])
        log(f"[sr] (d) cli {name} {' '.join(extra)}: exit 0, {sec:.2f} s, launches {got}, "
            f"PNGs {shapes} as make_grid gives")
    res["cli"] = cmds

    # the grids' device time in-process, and the upsampler kernels vs plain
    model = UNetDenoiser(exp_back.model, dtype=torch.bfloat16, device="cuda")
    model = model.to(memory_format=torch.channels_last)
    state, _meta = load_checkpoint(last, init_train_state(model, exp_back.train)[0],
                                   components=("params", "ema_params"))
    ema_sd = {k: v.detach().clone() for k, v in state.ema_params.items()}
    model.load_state_dict(ema_sd, strict=True)
    model.eval()
    del state
    sched = make_schedule(exp_back.diffusion, device="cuda")
    low = _faces(SR_N) * 1.0
    grids = {}
    with torch.inference_mode():
        dev, table = device_ms(lambda: upsample_infer_sample(
            model, None, sched, low, n=SR_N, steps=DDIM_STEPS, seed=5, out_path=None),
            iters=1, warmup=1)
        grids["upsample"] = dict(device_ms=dev, device_ms_source=ms_source(table), wall_s=cuda_time_ms(lambda: upsample_infer_sample(
            model, None, sched, low, n=SR_N, steps=DDIM_STEPS, seed=5, out_path=None),
            iters=1, warmup=0) / 1e3)
        cond_exp = ExperimentConfig.from_dict(cond_experiment(preset))
        base = build_cond_model(cond_exp, base_sd)
        base_sched = make_schedule(cond_exp.diffusion, device="cuda")
        run = lambda: cascade_infer_sample(  # noqa: E731
            base, None, base_sched, model, None, sched, n=SR_N, base_steps=DDIM_STEPS,
            sr_steps=DDIM_STEPS, class_id=2, guidance=GUIDANCE, out_path=None)
        dev, table = device_ms(run, iters=1, warmup=1)
        grids["cascade"] = dict(device_ms=dev, device_ms_source=ms_source(table), wall_s=cuda_time_ms(run, iters=1, warmup=0) / 1e3)
    del base
    log("[sr] (d) grids of " + str(SR_N) + " (bf16, in-process): " + "; ".join(
        f"{k} device {v['device_ms']:.1f} ms, wall {v['wall_s']:.2f} s" for k, v in grids.items()))
    res["grids"] = grids
    with no_tf32():
        model32 = UNetDenoiser(exp_back.model, dtype=torch.float32, device="cuda")
        model32.load_state_dict(ema_sd, strict=True)
        model32 = model32.to(memory_format=torch.channels_last).eval()
        n = SR_UPSAMPLE_PARITY_N
        cond = _cond_from_low(model32, low[:n], n, "cuda")
        x_T = torch.randn((n, 256, 256, 3), generator=torch.Generator(
            device="cuda").manual_seed(6), device="cuda")
        lad = build_ddim_schedule("t_linear", DDIM_STEPS, sched.T,
                                  alphas_cumprod=sched.alphas_cumprod.cpu().numpy())
        a = upsample_from_init(model32, sched, cond, x_T, lad)
        with plain_path():
            b = upsample_from_init(model32, sched, cond, x_T, lad)
        torch.cuda.synchronize()
        diff = float(((a.clamp(-1, 1) - b.clamp(-1, 1)) * 0.5).abs().max())
    del model32
    log(f"[sr] (d) upsample_from_init, fp32, {n} rows, DDIM-{DDIM_STEPS} from one x_T, on the "
        f"kernels against the plain versions: max |diff| {diff:.3e} in [0, 1] pixels (bar "
        f"{SR_UPSAMPLE_BAR:g})")
    if not diff <= SR_UPSAMPLE_BAR:
        raise AssertionError(f"upsample_from_init kernels vs plain: {diff}")
    res["upsample_parity_max_diff"] = diff
    del model
    torch.cuda.empty_cache()

    # (e) the server
    res["http"] = _sr_http(exp_back, sched, ema_sd)
    res["launches"] = {k: {"step": res["step"]["launches"][k],
                           "cli_train": res["cli_train"]["launches"][k],
                           "cli_upsample": cmds["upsample"]["launches"][k],
                           "cli_cascade": cmds["cascade"]["launches"][k],
                           "http_upsample": res["http"]["launches"][k]} for k in KERNELS}
    return res, worst


# ------------------------------------------------------------------ distill

DISTILL_KINDS = ("progressive", "consistency")
DISTILL_START, DISTILL_END = 64, 16  # (b): two halving phases, 64 -> 32 -> 16
DISTILL_PHASE_UPDATES = 2  # (b): updates per progressive phase
CM_LADDER = 32  # (b): the consistency ladder's segments (the CLI's default)
CM_UPDATES = 3  # (b): consistency updates
DISTILL_TIMED = 5  # (b): updates of each kind timed on the host's clock
DISTILL_CLI_UPDATES = 2  # (c): --phase-updates of each cli distill
DISTILL_CLI_N = 16  # (c): the CLI's grids
DISTILL_LR = 1e-4  # cli distill's defaults: no warmup, EMA 0.999
DISTILL_EMA = 0.999
#: (d) a served request against ddim_infer_sample from the same seed: the
#: same kernels on the same rows, so the same bits up to PAIR_BAR
C1_N, C1_STEPS = 8, 10
#: (d) a coalesced sampler=cm request against its solo re-run at half the
#: rows, through the same one forward in fp32 (TF32 off): phase 5's bar on
#: the served pixels, after x0 = (z - s eps) / a has multiplied the raw
#: output's differences by s / a = 156 at t = T-1
CM_SOLO_BAR = 2e-2


def distill_update_launches(kind):
    """(launches, rows of each forward) of one guided update at TRAIN_BATCH,
    from the config: a progressive update runs the teacher's two eta=0 DDIM
    half-steps (each ONE forward of 2 x TRAIN_BATCH rows, the conditional
    and the NULL branch) and the student's forward; a consistency update
    one teacher step (2 x TRAIN_BATCH rows), the EMA target's forward and
    the student's (TRAIN_BATCH each).  45 GN and 5 flash launches a forward
    on the routes the GN plan names at its rows; the student's backward
    once, the train step's 45/5/5 on its routes."""
    teacher = 2 if kind == "progressive" else 1
    rows = [2 * TRAIN_BATCH] * teacher + [TRAIN_BATCH] * (3 - teacher)
    smem = sum(GN_FWD_SMEM_PER_FORWARD[r] for r in rows)
    want = dict(LAUNCHES_PER_STEP)
    want.update({"gn_silu_fwd": GN_LAUNCHES_PER_FORWARD * len(rows), "gn_silu_fwd.smem": smem,
                 "gn_silu_fwd.reread": GN_LAUNCHES_PER_FORWARD * len(rows) - smem,
                 "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD * len(rows),
                 "flash_attn_fwd.tc": FLASH_LAUNCHES_PER_FORWARD * len(rows)})
    return want, rows


@contextlib.contextmanager
def _recording_grads(grads):
    """Append the flat gradients each update takes, before the clip (which
    the plain version applies in place), to ``grads`` for the duration."""
    fu = _update_module()
    inner = fu.adamw_

    def record(tx, params, g, *args, **kw):
        grads.append(_flat(g))
        return inner(tx, params, g, *args, **kw)

    fu.adamw_ = record
    try:
        yield
    finally:
        fu.adamw_ = inner


def check_distill_launches(name, counts, kind, updates):
    """Raise unless ``counts`` are exactly ``updates`` guided updates of
    ``kind`` (every kernel and route of ``distill_update_launches``)."""
    per, _rows = distill_update_launches(kind)
    want = {k: v * updates for k, v in per.items()}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want} after {updates} "
                             f"{kind} updates")
    return got


def _distill_step(kind, model, sched, tx, cfg):
    """The guided (GUIDANCE) update of ``kind`` on (b)'s ladders."""
    from ddpm_diffusion_model_tpu_torch.training import (consistency_ladder, distill_ladder,
                                                         make_consistency_step,
                                                         make_distill_step)

    if kind == "progressive":
        return make_distill_step(model, sched, distill_ladder(sched.T, DISTILL_START // 2),
                                 tx, cfg, guidance=GUIDANCE)
    return make_consistency_step(model, sched, consistency_ladder(sched.T, CM_LADDER), tx,
                                 cfg, guidance=GUIDANCE)


def _distill_calls(model, sched, teacher_sd, batch, cfg):
    """Every kernel-wrapper call of one guided update of each kind (the
    model's weights are put back after each)."""
    import collections

    import torch

    from ddpm_diffusion_model_tpu_torch.training import init_train_state

    out = {}
    for kind in DISTILL_KINDS:
        model.load_state_dict(teacher_sd, strict=True)
        state, tx = init_train_state(model, cfg, seed=1)
        calls = []
        with record_calls(calls):
            _distill_step(kind, model, sched, tx, cfg)(state, teacher_sd, batch)
        torch.cuda.synchronize()
        _want, rows = distill_update_launches(kind)
        kinds = collections.Counter(c[0] for c in calls)
        gn_rows = collections.Counter(c[1][0] for c in calls if c[0] == "gn")
        want_rows = collections.Counter()
        for r in rows:
            want_rows[r] += GN_LAUNCHES_PER_FORWARD
        want = {"gn": GN_LAUNCHES_PER_FORWARD * 3, "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD * 3,
                "gn_bwd": GN_LAUNCHES_PER_FORWARD, "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD,
                "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD}
        if dict(kinds) != want or gn_rows != want_rows \
                or {c[1][0] for c in calls if c[0] == "gn_bwd"} != {TRAIN_BATCH}:
            raise AssertionError(f"a {kind} update made the calls {dict(kinds)} (GN forward "
                                 f"rows {dict(gn_rows)}), expected {want} (rows "
                                 f"{dict(want_rows)})")
        log(f"[distill] (a) one guided {kind} update at batch {TRAIN_BATCH} calls "
            f"{dict(kinds)}; GN forwards by rows {dict(sorted(gn_rows.items()))}")
        out[kind] = calls
    model.load_state_dict(teacher_sd, strict=True)
    return out


def _distill_parity(cond, sched, teacher_sd, batch, cfg):
    """(a) One whole update of each kind, fp32, from the teacher's weights
    on injected draws: on the kernels against the plain versions at phase
    6a's bars (loss 1e-5, grads and grad norm 1e-4 relative, the updated
    params within 1e-2 of the update's move)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.training import DistillDraws, init_train_state

    gen = torch.Generator(device="cuda").manual_seed(42)
    model = UNetDenoiser(cond.model, dtype=torch.float32, device="cuda")
    model = model.to(memory_format=torch.channels_last)
    res = {}
    for kind in DISTILL_KINDS:
        n = DISTILL_START // 2 if kind == "progressive" else CM_LADDER
        draws = DistillDraws(torch.randint(0, n, (TRAIN_BATCH,), generator=gen, device="cuda"),
                             torch.randn(batch[0].shape, generator=gen, device="cuda"))
        runs = {}
        for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_path)):
            model.load_state_dict(teacher_sd, strict=True)
            state, tx = init_train_state(model, cfg, seed=1)
            grads = []
            start = _flat(model.parameters())
            reset_counts()
            with no_tf32(), ctx(), _recording_grads(grads):
                state, m = _distill_step(kind, model, sched, tx, cfg)(state, teacher_sd, batch,
                                                                      draws)
            torch.cuda.synchronize()
            params = _flat(model.parameters())
            runs[path] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                              grads=grads[0], params=params, move=params - start,
                              counts=read_counts())
        k, p = runs["kernels"], runs["plain"]
        eps32 = float(torch.finfo(torch.float32).eps)
        e = {"loss": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
             "grad_norm": abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"],
             "grads": float((k["grads"] - p["grads"]).norm() / p["grads"].norm()),
             "params": float((k["params"] - p["params"]).norm()
                             / (p["move"].norm() + eps32 * p["params"].norm()))}
        fma = {key: k["counts"][f"{key}.fma"] for key in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                                          "flash_attn_bwd_dkv")}
        want_fma = {"flash_attn_fwd": 3 * FLASH_LAUNCHES_PER_FORWARD,
                    "flash_attn_bwd_dq": FLASH_LAUNCHES_PER_FORWARD,
                    "flash_attn_bwd_dkv": FLASH_LAUNCHES_PER_FORWARD}
        if not all(map(math.isfinite, (k["loss"], p["loss"]))) or e["loss"] > 1e-5 \
                or e["grad_norm"] > 1e-4 or e["grads"] > 1e-4 or e["params"] > 1e-2 \
                or fma != want_fma or any(v for key, v in p["counts"].items()
                                          if key in KERNELS):
            raise AssertionError(f"fp32 {kind} update on the kernels vs plain: {e}; FMA "
                                 f"flash launches {fma} (want {want_fma}); plain path "
                                 f"{ {key: p['counts'][key] for key in KERNELS} }")
        res[kind] = dict(loss=p["loss"], grad_norm=p["grad_norm"], errors=e)
        log(f"[distill] (a) one fp32 guided {kind} update from the teacher's weights on "
            f"injected draws: loss {p['loss']:.6f}, grad norm {p['grad_norm']:.6f} (plain); "
            f"kernels against plain, relative: {e}")
    del model
    torch.cuda.empty_cache()
    return res


def _distill_runs(model, sched, teacher_sd, batches, cfg):
    """(b) progressive_distill from DISTILL_START to DISTILL_END steps and
    consistency_distill on a CM_LADDER ladder, guided, at TRAIN_BATCH;
    launches exact per update; peak memory; then DISTILL_TIMED updates of
    each kind: wall, device time, idle share, top kernels."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import (consistency_distill,
                                                         init_train_state,
                                                         progressive_distill)

    res = {}
    for kind in DISTILL_KINDS:
        model.load_state_dict(teacher_sd, strict=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        say = lambda m: log(f"[distill] (b)   {m}")  # noqa: E731
        reset_counts()
        t0 = time.perf_counter()
        if kind == "progressive":
            _p, info = progressive_distill(
                model, sched, teacher_sd, lambda: batches, start_steps=DISTILL_START,
                end_steps=DISTILL_END, phase_updates=DISTILL_PHASE_UPDATES, cfg=cfg,
                guidance=GUIDANCE, log=say)
            updates = DISTILL_PHASE_UPDATES * len(info["phases"])
        else:
            _p, info = consistency_distill(
                model, sched, teacher_sd, lambda: batches, num_ladder_steps=CM_LADDER,
                updates=CM_UPDATES, cfg=cfg, guidance=GUIDANCE, log=say)
            updates = CM_UPDATES
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = check_distill_launches(f"{kind} run", read_counts(), kind, updates)
        losses = [v for p in info["phases"] for v in (p["first_loss"], p["last_loss"])]
        if not all(map(math.isfinite, losses)) or \
                (kind == "progressive" and [p["student_steps"] for p in info["phases"]]
                 != [DISTILL_START // 2, DISTILL_START // 4]):
            raise AssertionError(f"{kind} run: info {info}")
        # one update at a time, timed
        model.load_state_dict(teacher_sd, strict=True)
        state, tx = init_train_state(model, cfg, seed=3)
        step = _distill_step(kind, model, sched, tx, cfg)
        fn = lambda: step(state, teacher_sd, batches[0])  # noqa: E731
        wall = cuda_time_ms(fn, iters=DISTILL_TIMED, warmup=1)
        dev, table = device_ms(fn, iters=2, warmup=0)
        res[kind] = dict(updates=updates, seconds=sec, launches=launches,
                         launches_per_update=distill_update_launches(kind)[0],
                         info=info, peak_gib=peak, update_wall_ms=wall, update_device_ms=dev,
                         device_ms_source=ms_source(table),
                         idle_share=idle_of(dev, wall, table))
        log(f"[distill] (b) {kind}_distill, guidance {GUIDANCE:g} baked in, batch "
            f"{TRAIN_BATCH} (teacher forwards at {2 * TRAIN_BATCH} rows): {updates} updates in "
            f"{sec:.1f} s, launches {launches} (exact per update), phases "
            + ", ".join(f"{p['student_steps']} steps: loss {p['first_loss']:.5f} -> "
                        f"{p['last_loss']:.5f}" for p in info["phases"])
            + f"; peak memory {peak:.2f} GiB")
        log(f"[distill] (b) one {kind} update bf16: wall {wall:.3f} ms, device {dev:.3f} ms, "
            f"device idle {pct(res[kind]['idle_share'])}")
        for name, ms, count in table[:8]:
            log(f"[distill]   {ms:8.4f} ms  x{count:<3d} {name[:110]}")
    model.load_state_dict(teacher_sd, strict=True)
    return res


def _distill_cli(exp_d, teacher_dir, tmp, T):
    """(c) ``cli distill`` in both modes from the teacher checkpoint on blob
    faces in 10 class hues (device cache), then ``sample-ddim --schedule
    linear`` on the progressive student and ``sample-cm`` on the
    consistency student; each exits 0, launches exact, each PNG as
    make_grid gives."""
    import numpy as np
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.sampling import build_ddim_schedule
    from ddpm_diffusion_model_tpu_torch.training import read_meta
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    cfg_json = os.path.join(tmp, "teacher.json")
    with open(cfg_json, "w") as f:
        json.dump(exp_d, f)
    common = ["--config", cfg_json, "--ckpt", teacher_dir, "--ema", "--data", "blobs",
              "--synthetic-size", str(2 * TRAIN_BATCH), "--device-cache", "--guidance",
              f"{GUIDANCE:g}"]
    jobs = {"progressive": (["--start-steps", "8", "--to-steps", "2", "--phase-updates",
                             str(DISTILL_CLI_UPDATES)], 2 * DISTILL_CLI_UPDATES, 2),
            "consistency": (["--mode", "consistency", "--phase-updates",
                             str(DISTILL_CLI_UPDATES)], DISTILL_CLI_UPDATES, 1)}
    res, students = {}, {}
    for kind, (extra, updates, steps) in jobs.items():
        out_dir = os.path.join(tmp, f"student_{kind}")
        reset_counts()
        t0 = time.perf_counter()
        with _cwd(tmp):
            said = run_cli(["distill", *common, "--out", out_dir, *extra])
        sec = time.perf_counter() - t0
        launches = check_distill_launches(f"cli distill --mode {kind}", read_counts(), kind,
                                          updates)
        payload = json.loads(said.strip().splitlines()[-2])
        meta = read_meta(out_dir)
        ex = meta["extra"]
        keys = {"distilled_steps", "distill_mode", "distill_guidance", "distill_phases"}
        if kind == "consistency":
            keys |= {"cm_sigma_data", "cm_timestep_scaling"}
        if (set(ex) != keys or ex["distill_mode"] != kind or ex["distilled_steps"] != steps
                or ex["distill_guidance"] != GUIDANCE or payload["steps"] != steps
                or meta["configs"]["experiment"]["model"]["num_classes"] != NUM_CLASSES):
            raise AssertionError(f"cli distill --mode {kind}: extra {ex}, said {payload}")
        students[kind] = out_dir
        res[f"distill_{kind}"] = dict(exit=0, seconds=sec, updates=updates,
                                      launches=launches, extra=ex)
        log(f"[distill] (c) cli distill {' '.join(extra)} --guidance "
            f"{GUIDANCE:g}: exit 0, {updates} updates in {sec:.1f} s (the checkpoint's load "
            f"and save included), launches {launches}; extra {sorted(ex)}, "
            f"distilled_steps {steps}")
    n = DISTILL_CLI_N
    shape = make_grid(np.zeros((n, 64, 64, 3), np.float32), nrow=grid_nrow(n)).shape
    linear = len(build_ddim_schedule("linear", 2, T)) - 1
    samples = [("sample-ddim", students["progressive"],
                ["--schedule", "linear", "--steps", "2", "--class-id", "all"], linear),
               ("sample-cm", students["consistency"], ["--steps", "1"], 1),
               ("sample-cm", students["consistency"], ["--steps", "2", "--class-id", "2"], 2)]
    for cmd, ckpt, extra, forwards in samples:
        png = os.path.join(tmp, f"distill_{cmd}_{len(res)}.png")
        reset_counts()
        t0 = time.perf_counter()
        with _cwd(tmp):
            said = run_cli([cmd, "--ckpt", ckpt, "--ema", "--n", str(n), *extra, "--out", png])
        sec = time.perf_counter() - t0
        launches = check_launches(f"cli {cmd}", read_counts(), forwards, rows=n)
        got = np.asarray(Image.open(png)).shape
        if got != shape or (cmd == "sample-cm" and "--class-id" not in extra
                            and "warning: conditional consistency student" not in said):
            raise AssertionError(f"cli {cmd} {extra}: PNG {got} (make_grid gives {shape}), "
                                 f"said {said[-300:]!r}")
        res[f"{cmd} {' '.join(extra)}"] = dict(exit=0, seconds=sec, forwards=forwards,
                                                launches=launches, png=list(got))
        log(f"[distill] (c) cli {cmd} {' '.join(extra)} --n {n}: exit 0, {forwards} forwards "
            f"at {n} rows, launches {launches['gn_silu_fwd']}/{launches['flash_attn_fwd']}, "
            f"PNG {got} as make_grid gives, {sec:.2f} s")
    return res, students


def _distill_http(exp_d, tmp, cm_dir):
    """(d) The service over checkpoint directories: one that ``train_ddpm``
    wrote (through ``cli train``), whose /sample must equal
    ddim_infer_sample from the same seed; and the consistency student:
    /healthz, two concurrent sampler=cm requests in one batch, each equal
    to its re-run beside another request at the same rows (PAIR_BAR) and to
    its solo re-run (the same runs in fp32: pixels within CM_SOLO_BAR, raw
    outputs within phase 4's 1e-5; the served bf16 pair and solo raw
    outputs each as close to the fp32 ones as the other, phase 4's bf16
    rule), moved by swapping the labels, steps=2, sampler=ddim and /edit
    answer 400."""
    import base64

    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch import cli
    from ddpm_diffusion_model_tpu_torch.sampling import ddim_infer_sample
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
    from ddpm_diffusion_model_tpu_torch.training import load_run
    from ddpm_diffusion_model_tpu_torch.utils.images import encode_png, grid_nrow, make_grid

    res = {}
    cfg_json = os.path.join(tmp, "teacher.json")
    ck = os.path.join(tmp, "ck_c1")
    with _cwd(tmp):
        run_cli(["train", "--config", cfg_json, "--data", "blobs", "--synthetic-size",
                 str(TRAIN_BATCH), "--device-cache", "--epochs", "1", "--max-batches", "1",
                 "--no-samples", "--ckpt-dir", ck])
    last = os.path.join(ck, f"{exp_d['run_name']}_last")

    def serve(path):
        svc = SamplerService.from_checkpoint(path, device="cuda")
        svc.COALESCE_WINDOW_S = SOLVER_PORT_WINDOW_S
        server = make_server(svc, "127.0.0.1", 0)
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        return svc, server, th, f"http://127.0.0.1:{server.server_address[1]}"

    def stop(server, th):
        server.shutdown()
        server.server_close()
        th.join(timeout=30)

    def npy(base, query):
        code, hdr, body = _get(f"{base}/sample?{query}&format=npy")
        return code, hdr, np.load(io.BytesIO(body))

    def refused(fn):
        try:
            fn()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()
        return 200, ""

    svc, server, th, base = serve(last)
    try:
        health = json.loads(_get(base + "/healthz")[2])
        code, _h, x = npy(base, f"n={C1_N}&steps={C1_STEPS}&seed=5&class_id=2")
        args = cli.build_parser().parse_args(["sample-ddim", "--ckpt", last])
        model, sched, state, _meta = load_run(last, cli._exp_from_args(args), "cuda")
        grid = ddim_infer_sample(model, None, sched, n=C1_N, img_size=64,
                                 ema_params=state.ema_params, out_path=os.path.join(
                                     tmp, "c1_ref.png"), seed=5, steps=C1_STEPS,
                                 class_id=2, device="cuda")
        diff = float(np.abs(make_grid(x, nrow=grid_nrow(C1_N)) - grid).max())
        if code != 200 or health["consistency"] is not False or diff > PAIR_BAR \
                or health["num_classes"] != NUM_CLASSES:
            raise AssertionError(f"serving the train_ddpm directory: {code}, /healthz "
                                 f"{health}, against ddim_infer_sample max |diff| {diff}")
        res["c1"] = dict(code=code, max_diff=diff)
        log(f"[distill] (d) the service over {os.path.basename(last)} (a directory "
            f"train_ddpm wrote; its meta's experiment, EMA weights): /sample n={C1_N} "
            f"steps={C1_STEPS} class 2 against ddim_infer_sample from the same seed: max "
            f"|diff| {diff:.3e} (bar {PAIR_BAR:g})")
    finally:
        stop(server, th)
    del model, state
    torch.cuda.empty_cache()

    svc, server, th, base = serve(cm_dir)
    try:
        health = json.loads(_get(base + "/healthz")[2])
        if (health["consistency"] is not True or health["edit_modes"] != []
                or "consistency_caveat" not in health):
            raise AssertionError(f"/healthz of the consistency student: {health}")
        h = BATCH // 2
        q = lambda seed, cls: f"n={h}&seed={seed}&class_id={cls}"  # noqa: E731
        seen = _forward_modes(svc.model)
        raw_outs, capture = [], [False]

        def keep(_m, _args, out):
            if capture[0]:
                raw_outs.append(out.detach().float().cpu())

        svc.model.register_forward_hook(keep)

        def with_raw(fn):
            """fn()'s result and the student's raw outputs of its forwards."""
            raw_outs.clear()
            capture[0] = True
            try:
                got = fn()
            finally:
                capture[0] = False
            return got, list(raw_outs)

        def concurrent_pair(a, b):
            """``a`` and ``b`` in one window; ``b`` leaves a fifth of the
            window after ``a``, so ``a`` takes the batch's first rows."""
            m0 = svc.metrics()["multi_request_batches"]
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                fa = ex.submit(npy, base, q(*a))
                time.sleep(SOLVER_PORT_WINDOW_S / 5)
                fb = ex.submit(npy, base, q(*b))
                got = fa.result()[2], fb.result()[2]
            return got, svc.metrics()["multi_request_batches"] - m0

        reset_counts()
        ((xa, xb), merged), pair_raw = with_raw(lambda: concurrent_pair((1, 0), (2, 7)))
        torch.cuda.synchronize()
        pair_rows = list(seen["batches"])
        counts = read_counts()
        launches = check_launches("sampler=cm pair", counts, 1, rows=BATCH)
        # each request again at its rows beside a request of another seed and
        # class: a batch of the pair's shape, so only the company moved
        (ra, _c), m_a = concurrent_pair((1, 0), RERUN_COMPANY)
        (_c, rb), m_b = concurrent_pair(RERUN_COMPANY, (2, 7))
        rerun_err = max(float(np.abs(ra - xa).max()), float(np.abs(rb - xb).max()))
        # the labels swapped must move the rows, the served and the raw ones
        ((sa, sb), m_s), swap_raw = with_raw(lambda: concurrent_pair((1, 7), (2, 0)))
        # and alone, at half the rows
        solo, solo_raw = with_raw(lambda: [npy(base, q(1, 0))[2], npy(base, q(2, 7))[2]])
        if [tuple(o.shape[:1]) for o in pair_raw + swap_raw + solo_raw] != [(BATCH,)] * 2 \
                + [(h,)] * 2:
            raise AssertionError("sampler=cm raw outputs: rows "
                                 f"{[o.shape for o in pair_raw + swap_raw + solo_raw]}")
        pr, sw = pair_raw[0], swap_raw[0]
        solo16 = torch.cat(solo_raw)
        raw_solo_err = float((pr - solo16).abs().max())
        raw_swap = min(float((sw[:h] - pr[:h]).abs().max()), float((sw[h:] - pr[h:]).abs().max()))
        swap_diff = min(float(np.abs(sa - xa).max()), float(np.abs(sb - xb).max()))
        solo_d = np.concatenate([np.abs(xa - solo[0]).ravel(), np.abs(xb - solo[1]).ravel()])
        # the same pair and solo runs through the one forward in fp32, TF32
        # off: the served pixels hold at the solo bar there
        from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
        from ddpm_diffusion_model_tpu_torch.training import cm_from_init

        m32 = UNetDenoiser(svc.model.config, dtype=torch.float32, device="cuda").to(
            memory_format=torch.channels_last).eval()
        m32.load_state_dict(svc.model.state_dict())
        raw32 = []
        m32.register_forward_hook(lambda _m, _a, out: raw32.append(out.detach().float().cpu()))
        x_init = torch.cat([svc._init_noise(h, 1), svc._init_noise(h, 2)])
        y = torch.tensor([0] * h + [7] * h, device="cuda")
        kw = dict(sigma_data=svc.cm_sigma_data, timestep_scaling=svc.cm_timestep_scaling)
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            pair32 = cm_from_init(m32, None, svc.sched, x_init, y=y, **kw)
            solo32 = torch.cat([cm_from_init(m32, None, svc.sched, x_init[r], y=y[r], **kw)
                                for r in (slice(0, h), slice(h, None))])
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        fp32_solo_err = float((pair32 - solo32).abs().max()) / 2  # in [0, 1] pixels
        del m32

        def rel(a, b):  # relative RMS error
            return float((a - b).norm() / b.norm())

        # phase 4's rules: fp32 differs only in the order of the sums; the
        # bf16 pair and solo runs each as close to fp32 as the other
        p32 = raw32[0]
        raw_rel = {"fp32_pair_vs_solo": rel(p32, torch.cat(raw32[1:])),
                   "bf16_pair_vs_fp32": rel(pr, p32), "bf16_solo_vs_fp32": rel(solo16, p32)}
        e_p, e_s = raw_rel["bf16_pair_vs_fp32"], raw_rel["bf16_solo_vs_fp32"]
        if (merged, m_a, m_b, m_s) != (1, 1, 1, 1) or pair_rows != [BATCH] \
                or rerun_err > PAIR_BAR or float(np.abs(xa - xb).max()) < 1e-3 \
                or fp32_solo_err > CM_SOLO_BAR or raw_rel["fp32_pair_vs_solo"] > 1e-5 \
                or e_p > 1.25 * e_s + 1e-3 or e_s > 1.25 * e_p + 1e-3 \
                or swap_diff <= PAIR_CONTROL * PAIR_BAR or raw_swap <= PAIR_CONTROL * PAIR_BAR:
            raise AssertionError(
                f"sampler=cm pair: multi-request batches {(merged, m_a, m_b, m_s)}, rows "
                f"{pair_rows}, against the re-runs at the same rows max |diff| {rerun_err} "
                f"(bar {PAIR_BAR}); against the solo re-runs the fp32 pixels {fp32_solo_err} "
                f"(bar {CM_SOLO_BAR}), raw relative RMS {raw_rel}; labels swapped "
                f"{swap_diff}, raw {raw_swap} (must exceed {PAIR_CONTROL * PAIR_BAR})")
        face = _faces(1)[0] * 0.5 + 0.5
        edit = urllib.request.Request(base + "/edit", data=json.dumps({
            "image": base64.b64encode(encode_png(face)).decode()}).encode(), method="POST")
        bad = {"steps=2": refused(lambda: _get(f"{base}/sample?n=1&steps=2")),
               "sampler=ddim": refused(lambda: _get(f"{base}/sample?n=1&sampler=ddim&steps=1")),
               "/edit": refused(lambda: urllib.request.urlopen(edit, timeout=60))}
        if {k: v[0] for k, v in bad.items()} != dict.fromkeys(bad, 400):
            raise AssertionError(f"the student's refusals: {bad}")
        res["cm"] = dict(healthz=health, pair_launches=launches, merged=merged,
                         rerun_max_diff=rerun_err, raw_solo_max_diff=raw_solo_err,
                         raw_max_abs=float(pr.abs().max()), raw_rel=raw_rel,
                         fp32_solo_max_diff=fp32_solo_err, swap_diff=swap_diff,
                         raw_swap_diff=raw_swap, solo_max_diff=float(solo_d.max()),
                         solo_mean_diff=float(solo_d.mean()),
                         solo_share_over_2e_2=float((solo_d > CM_SOLO_BAR).mean()),
                         refused={k: v[0] for k, v in bad.items()})
        log(f"[distill] (d) the service over the consistency student: /healthz consistency "
            f"{health['consistency']}, edit_modes {health['edit_modes']}, the caveat; two "
            f"sampler=cm requests (n={BATCH // 2}, classes 0 and 7) in {merged} batch of "
            f"{BATCH} rows, one forward, launches {launches['gn_silu_fwd']}/"
            f"{launches['flash_attn_fwd']}; against their re-runs beside another request at "
            f"the same rows max |diff| {rerun_err:.3e} (bar {PAIR_BAR:g}); against their solo "
            f"re-runs at {h} rows: the same runs in fp32 {fp32_solo_err:.3e} in [0,1] pixels "
            f"(bar {CM_SOLO_BAR:g}); raw outputs (max |value| {float(pr.abs().max()):.3f}) "
            f"relative RMS {raw_rel} (bars 1e-5 and each bf16 run within 1.25x + 1e-3 of the "
            f"other), bf16 max |diff| {raw_solo_err:.3e}; the bf16 pixels max "
            f"{solo_d.max():.3e}, mean "
            f"{solo_d.mean():.3e}, {100 * (solo_d > CM_SOLO_BAR).mean():.2f}% beyond "
            f"{CM_SOLO_BAR:g} (not held: s / a = 156 at t = T-1 multiplies the raw output's "
            f"bf16 differences); labels swapped {swap_diff:.3e}, raw {raw_swap:.3e} (must "
            f"exceed {PAIR_CONTROL * PAIR_BAR:g}); steps=2, sampler=ddim and "
            "/edit -> " + ", ".join(str(v[0]) for v in bad.values()))
    finally:
        stop(server, th)
    return res


def phase_distill(preset, base_sd, images, tmp):
    """Progressive and consistency distillation on the 10-class
    celeba64_attn at full width, guidance GUIDANCE baked in: (a) every
    kernel call of one guided update of each kind against its plain
    version (the teacher's forwards at 2 x TRAIN_BATCH rows) and one whole
    update of each kind on the kernels against the plain versions in fp32;
    (b) progressive_distill and consistency_distill, launches exact, peak
    memory, each update's wall, device time and idle share; the kernels'
    times at the guided teacher's forward; (c) the CLI; (d) the server.
    Launches exact on every path, its counts set to 0 just before it and
    read just after."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import cfg_eps_fn
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         save_checkpoint)
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig

    exp_d = dict(cond_experiment(preset), run_name="celeba64_attn_teacher")
    cond = ExperimentConfig.from_dict(exp_d)
    sched = make_schedule(cond.diffusion, device="cuda")
    labels = (np.arange(len(images)) % NUM_CLASSES).astype(np.int64)
    batches = [(torch.from_numpy(images[i:i + TRAIN_BATCH]).cuda(),
                torch.from_numpy(labels[i:i + TRAIN_BATCH]).cuda())
               for i in range(0, 2 * TRAIN_BATCH, TRAIN_BATCH)]
    # the distillation optimizer of cli distill's defaults
    cfg = TrainConfig(base_lr=DISTILL_LR, warmup_steps=0, ema_decay=DISTILL_EMA,
                      grad_clip=cond.train.grad_clip)
    res = {"params": CFG_PARAMS, "batch": TRAIN_BATCH, "teacher_rows": 2 * TRAIN_BATCH,
           "guidance": GUIDANCE}
    part = PartClock("distill")

    # the teacher: the seeded 10-class model, saved as a port checkpoint
    model = build_cond_model(cond, base_sd)
    teacher_sd = {k: v.detach().clone() for k, v in model.named_parameters()}
    teacher_dir = os.path.join(tmp, "teacher")
    save_checkpoint(teacher_dir, init_train_state(model, cond.train)[0],
                    configs={"experiment": exp_d})

    # (a) every kernel call of a guided update of each kind; the fp32 update
    calls = _distill_calls(model, sched, teacher_sd, batches[0], cfg)
    held = list(dict.fromkeys(calls["progressive"] + calls["consistency"]))
    extra = len(set(calls["consistency"]) - set(calls["progressive"]))
    with no_tf32():
        worst = hold_calls(held, torch.Generator(device="cuda").manual_seed(43),
                           label="distill update: ")
    log(f"[distill] (a) {len(held)} distinct kernel calls of the two updates held against "
        f"their plain versions in bf16 and fp32 ({extra} of the consistency update's not in "
        "the progressive update's)")
    res["parity"] = _distill_parity(cond, sched, teacher_sd, batches[0], cfg)

    # the kernels' times at the guided teacher's forward (2 x TRAIN_BATCH rows)
    fwd_calls = []
    with torch.inference_mode(), record_calls(fwd_calls):
        cfg_eps_fn(model, sched, y=batches[0][1], guidance=GUIDANCE)(
            batches[0][0], torch.full((TRAIN_BATCH,), 500, device="cuda"))
    torch.cuda.synchronize()
    teacher_tot = kernel_totals(fwd_calls, f"guided teacher forward ({2 * TRAIN_BATCH} rows)")
    res["teacher_forward_kernels"] = teacher_tot
    part("kernels")

    # (b) the runs
    res["runs"] = _distill_runs(model, sched, teacher_sd, batches, cfg)
    del model
    torch.cuda.empty_cache()
    part("runs")

    # (c) the CLI, (d) the server
    res["cli"], students = _distill_cli(exp_d, teacher_dir, tmp, cond.diffusion.T)
    part("cli")
    res["http"] = _distill_http(exp_d, tmp, students["consistency"])
    part("http")
    res["part_seconds"] = part.done()
    launches = {k: {**{f"{kind}_run": res["runs"][kind]["launches"][k]
                       for kind in DISTILL_KINDS},
                    **{p: v["launches"][k] for p, v in res["cli"].items()},
                    "http_cm_pair": res["http"]["cm"]["pair_launches"][k]} for k in KERNELS}
    res["launches"] = launches
    return res, worst, teacher_tot


# ------------------------------------------------------------------- the DiT

DIT_PRESETS = ("celeba64_dit_s4", "celeba64_dit_moe")
DIT_256 = "dit_s4_256"  # dit_s4_256_config under celeba64_dit_s4's settings, 256 px
DIT_PARAMS = {"celeba64_dit_s4": 32_499_120, "celeba64_dit_moe": 131_787_792,
              DIT_256: 32_499_120}
DIT_HEADS = 6  # (B * 6, N, 64) flash operands
DIT_DEPTH = 12
DIT_FLASH_PER_FORWARD = DIT_DEPTH  # one attention per block, no GroupNorm
DIT_STEPS = 5  # (c): train_one_epoch steps of each 64-px preset at TRAIN_BATCH
DIT256_BATCH = 8  # 8 x 6 heads = 48 flash rows of N = 4096
DIT256_STEPS = 2
DIT_CLI_STEPS = 2  # (d): cli train --max-batches
DIT_N = 16  # (d): the CLI's grids and the service's request
DIT_DDIM_STEPS = 50  # 49 forwards
DIT_DPM_STEPS = 20  # DPM-Solver++(2M): 19 forwards
DIT_PAIR_STEPS = 10  # the coalesced pair's steps (a STEP_CHOICES rung)
DIT_PERTURB = 0.02  # the adaLN heads and final_proj moved off their zero init
# the routing check: a token the kernels route elsewhere than the plain
# versions must be a near-tie of its two largest router probabilities
DIT_NEAR_TIE = 1e-4
#: launches of each kernel in one DiT step: no GroupNorm; per block one
#: flash forward, dQ and dK/dV, bf16 on mma.sync at 64 px (N = 256), dQ and
#: dK/dV on wgmma at 256 px (N = 4096)
DIT_LAUNCHES_PER_STEP = dict(
    {k: 0 for k in LAUNCHES_PER_STEP}, **UPDATE_LAUNCHES_PER_STEP,
    **{k: DIT_FLASH_PER_FORWARD for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                          "flash_attn_bwd_dkv", "flash_attn_fwd.tc",
                                          "flash_attn_bwd_dq.tc", "flash_attn_bwd_dkv.tc")})
DIT256_LAUNCHES_PER_STEP = dict(DIT_LAUNCHES_PER_STEP, **{
    "flash_attn_bwd_dq.tc": 0, "flash_attn_bwd_dkv.tc": 0,
    "flash_attn_bwd_dq.wgmma": DIT_FLASH_PER_FORWARD,
    "flash_attn_bwd_dkv.wgmma": DIT_FLASH_PER_FORWARD})
FLASH_KERNELS = KERNELS[2:]


def dit_experiment(name):
    """The ExperimentConfig of a DiT preset, or of DIT_256: dit_s4_256_config
    with celeba64_dit_s4's diffusion and TrainConfig at 256 px, batch 8."""
    from ddpm_diffusion_model_tpu_torch.models import dit_s4_256_config
    from ddpm_diffusion_model_tpu_torch.utils.config import ExperimentConfig, get_preset

    if name != DIT_256:
        return get_preset(name)
    d = get_preset("celeba64_dit_s4").to_dict()
    d.update(model=dit_s4_256_config().to_dict(), run_name=DIT_256, img_size=256,
             batch_size=DIT256_BATCH, diffusion=dict(d["diffusion"], img_size=256))
    return ExperimentConfig.from_dict(d)


def build_dit(exp, seed):
    """The bf16 DiT of ``exp`` at full width from ``seed``, its adaLN heads
    and final_proj perturbed off zero (so its output is not 0)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser, count_params

    torch.manual_seed(seed)
    model = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda")
    n = count_params(model)
    if n != DIT_PARAMS[exp.run_name]:
        raise AssertionError(f"{exp.run_name} has {n} params, expected "
                             f"{DIT_PARAMS[exp.run_name]:,}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ada." in name or name.startswith(("final_ada.", "final_proj.")):
                p.add_(DIT_PERTURB * torch.randn_like(p))
    return model.eval()


def _dit_calls(model, exp, fwd_batch, step_batch):
    """Every kernel-wrapper call of a forward at ``fwd_batch`` and of a train
    step's forward and backward at ``step_batch``; raises unless they are
    12 flash forwards, and 12 of each flash kernel a step, and nothing else."""
    import torch

    S = exp.img_size
    gen = torch.Generator(device="cuda").manual_seed(21)
    fwd, step = [], []
    with record_calls(fwd), torch.inference_mode():
        model(torch.randn(fwd_batch, S, S, 3, generator=gen, device="cuda"),
              torch.randint(0, 1000, (fwd_batch,), generator=gen, device="cuda"))
    model.train()
    with record_calls(step):
        model(torch.randn(step_batch, S, S, 3, generator=gen, device="cuda"),
              torch.randint(1, 1000, (step_batch,), generator=gen, device="cuda"),
              generator=gen).float().square().mean().backward()
    torch.cuda.synchronize()
    model.eval()
    for p in model.parameters():
        p.grad = None
    n = DIT_FLASH_PER_FORWARD
    kinds = {k: sum(1 for c in step if c[0] == k) for k in FLASH_KERNELS}
    if ([c[0] for c in fwd] != ["flash_attn_fwd"] * n or len(step) != 3 * n
            or kinds != dict.fromkeys(FLASH_KERNELS, n)):
        raise AssertionError(f"{exp.run_name}: a forward called {[c[0] for c in fwd]}, a "
                             f"step {kinds} (of {len(step)}); expected {n} flash forwards, "
                             f"and {n} of each flash kernel a step")
    log(f"[dit] {exp.run_name}: a forward at batch {fwd_batch} calls the flash forward {n} "
        f"times at {fwd[0][1]}, a train step at batch {step_batch} each flash kernel {n} "
        f"times at {step[0][1]}; no GroupNorm")
    return fwd, step


def _routing(inputs, model):
    """Per MoE layer, from the router inputs a forward hook kept: the
    argmax expert and the gap between the two largest probabilities of every
    token, the experts' loads and the share of tokens dropped past
    capacity."""
    import torch
    import torch.nn.functional as F

    from ddpm_diffusion_model_tpu_torch.models.moe import capacity

    out = []
    for h, blk in zip(inputs, model.blocks):
        moe = blk.moe
        B, N, _ = h.shape
        E = moe.num_experts
        with torch.no_grad():
            probs = torch.softmax(F.linear(h.float(), moe.router.weight, moe.router.bias), -1)
        top2 = probs.topk(2, dim=-1).values
        idx = probs.argmax(-1)
        per_seq = F.one_hot(idx, E).sum(1)  # (B, E)
        dropped = int((per_seq - capacity(N, moe.capacity_factor, E)).clamp(min=0).sum())
        out.append(dict(idx=idx, gap=top2[..., 0] - top2[..., 1],
                        loads=torch.bincount(idx.flatten(), minlength=E).tolist(),
                        dropped_share=dropped / (B * N)))
    return out


def _dit_forward_check(exp, model):
    """(b) One forward at BATCH on the kernels against the plain versions:
    fp32 at phase 4's bar, bf16 no less accurate than the plain path; its
    launches 0 GN and 12 flash; for the MoE each layer's expert loads and
    dropped share, equal on both paths but for near-ties."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser

    model32 = build_denoiser(exp.model, dtype=torch.float32, device="cuda")
    model32.load_state_dict(model.state_dict(), strict=True)
    model32.eval()
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    moe = bool(exp.model.num_experts)
    seen = []
    hooks = [blk.moe.register_forward_hook(lambda _m, a, _o: seen.append(a[0].detach()))
             for m in (model, model32) for blk in m.blocks if moe]
    routes = {}
    with torch.inference_mode(), no_tf32():
        k32 = model32(x, t)
        routes["fp32_kernels"] = seen[:]
        seen.clear()
        reset_counts()
        k16 = model(x, t)
        torch.cuda.synchronize()
        counts = read_counts()
        routes["bf16_kernels"] = seen[:]
        seen.clear()
        with plain_path():
            p32 = model32(x, t)
            routes["fp32_plain"] = seen[:]
            seen.clear()
            p16 = model(x, t)
            routes["bf16_plain"] = seen[:]
            seen.clear()
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    _check_fwd_launches(f"{exp.run_name} forward", counts, 1, 0, DIT_FLASH_PER_FORWARD)

    def rel(a, b):  # relative RMS error
        return float((a.float() - b.float()).norm() / b.float().norm())

    out = {"fp32_kernel_vs_plain": rel(k32, p32), "bf16_kernel_vs_fp32": rel(k16, p32),
           "bf16_plain_vs_fp32": rel(p16, p32), "bf16_kernel_vs_plain": rel(k16, p16),
           "output_rms": float(p32.float().square().mean().sqrt())}
    log(f"[dit] {exp.run_name} forward at batch {BATCH} on the card, relative RMS errors: "
        f"{out}; launches GN {counts['gn_silu_fwd']}, flash {counts['flash_attn_fwd']}")
    if not (torch.isfinite(k16).all() and torch.isfinite(k32).all()) \
            or out["output_rms"] == 0.0:
        raise AssertionError(f"{exp.run_name} forward on the kernels: not finite, or 0")
    if out["fp32_kernel_vs_plain"] > 1e-5:
        raise AssertionError(f"{exp.run_name} fp32 kernels vs plain: {out}")
    if out["bf16_kernel_vs_fp32"] > 1.25 * out["bf16_plain_vs_fp32"] + 1e-3:
        raise AssertionError(f"{exp.run_name} bf16 kernel path less accurate than plain: {out}")
    if moe:
        r = {k: _routing(v, model32 if k.startswith("fp32") else model)
             for k, v in routes.items()}
        out["routing"] = {}
        for dn in ("fp32", "bf16"):
            rk, rp = r[f"{dn}_kernels"], r[f"{dn}_plain"]
            flips = [int((a["idx"] != b["idx"]).sum()) for a, b in zip(rk, rp)]
            worst_gap = max([float(b["gap"][a["idx"] != b["idx"]].max())
                             for a, b in zip(rk, rp) if (a["idx"] != b["idx"]).any()]
                            or [0.0])
            out["routing"][dn] = dict(
                loads_kernels=[a["loads"] for a in rk], loads_plain=[b["loads"] for b in rp],
                dropped_share_kernels=[a["dropped_share"] for a in rk],
                dropped_share_plain=[b["dropped_share"] for b in rp],
                tokens_routed_differently=flips, worst_gap_of_those=worst_gap)
            for i, (a, b) in enumerate(zip(rk, rp)):
                log(f"[dit] {exp.run_name} {dn} layer {i:2d}: expert loads {a['loads']} "
                    f"(plain {b['loads']}), dropped {100 * a['dropped_share']:.2f}% (plain "
                    f"{100 * b['dropped_share']:.2f}%), tokens routed differently "
                    f"{flips[i]}")
            if dn == "fp32" and worst_gap > DIT_NEAR_TIE:
                raise AssertionError(f"{exp.run_name} fp32: the kernels route "
                                     f"{sum(flips)} tokens elsewhere than the plain path, one "
                                     f"with its top two probabilities {worst_gap:.2e} apart")
        log(f"[dit] {exp.run_name}: fp32 routing on the kernels equal to the plain path's "
            f"but for {sum(out['routing']['fp32']['tokens_routed_differently'])} near-tie "
            f"tokens (top-2 gap <= {DIT_NEAR_TIE:g}); bf16 "
            f"{sum(out['routing']['bf16']['tokens_routed_differently'])} tokens of "
            f"{BATCH * exp.model.seq_len * DIT_DEPTH} routed differently")
    del model32
    torch.cuda.empty_cache()
    return out


def _dit_times_4096(step_calls):
    """Each flash kernel at N = 4096 (one call of the dit_s4_256 step, bf16)
    beside its bound, its plain version and SDPA's forward or autograd
    backward; and the fp32 kernels' (FMA) device times."""
    import torch

    fa = _kernel_modules()[1]
    one = [next(c for c in step_calls if c[0] == k) for k in FLASH_KERNELS]
    tot = kernel_totals(one, f"call at N = 4096 ({one[0][1]})", heads=DIT_HEADS)
    gen = torch.Generator(device="cuda").manual_seed(23)
    shape = one[0][1]
    args = flash_bwd_inputs(shape, torch.float32, gen)
    fma = {"flash_attn_fwd": device_ms(lambda: fa.flash_attn_fwd(*args[:3]), iters=5,
                                       gaps_ok=False),
           "flash_attn_bwd_dq": device_ms(lambda: fa.flash_attn_bwd_dq(*args), iters=5,
                                          gaps_ok=False),
           "flash_attn_bwd_dkv": device_ms(lambda: fa.flash_attn_bwd_dkv(*args), iters=5,
                                           gaps_ok=False)}
    fma = {k: (ms, ms_source(table)) for k, (ms, table) in fma.items()}
    for k in FLASH_KERNELS:
        r = tot[k]
        r["fp32_fma_ms"], r["ms_source"]["fp32_fma_ms"] = fma[k]
        fma[k] = fma[k][0]
        log(f"[dit] N = 4096 {k} {shape} bf16: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ({'operations' if r['flops_ms'] >= r['bytes_ms'] else 'bytes'}"
            f", {r['ms'] / r['bound_ms']:.2f} x the bound), SDPA "
            f"{'forward' if k == 'flash_attn_fwd' else 'autograd backward (dQ, dK, dV)'} "
            f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; fp32 on FMA "
            f"{fma[k]:.4f} ms")
    del args
    torch.cuda.empty_cache()
    return tot


def _dit_remat(exp, base_sd, images):
    """One dit_s4_256 step's loss and grads at batch 8 with remat True
    against none, from the same weights and draws: bit-equal, the flash
    forward launched again in the recompute; both peaks."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.ops.diffusion import sample_timesteps
    from ddpm_diffusion_model_tpu_torch.training import StepDraws, make_loss_fn

    sched = make_schedule(exp.diffusion, device="cuda")
    x = torch.from_numpy(images[:DIT256_BATCH]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(24)
    draws = StepDraws(sample_timesteps(DIT256_BATCH, exp.diffusion.T, gen, "cuda"),
                      torch.randn(x.shape, generator=gen, device="cuda"))
    out = {}
    for remat in (False, True):
        model = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda", remat=remat)
        model.load_state_dict(base_sd, strict=True)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        loss = make_loss_fn(model, sched)(x, draws)
        loss.backward()
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        n = DIT_FLASH_PER_FORWARD
        want = {"gn_silu_fwd": 0, "gn_silu_bwd": 0, "flash_attn_fwd": n * (2 if remat else 1),
                "flash_attn_bwd_dq": n, "flash_attn_bwd_dkv": n}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"dit_s4_256 remat={remat}: launches {got}, expected {want}")
        out[remat] = dict(loss=loss.detach(), grads=[p.grad for p in model.parameters()],
                          launches=got, peak_gib=peak / 2**30,
                          peak_over_state_gib=(peak - base) / 2**30)
        log(f"[dit] {DIT_256} remat={remat} at batch {DIT256_BATCH}: launches {got}; peak "
            f"memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB over the "
            f"weights); loss {float(loss):.6f}")
        del model, loss
        torch.cuda.empty_cache()
    a, b = out[False], out[True]
    if not (torch.equal(a["loss"], b["loss"])
            and all(torch.equal(g, h) for g, h in zip(a["grads"], b["grads"]))):
        raise AssertionError("dit_s4_256: remat=True's loss or grads differ from no remat's")
    log(f"[dit] {DIT_256}: remat=True's loss and every grad bit-equal to no remat's")
    return {str(k): {f: v for f, v in r.items() if f not in ("loss", "grads")}
            for k, r in out.items()}


def _dit_cli(tmp):
    """(d) ``cli train --preset celeba64_dit_s4`` for DIT_CLI_STEPS steps,
    then ``sample-ddim`` and ``sample-dpmpp`` on its checkpoint: exit 0,
    launches exact, PNGs as make_grid gives; ``sample-ddim --refresh-every
    2`` exits with the JAX CLI's message."""
    from ddpm_diffusion_model_tpu_torch import cli
    from ddpm_diffusion_model_tpu_torch.training import read_meta

    ck = os.path.join(tmp, "ck_dit")
    res = {}
    reset_counts()
    t0 = time.perf_counter()
    with _cwd(tmp):
        run_cli(["train", "--preset", "celeba64_dit_s4", "--data", "blobs",
                 "--synthetic-size", str(2 * TRAIN_BATCH), "--device-cache", "--epochs", "1",
                 "--max-batches", str(DIT_CLI_STEPS), "--no-samples", "--ckpt-dir", ck])
    sec = time.perf_counter() - t0
    counts = read_counts()
    want = {k: v * DIT_CLI_STEPS for k, v in DIT_LAUNCHES_PER_STEP.items()}
    got = {k: counts[k] for k in want}
    last = os.path.join(ck, "celeba64_dit_s4_last")
    model = read_meta(last)["configs"]["experiment"]["model"]
    if got != want or model.get("family") != "dit":
        raise AssertionError(f"cli train --preset celeba64_dit_s4: launches {got}, expected "
                             f"{want}; stored model {model}")
    res["train"] = dict(exit=0, seconds=sec, steps=DIT_CLI_STEPS, launches=got)
    log(f"[dit] (d) cli train --preset celeba64_dit_s4 --data blobs --device-cache: exit 0, "
        f"{DIT_CLI_STEPS} steps at batch {TRAIN_BATCH} in {sec:.1f} s (the build and the "
        f"checkpoint included), launches {got['flash_attn_fwd']}/{got['flash_attn_bwd_dq']}/"
        f"{got['flash_attn_bwd_dkv']} flash, {got['gn_silu_fwd']} GN")
    n = DIT_N
    for cmd, steps, forwards in (("sample-ddim", DIT_DDIM_STEPS, DIT_DDIM_STEPS - 1),
                                 ("sample-dpmpp", DIT_DPM_STEPS, DIT_DPM_STEPS - 1)):
        png = os.path.join(tmp, f"dit_{cmd}.png")
        reset_counts()
        t0 = time.perf_counter()
        with _cwd(tmp):
            run_cli([cmd, "--ckpt", last, "--ema", "--n", str(n), "--steps", str(steps),
                     "--out", png])
        sec = time.perf_counter() - t0
        launches = _check_fwd_launches(f"cli {cmd}", read_counts(), forwards, 0,
                                       DIT_FLASH_PER_FORWARD)
        shape = _png_file_ok(f"cli {cmd}", png, n)
        res[cmd] = dict(exit=0, seconds=sec, forwards=forwards, launches=launches, png=shape)
        log(f"[dit] (d) cli {cmd} --steps {steps} --n {n}: exit 0, {forwards} forwards, "
            f"launches {launches['flash_attn_fwd']} flash ({DIT_FLASH_PER_FORWARD} a forward), "
            f"{launches['gn_silu_fwd']} GN; PNG {shape} as make_grid gives; {sec:.2f} s")
    argv = ["sample-ddim", "--ckpt", last, "--n", "4", "--refresh-every", "2", "--out",
            os.path.join(tmp, "dit_fast.png")]
    want_msg = ("--refresh-every: encoder-cached sampling is U-Net-only (this checkpoint "
                "is a DiTConfig experiment)")
    try:
        with contextlib.redirect_stdout(io.StringIO()), _cwd(tmp):
            cli.main(argv)
        said = None
    except SystemExit as e:
        said = str(e.code)
    if said != want_msg:
        raise AssertionError(f"cli sample-ddim --refresh-every 2 on a DiT: {said!r}")
    res["refresh_every_refused"] = said
    log(f"[dit] (d) cli sample-ddim --refresh-every 2: exits {said!r}")
    return res, last


def _png_file_ok(name, path, n):
    """The PNG at ``path`` has make_grid's shape for ``n`` 64-px images."""
    import numpy as np
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    shape = make_grid(np.zeros((n, 64, 64, 3), np.float32), nrow=grid_nrow(n)).shape
    with Image.open(path) as im:
        got = np.asarray(im).shape
    if got != shape:
        raise AssertionError(f"{name}: PNG {got}, make_grid gives {shape}")
    return list(got)


def _dit_http(last, tmp):
    """(d) The service over the DiT directory ``cli train`` wrote: /healthz
    family dit; /sample equal to ddim_infer_sample from the same seed
    (PAIR_BAR), /metrics counting 0 GN and 12 flash launches a forward; two
    concurrent requests in one batch, each equal to its re-run beside the
    other (PAIR_BAR) and, reported, to its solo run."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch import cli
    from ddpm_diffusion_model_tpu_torch.sampling import ddim_infer_sample
    from ddpm_diffusion_model_tpu_torch.serving import SamplerService, make_server
    from ddpm_diffusion_model_tpu_torch.training import load_run
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    svc = SamplerService.from_checkpoint(last, device="cuda")
    svc.COALESCE_WINDOW_S = SOLVER_PORT_WINDOW_S
    server = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def npy(query):
        code, _h, body = _get(f"{base}/sample?{query}&format=npy")
        if code != 200:
            raise AssertionError(f"/sample?{query}: {code}")
        return np.load(io.BytesIO(body))

    def metrics():
        return json.loads(_get(base + "/metrics")[2])

    res = {}
    try:
        health = json.loads(_get(base + "/healthz")[2])
        if health["family"] != "dit" or health["img_size"] != 64:
            raise AssertionError(f"/healthz over the DiT directory: {health}")
        m0 = metrics()["kernel_launches"]
        t0 = time.perf_counter()
        x = npy(f"n={DIT_N}&steps={DIT_DDIM_STEPS}&seed=5")
        sec = time.perf_counter() - t0
        m1 = metrics()["kernel_launches"]
        served = {k: m1[k] - m0[k] for k in m0}
        want = {"gn_silu_fwd": 0,
                "flash_attn_fwd": DIT_FLASH_PER_FORWARD * (DIT_DDIM_STEPS - 1)}
        args = cli.build_parser().parse_args(["sample-ddim", "--ckpt", last])
        model, sched, state, _meta = load_run(last, cli._exp_from_args(args), "cuda")
        grid = ddim_infer_sample(model, None, sched, n=DIT_N, img_size=64,
                                 ema_params=state.ema_params,
                                 out_path=os.path.join(tmp, "dit_ref.png"), seed=5,
                                 steps=DIT_DDIM_STEPS, device="cuda")
        diff = float(np.abs(make_grid(x, nrow=grid_nrow(DIT_N)) - grid).max())
        if served != want or diff > PAIR_BAR or x.shape != (DIT_N, 64, 64, 3):
            raise AssertionError(f"/sample n={DIT_N}: launches {served} (expected {want}), "
                                 f"against ddim_infer_sample max |diff| {diff}")
        res["sample"] = dict(seconds=sec, launches=served, max_diff=diff, health=health)
        log(f"[dit] (d) the service over {os.path.basename(last)}: /healthz family "
            f"{health['family']}; /sample n={DIT_N} steps={DIT_DDIM_STEPS} in {sec:.2f} s, "
            f"/metrics launches {served} ({DIT_FLASH_PER_FORWARD} flash, 0 GN a forward), "
            f"against ddim_infer_sample from the same seed max |diff| {diff:.3e} "
            f"(bar {PAIR_BAR:g})")
        del model, state
        q = {s: f"n={DIT_N // 2}&steps={DIT_PAIR_STEPS}&seed={s}" for s in (11, 12)}
        solo = {s: npy(v) for s, v in q.items()}
        pairs = []
        for _ in range(2):
            before = metrics()["multi_request_batches"]
            with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
                futs = {s: ex.submit(npy, v) for s, v in q.items()}
                pairs.append({s: f.result() for s, f in futs.items()})
            if metrics()["multi_request_batches"] != before + 1:
                raise AssertionError("two concurrent /sample requests were not coalesced")
        rerun = max(float(np.abs(pairs[0][s] - pairs[1][s]).max()) for s in q)
        vs_solo = max(float(np.abs(pairs[0][s] - solo[s]).max()) for s in q)
        if rerun > PAIR_BAR:
            raise AssertionError(f"coalesced pair against its re-run: max |diff| {rerun}")
        res["pair"] = dict(rerun_max_diff=rerun, vs_solo_max_diff=vs_solo,
                           multi_request_batches=metrics()["multi_request_batches"])
        log(f"[dit] (d) two concurrent requests (n={DIT_N // 2} each, steps "
            f"{DIT_PAIR_STEPS}) in one batch, twice: each against its re-run max |diff| "
            f"{rerun:.3e} (bar {PAIR_BAR:g}), against its solo run {vs_solo:.3e} (reported)")
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=30)
    torch.cuda.empty_cache()
    return res


def phase_dit(images, tmp):
    """The DiT family at full width: (a) every flash call of celeba64_dit_s4's
    forward at BATCH and step at TRAIN_BATCH, and of dit_s4_256's at batch
    8 (N = 4096), against the plain versions in bf16 and fp32, and the
    N = 4096 times beside the bound and SDPA; (b) per preset one forward
    and one step on the kernels against the plain versions (the MoE's
    routing and its aux and router grad included); (c) train_one_epoch per
    preset and for dit_s4_256, launches exact, and remat True against none;
    (d) the CLI and the service."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array

    res = {"params": DIT_PARAMS}
    worst = dict.fromkeys(KERNELS, 0.0)
    part = PartClock("dit")
    exps = {name: dit_experiment(name) for name in DIT_PRESETS + (DIT_256,)}
    models = {name: build_dit(exps[name], seed=30 + i)
              for i, name in enumerate(DIT_PRESETS + (DIT_256,))}
    log(f"[dit] {', '.join(f'{k} {v:,}' for k, v in DIT_PARAMS.items())} params (seeded; "
        f"the adaLN heads and final_proj perturbed by {DIT_PERTURB} x N(0, 1))")

    # (a) the kernels at every flash call of the three paths
    s4_fwd, s4_step = _dit_calls(models["celeba64_dit_s4"], exps["celeba64_dit_s4"], BATCH,
                                 TRAIN_BATCH)
    l_fwd, l_step = _dit_calls(models[DIT_256], exps[DIT_256], DIT256_BATCH, DIT256_BATCH)
    with no_tf32():
        gen = torch.Generator(device="cuda").manual_seed(25)
        for label, calls in (("dit N=256: ", s4_fwd + s4_step), ("dit N=4096: ", l_fwd + l_step)):
            w = hold_calls(list(dict.fromkeys(calls)), gen, label=label)
            worst = {k: max(worst[k], w[k]) for k in KERNELS}
    log("[dit] (a) every flash call of the DiT forward and step at N = 256 and N = 4096 "
        "held against its plain version in bf16 (tensor cores) and fp32 (FMA); the plain "
        "versions at N = 4096 on all 48 heads (no slice)")
    res["n4096"] = _dit_times_4096(l_step)
    res["n256_step"] = kernel_totals(s4_step, f"DiT-S/4 train step (batch {TRAIN_BATCH})",
                                     heads=DIT_HEADS)
    part("kernels")

    # (b) whole models, (c) their steps
    res["presets"] = {}
    for name in DIT_PRESETS:
        exp, model = exps[name], models[name]
        base_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        r = {"forward": _dit_forward_check(exp, model)}
        r["parity"] = phase_train_parity(exp, base_sd, images, tag=f"dit {name}",
                                         flash_per_forward=DIT_FLASH_PER_FORWARD)
        torch.cuda.empty_cache()
        r["epoch"] = phase_train_epoch(exp, model, images, tag=f"dit {name}",
                                       per_step=DIT_LAUNCHES_PER_STEP, steps=DIT_STEPS)
        res["presets"][name] = r
        del model, base_sd
        models[name] = None
        torch.cuda.empty_cache()
    part("presets")
    exp, model = exps[DIT_256], models[DIT_256]
    base_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    t0 = time.perf_counter()
    faces = blob_faces_array(2 * DIT256_BATCH, img_size=256, seed=3)
    log(f"[dit] {len(faces)} blob faces at 256 px in {time.perf_counter() - t0:.1f} s")
    res[DIT_256] = {"epoch": phase_train_epoch(exp, model, faces, tag=f"dit {DIT_256}",
                                               per_step=DIT256_LAUNCHES_PER_STEP,
                                               steps=DIT256_STEPS, batch_size=DIT256_BATCH)}
    del model
    models[DIT_256] = None
    torch.cuda.empty_cache()
    res[DIT_256]["remat"] = _dit_remat(exp, base_sd, np.ascontiguousarray(faces))
    part(DIT_256)

    # (d) the CLI and the service
    res["cli"], last = _dit_cli(tmp)
    part("cli")
    res["http"] = _dit_http(last, tmp)
    part("http")
    res["part_seconds"] = part.done()
    res["launches"] = {k: {**{f"{n}_epoch": res["presets"][n]["epoch"]["launches"][k]
                              for n in DIT_PRESETS},
                           f"{DIT_256}_epoch": res[DIT_256]["epoch"]["launches"][k],
                           "cli_train": res["cli"]["train"]["launches"][k],
                           **{f"cli_{c}": res["cli"][c]["launches"][k]
                              for c in ("sample-ddim", "sample-dpmpp")}}
                       for k in KERNELS}
    return res, worst


# ------------------------------------------------------------- latent


LATENT_PRESET = "celeba64_latent"
VAE_PARAMS = 7_056_331  # vae_64x_config: encoder 2,979,528, decoder 4,076,803
LATENT_PARAMS = 22_061_316
VAE_BATCH = 64  # train-vae's default batch
VAE_GN_PER_PASS = 13  # GN+SiLU calls of an encode, and of a decode; no time bias
LATENT_RESBLOCKS = 17
LATENT_GN_PER_FORWARD = 2 * LATENT_RESBLOCKS + 1  # two per ResBlock and the head's
LATENT_FLASH_PER_FORWARD = 2  # the two AttnBlocks at 8x8: (B * 4, 64, 64)
LATENT_KL_WEIGHT = 1e-4  # train-vae's default
VAE_STEPS = 3  # (d): VAE steps counted and timed
LATENT_STEPS = 3  # (d): latent U-Net steps (train_one_epoch)
LATENT_N = 16  # (c): the CLI's grids
LATENT_DDIM_STEPS = 50  # 49 forwards
LATENT_DPM_STEPS = 20  # 19 forwards
LATENT_SAMPLE_BAR = 1e-3  # latent_sample, fp32 DDIM-50: kernels vs plain in [0, 1] pixels
#: launches of each kernel in one VAE step (encode + decode, forward and
#: backward) and one latent U-Net step, before the split by route
VAE_LAUNCHES_PER_STEP = dict({k: 0 for k in KERNELS}, gn_silu_fwd=2 * VAE_GN_PER_PASS,
                             gn_silu_bwd=2 * VAE_GN_PER_PASS, gn_silu_bwd_dtb=0)
LATENT_LAUNCHES_PER_STEP = dict({k: LATENT_FLASH_PER_FORWARD for k in FLASH_KERNELS},
                                gn_silu_fwd=LATENT_GN_PER_FORWARD,
                                gn_silu_bwd=LATENT_GN_PER_FORWARD,
                                gn_silu_bwd_dtb=LATENT_RESBLOCKS)
# ``python -m ddpm_diffusion_model_tpu_torch.cli`` in a fresh process, which
# writes the launch counts it ends with to a file: argv is the checkout, the
# file, then the command line
CLI_CHILD = """\
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from ddpm_diffusion_model_tpu_torch import cli
cli.main(sys.argv[3:])
with open(sys.argv[2], "w") as f:
    json.dump(chip_smoke.read_counts(), f)
"""


def by_route(calls, dtype):
    """Every counter of LAUNCHES_PER_STEP for the recorded wrapper calls
    ``calls`` at ``dtype``: the GN launches also by the route their plans
    name, the flash ones by the route ``_route`` names (bf16 on the tensor
    cores)."""
    fa = _kernel_modules()[1]
    want = dict.fromkeys((k for k in LAUNCHES_PER_STEP if k not in UPDATE_LAUNCHES_PER_STEP), 0)
    for c in calls:
        if c[0] == "gn":
            route = "smem" if _gn_fwd_plan(c, dtype)[2] else "reread"
            for k in ("gn_silu_fwd", f"gn_silu_fwd.{route}"):
                want[k] += 1
        elif c[0] == "gn_bwd":
            route = "smem" if _gn_plan(c, dtype)[2] else "reread"
            for k in ("gn_silu_bwd", f"gn_silu_bwd.{route}"):
                want[k] += 1
            want["gn_silu_bwd_dtb"] += int(c[4])
        else:
            route = fa._route(c[0], dtype, c[1][1], c[1][2], True)
            for k in (c[0], f"{c[0]}.{route}"):
                want[k] += 1
    return want


def _scaled(counts, n):
    return {k: v * n for k, v in counts.items()}


def _check_counts(name, counts, want):
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return got


def build_vae(dtype, seed=40):
    """vae_64x_config at full width from ``seed``, its GroupNorm affines
    perturbed (so a swapped scale and bias would show)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import AutoEncoderKL, count_params, vae_64x_config

    torch.manual_seed(seed)
    vae = AutoEncoderKL(vae_64x_config(), dtype=dtype, device="cuda")
    n = count_params(vae)
    if n != VAE_PARAMS:
        raise AssertionError(f"vae_64x_config has {n} params, expected {VAE_PARAMS:,}")
    with torch.no_grad():
        for name, p in vae.named_parameters():
            if ".norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return vae


def _latent_calls(vae, model, faces, latents):
    """Every wrapper call of a VAE step (its forward and backward) at
    VAE_BATCH and of a latent U-Net step at TRAIN_BATCH and forward at
    LATENT_N, and the launches of a step of each by route; raises unless a
    VAE step makes 26 GN forwards and 26 GN backwards (no time bias, no
    attention) and a latent U-Net step 35 and 35 (17 with the time bias)
    and 2 of each flash kernel."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training.vae import _vae_loss

    gen = torch.Generator(device="cuda").manual_seed(41)
    x = torch.from_numpy(faces[:VAE_BATCH]).cuda()
    eps = torch.randn(VAE_BATCH, 16, 16, 4, generator=gen, device="cuda")
    vae_step, unet_step, unet_fwd = [], [], []
    with record_calls(vae_step):
        _vae_loss(vae, x, eps, LATENT_KL_WEIGHT)[0].backward()
    z = torch.from_numpy(latents[:TRAIN_BATCH]).cuda()
    t = torch.randint(1, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    model.train()
    with record_calls(unet_step):
        model(z, t, generator=gen).float().square().mean().backward()
    model.eval()
    with record_calls(unet_fwd), torch.inference_mode():
        model(z[:LATENT_N], t[:LATENT_N])
    torch.cuda.synchronize()
    for m in (vae, model):
        for p in m.parameters():
            p.grad = None
    got = {"vae_step": by_route(vae_step, torch.bfloat16),
           "unet_step": by_route(unet_step, torch.bfloat16)}
    for name, want in (("vae_step", VAE_LAUNCHES_PER_STEP),
                       ("unet_step", LATENT_LAUNCHES_PER_STEP)):
        have = {k: got[name][k] for k in want}
        if have != want:
            raise AssertionError(f"latent: a {name} makes the calls {have}, expected {want}")
    if any(c[3] for c in vae_step) or any(c[2] != 32 for c in vae_step):
        raise AssertionError("latent: a VAE GroupNorm call with a time bias or not 32 groups")
    log(f"[latent] a VAE step at batch {VAE_BATCH} calls {got['vae_step']}; a latent U-Net "
        f"step at batch {TRAIN_BATCH} calls {got['unet_step']} (GN routes by the plans)")
    return vae_step, unet_step, unet_fwd, got


def _vae_forward_check(vae, faces):
    """(b) The VAE's full pass (encode, decode the mean) at VAE_BATCH on the
    kernels against the plain versions, at phase 4's bars; launches 26 GN."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import AutoEncoderKL

    vae32 = AutoEncoderKL(vae.config, dtype=torch.float32, device="cuda")
    vae32.load_state_dict(vae.state_dict(), strict=True)
    x = torch.from_numpy(faces[:VAE_BATCH]).cuda()
    with torch.inference_mode(), no_tf32():
        k32 = vae32(x)
        reset_counts()
        k16 = vae(x)
        torch.cuda.synchronize()
        counts = read_counts()
        with plain_path():
            p32 = vae32(x)
            p16 = vae(x)
    torch.cuda.synchronize()
    _check_fwd_launches("VAE full pass", counts, 1, 2 * VAE_GN_PER_PASS, 0)

    def rel(a, b):  # relative RMS error
        return float((a.float() - b.float()).norm() / b.float().norm())

    out = {}
    for i, what in enumerate(("x_hat", "mean", "logvar")):
        out[what] = {"fp32_kernel_vs_plain": rel(k32[i], p32[i]),
                     "bf16_kernel_vs_fp32": rel(k16[i], p32[i]),
                     "bf16_plain_vs_fp32": rel(p16[i], p32[i])}
        o = out[what]
        if not (torch.isfinite(k16[i]).all() and torch.isfinite(k32[i]).all()):
            raise AssertionError(f"VAE {what} on the kernels is not finite")
        if o["fp32_kernel_vs_plain"] > 1e-5:
            raise AssertionError(f"VAE {what} fp32 kernels vs plain: {o}")
        if o["bf16_kernel_vs_fp32"] > 1.25 * o["bf16_plain_vs_fp32"] + 1e-3:
            raise AssertionError(f"VAE {what}: bf16 kernel path less accurate than plain: {o}")
    log(f"[latent] (b) VAE full pass at batch {VAE_BATCH} on the card, relative RMS errors: "
        f"{out}; launches {counts['gn_silu_fwd']} GN, {counts['flash_attn_fwd']} flash")
    del vae32
    return out


def _vae_step_parity(vae, faces):
    """(b) One VAE step from the same weights and injected eps, fp32 and
    bf16, on the kernels and on the plain versions: the grads of train-vae's
    loss, then make_vae_train_step on them; phase 6a's bars against fp32
    plain, and the kernels' launches exact (26 GN forwards and backwards for
    the grads, as many again for the step)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import AutoEncoderKL
    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         make_vae_train_step)
    from ddpm_diffusion_model_tpu_torch.training.vae import _vae_loss

    tcfg = TrainConfig(base_lr=1e-3, warmup_steps=100, grad_clip=1.0, ema_decay=0.999,
                       flat_optimizer=False)  # train-vae's defaults
    base = {k: v.detach().clone() for k, v in vae.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(42)
    x = torch.from_numpy(faces[:VAE_BATCH]).cuda()
    eps = torch.randn(VAE_BATCH, 16, 16, 4, generator=gen, device="cuda")
    runs = {}
    with no_tf32():
        for dtype in (torch.float32, torch.bfloat16):
            for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_path)):
                m = AutoEncoderKL(vae.config, dtype=dtype, device="cuda")
                m.load_state_dict(base, strict=True)
                start = _flat(m.parameters())
                reset_counts()
                with ctx():
                    _vae_loss(m, x, eps, LATENT_KL_WEIGHT)[0].backward()
                    grads = _flat(p.grad for p in m.parameters())
                    for p in m.parameters():
                        p.grad = None
                    state, tx = init_train_state(m, tcfg)
                    state, met = make_vae_train_step(m, tx, tcfg, LATENT_KL_WEIGHT)(
                        state, x, eps=eps)
                torch.cuda.synchronize()
                runs[(str(dtype).split(".")[1], path)] = dict(
                    counts=read_counts(), loss=float(met["loss"]),
                    grad_norm=float(met["grad_norm"]), grads=grads,
                    move=_flat(m.parameters()) - start, params=_flat(m.parameters()))
                del m, state
    ref = runs[("float32", "plain")]
    eps32 = float(torch.finfo(torch.float32).eps)

    def errs(r):
        return {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
                "grad_norm": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                "grads": float((r["grads"] - ref["grads"]).norm() / ref["grads"].norm()),
                "params": float((r["params"] - ref["params"]).norm()
                                / (ref["move"].norm() + eps32 * ref["params"].norm()))}

    out = {f"{dn}_{path}": errs(r) for (dn, path), r in runs.items()
           if (dn, path) != ("float32", "plain")}
    for (dn, path), r in runs.items():
        n = 2 if path == "kernels" else 0
        _check_counts(f"VAE step {dn} on the {path}", r["counts"],
                      _scaled(VAE_LAUNCHES_PER_STEP, n))
    log(f"[latent] (b) one VAE step at batch {VAE_BATCH} from the same weights and eps: "
        f"loss {ref['loss']:.6f}, grad norm {ref['grad_norm']:.6f} (fp32 plain); relative "
        f"errors against it: {out}; launches on the kernels 52/52/0 GN, 0 flash (the grads, "
        "then the step)")
    k32 = out["float32_kernels"]
    if k32["loss"] > 1e-5 or k32["grad_norm"] > 1e-4 or k32["grads"] > 1e-4 \
            or k32["params"] > 1e-2:
        raise AssertionError(f"fp32 VAE step on the kernels vs plain: {k32}")
    kb, pb = out["bfloat16_kernels"], out["bfloat16_plain"]
    for key in kb:
        if kb[key] > 1.25 * pb[key] + 1e-3:
            raise AssertionError(f"bf16 VAE step: the kernel path is less accurate than "
                                 f"the plain path in {key}: {out}")
    torch.cuda.empty_cache()
    return out


def _vae_epoch(vae, faces, per_step):
    """(d) VAE_STEPS steps of make_vae_train_step at VAE_BATCH, bf16, the
    launches exactly ``per_step`` a step; the step's wall and device time,
    idle share, top kernels and peak memory."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import (TrainConfig, init_train_state,
                                                         make_vae_train_step)

    tcfg = TrainConfig(base_lr=1e-3, warmup_steps=100, grad_clip=1.0, ema_decay=0.999,
                       flat_optimizer=False)
    state, tx = init_train_state(vae, tcfg, seed=5)
    step = make_vae_train_step(vae, tx, tcfg, LATENT_KL_WEIGHT)
    xs = [torch.from_numpy(faces[i * VAE_BATCH:(i + 1) * VAE_BATCH]).cuda()
          for i in range(len(faces) // VAE_BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(VAE_STEPS):
        state, m = step(state, xs[i % len(xs)])
    loss = float(m["loss"])
    torch.cuda.synchronize()
    got = _check_counts(f"{VAE_STEPS} VAE steps", read_counts(), _scaled(per_step, VAE_STEPS))
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = cuda_time_ms(lambda: step(state, xs[0]), iters=10, warmup=2)
    dev, table = device_ms(lambda: step(state, xs[0]), iters=3, warmup=1)
    if not math.isfinite(loss):
        raise AssertionError(f"VAE steps: loss {loss}")
    res = dict(launches=got, launches_per_step=per_step, loss=loss, step_wall_ms=wall,
               images_per_s=VAE_BATCH * 1e3 / wall, step_device_ms=dev,
               device_ms_source=ms_source(table), idle_share=idle_of(dev, wall, table),
               peak_mem_gib=peak)
    log(f"[latent] (d) VAE step at batch {VAE_BATCH} bf16: wall {wall:.3f} ms "
        f"({res['images_per_s']:.1f} images/s), device {dev:.3f} ms, device idle "
        f"{pct(res['idle_share'])}, peak memory {peak:.2f} GiB; {VAE_STEPS} steps "
        f"launched {got}; loss {loss:.5f}")
    for name, ms, count in table[:12]:
        log(f"[latent]   {ms:8.4f} ms  x{count:<4d} {name[:110]}")
    return res


def run_cli_process(argv, cwd):
    """``cli`` ``argv`` in a fresh Python process run from ``cwd``: its
    stdout, the launch counts it ends with and its seconds; it must exit 0.
    Commands of different names may run at the same time."""
    counts_path = os.path.join(cwd, f"cli_counts_{argv[0]}.json")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", CLI_CHILD, str(REPO), counts_path, *argv],
                       cwd=cwd, capture_output=True, text=True, timeout=900)
    sec = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"cli {argv[0]} exited with {p.returncode}:\n"
                             f"{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    with open(counts_path) as f:
        return p.stdout, collections.Counter(json.load(f)), sec


def _latent_cli(tmp, vae_step, unet_step, unet_fwd):
    """(c) The CLI pipeline, each command in a fresh process: train-vae,
    train --preset celeba64_latent --latent-vae, then sample-ddim /
    sample-dpmpp / sample-ddpm --vae on its checkpoint (EMA), the three
    started together; launches exact by route, the PNGs as make_grid gives,
    the meta's scale the printed one."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import read_meta

    res = {}
    vae_dir, ck = os.path.join(tmp, "vae_ck"), os.path.join(tmp, "ck_latent")
    out, counts, sec = run_cli_process(
        ["train-vae", "--out", vae_dir, "--data", "blobs", "--synthetic-size",
         str(2 * VAE_BATCH), "--epochs", "1"], tmp)
    line = json.loads(out.strip().splitlines()[-1])
    got = _check_counts("cli train-vae", counts, _scaled(by_route(vae_step, torch.bfloat16), 2))
    if (line["factor"], line["latent_resolution"]) != (4, 16) \
            or not math.isfinite(line["loss"]):
        raise AssertionError(f"cli train-vae printed {line}")
    res["train-vae"] = dict(exit=0, seconds=sec, steps=2, launches=got, summary=line)
    log(f"[latent] (c) cli train-vae (fresh process): exit 0, 2 steps at batch {VAE_BATCH} "
        f"in {sec:.1f} s (process start and checkpoint included), launches {got}; {line}")

    out, counts, sec = run_cli_process(
        ["train", "--preset", LATENT_PRESET, "--latent-vae", vae_dir, "--data", "blobs",
         "--synthetic-size", str(2 * TRAIN_BATCH), "--epochs", "1", "--max-batches", "2",
         "--no-samples", "--ckpt-dir", ck], tmp)
    # an encode is the step's first VAE_GN_PER_PASS calls, here at TRAIN_BATCH
    encode = by_route([("gn", (TRAIN_BATCH, *s[1:]), g, tb)
                       for _, s, g, tb in vae_step[:VAE_GN_PER_PASS]], torch.bfloat16)
    step = by_route(unet_step, torch.bfloat16)
    want = {k: 2 * (encode[k] + step[k]) for k in encode}
    got = _check_counts("cli train --latent-vae", counts, want)
    printed = float(next(ln for ln in out.splitlines() if ln.startswith("[LATENT]"))
                    .rsplit("scale ", 1)[1].rstrip(")"))
    last = os.path.join(ck, f"{LATENT_PRESET}_last")
    meta = read_meta(last)
    latent = meta["configs"]["latent"]
    if round(latent["scale"], 4) != printed or latent["vae_ckpt"] != os.path.abspath(vae_dir):
        raise AssertionError(f"the meta's latent entry {latent}, printed scale {printed}")
    res["train"] = dict(exit=0, seconds=sec, steps=2, launches=got, scale=latent["scale"])
    log(f"[latent] (c) cli train --preset {LATENT_PRESET} --latent-vae (fresh process): "
        f"exit 0, {2 * TRAIN_BATCH} faces encoded (2 x {VAE_GN_PER_PASS} GN) and 2 steps "
        f"at batch {TRAIN_BATCH} in {sec:.1f} s, launches {got}; the meta's scale "
        f"{latent['scale']:.6f} is the printed {printed}")

    fwd = by_route(unet_fwd, torch.bfloat16)
    # a decode is the step's next VAE_GN_PER_PASS calls, here at LATENT_N
    dec = by_route([("gn", (LATENT_N, *s[1:]), g, tb)
                    for _, s, g, tb in vae_step[VAE_GN_PER_PASS:2 * VAE_GN_PER_PASS]],
                   torch.bfloat16)
    samplers = (("sample-ddim", LATENT_DDIM_STEPS, LATENT_DDIM_STEPS - 1),
                ("sample-dpmpp", LATENT_DPM_STEPS, LATENT_DPM_STEPS - 1),
                ("sample-ddpm", None, 1000))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(samplers)) as pool:
        runs = [pool.submit(run_cli_process,
                            [cmd, "--ckpt", last, "--ema", "--vae", vae_dir, "--n",
                             str(LATENT_N), "--out", os.path.join(tmp, f"latent_{cmd}.png")]
                            + ([] if steps is None else ["--steps", str(steps)]), tmp)
                for cmd, steps, _ in samplers]
        outs = [r.result() for r in runs]
    res["samplers_seconds"] = time.perf_counter() - t0
    for (cmd, _, forwards), (out, counts, sec) in zip(samplers, outs):
        png = os.path.join(tmp, f"latent_{cmd}.png")
        want = {k: forwards * fwd[k] + dec[k] for k in fwd}
        got = _check_counts(f"cli {cmd} --vae", counts, want)
        shape = _png_file_ok(f"cli {cmd} --vae", png, LATENT_N)
        if "[INFER-LATENT]" not in out:
            raise AssertionError(f"cli {cmd} --vae printed {out[-500:]}")
        res[cmd] = dict(exit=0, seconds=sec, forwards=forwards, launches=got, png=shape)
        log(f"[latent] (c) cli {cmd} --vae --n {LATENT_N} (fresh process): exit 0, "
            f"{forwards} forwards and one decode, launches {got}; PNG {shape} as make_grid "
            f"gives; {sec:.1f} s with the process start")
    log(f"[latent] (c) the three samplers' processes together: "
        f"{res['samplers_seconds']:.1f} s")
    return res, last, vae_dir


def _latent_sample_checks(last, vae_dir):
    """(c) latent_sample (fp32, DDIM-50, n = LATENT_N) from the CLI run's
    checkpoint (EMA) on the kernels against the plain versions from the same
    draws, within LATENT_SAMPLE_BAR in [0, 1] pixels; (d) bf16 seconds per
    decoded grid and the decode's device time."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch import cli
    from ddpm_diffusion_model_tpu_torch.models import AutoEncoderKL, UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.sampling import latent_sample
    from ddpm_diffusion_model_tpu_torch.training import load_run, load_vae

    args = cli.build_parser().parse_args(["sample-ddim", "--ckpt", last])
    model, sched, state, meta = load_run(last, cli._exp_from_args(args), "cuda")
    vae, _vs, _vm = load_vae(vae_dir, device="cuda")
    scale = meta["configs"]["latent"]["scale"]
    m32 = UNetDenoiser(model.config, dtype=torch.float32, device="cuda")
    m32.load_state_dict(model.state_dict(), strict=True)
    m32 = m32.to(memory_format=torch.channels_last)
    v32 = AutoEncoderKL(vae.config, dtype=torch.float32, device="cuda")
    v32.load_state_dict(vae.state_dict(), strict=True)
    kw = dict(n=LATENT_N, scale=scale, kind="ddim", steps=LATENT_DDIM_STEPS, seed=7)
    with no_tf32():
        k = latent_sample(m32, state.ema_params, sched, v32, None, **kw)
        with plain_path():
            p = latent_sample(m32, state.ema_params, sched, v32, None, **kw)
    diff = float(np.abs(k - p).max())
    if diff > LATENT_SAMPLE_BAR or not np.isfinite(k).all():
        raise AssertionError(f"latent_sample fp32 kernels vs plain: max |diff| {diff}")
    out = {"fp32_ddim50_kernels_vs_plain_max_diff": diff}
    latent_sample(model, state.ema_params, sched, vae, None, **kw)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latent_sample(model, state.ema_params, sched, vae, None, **kw)
    out["bf16_ddim50_grid_s"] = time.perf_counter() - t0
    z = torch.randn(LATENT_N, 16, 16, 4, generator=torch.Generator("cuda").manual_seed(8),
                    device="cuda")
    with torch.inference_mode():
        out["decode_wall_ms"] = cuda_time_ms(lambda: vae.decode(z), iters=10, warmup=2)
        out["decode_device_ms"], table = device_ms(lambda: vae.decode(z), iters=5, warmup=3)
        out["decode_device_ms_source"] = ms_source(table)
    log(f"[latent] (c) latent_sample fp32 DDIM-{LATENT_DDIM_STEPS} n={LATENT_N} on the "
        f"kernels vs the plain versions from the same draws: max |diff| {diff:.3e} in [0, 1] "
        f"pixels (bar {LATENT_SAMPLE_BAR:g}); (d) bf16: {out['bf16_ddim50_grid_s']:.3f} s "
        f"per decoded grid; the decode of {LATENT_N} latents {out['decode_device_ms']:.3f} "
        f"ms device, {out['decode_wall_ms']:.3f} ms wall")
    del model, m32, vae, v32
    torch.cuda.empty_cache()
    return out


def phase_latent(images, tmp):
    """The latent family at full width: vae_64x_config (7,056,331 params) at
    batch 64 and the celeba64_latent U-Net (22,061,316) at batch 128 on its
    latents, seeded, bf16, blob faces: (a) every kernel call of a VAE step
    and of a latent U-Net step and forward against its plain version, the
    kernels' device times at the VAE's shapes; (b) the VAE's full pass and
    one VAE step and one latent U-Net step on the kernels against the plain
    versions; (c) the CLI in fresh processes and latent_sample; (d) the
    steps' wall, device, idle share, top kernels and peak memory."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser, count_params
    from ddpm_diffusion_model_tpu_torch.sampling import encode_corpus
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    res = {"params": {"vae_64x_config": VAE_PARAMS, LATENT_PRESET: LATENT_PARAMS}}
    worst = dict.fromkeys(KERNELS, 0.0)
    part = PartClock("latent")
    exp = get_preset(LATENT_PRESET)
    vae = build_vae(torch.bfloat16)
    faces = images[:4 * VAE_BATCH]
    reset_counts()
    latents, scale = encode_corpus(vae, None, faces, batch_size=VAE_BATCH)
    torch.cuda.synchronize()
    enc = read_counts()
    if enc["gn_silu_fwd"] != 4 * VAE_GN_PER_PASS or enc["gn_silu_bwd"]:
        raise AssertionError(f"encode_corpus of {len(faces)} faces launched {enc}")
    torch.manual_seed(43)
    model = UNetDenoiser(exp.model, dtype=torch.bfloat16, device="cuda")
    if count_params(model) != LATENT_PARAMS:
        raise AssertionError(f"{LATENT_PRESET} has {count_params(model)} params")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    model = model.to(memory_format=torch.channels_last).eval()
    log(f"[latent] vae_64x_config {VAE_PARAMS:,} params, {LATENT_PRESET} {LATENT_PARAMS:,} "
        f"(seeded, GN affines perturbed); {len(faces)} blob faces encoded at batch "
        f"{VAE_BATCH} to {latents.shape} latents, scale {scale:.6f}, "
        f"{enc['gn_silu_fwd']} GN launches")

    # (a) every kernel call against its plain version, the VAE's kernel times
    vae_step, unet_step, unet_fwd, routes = _latent_calls(vae, model, faces, latents)
    with no_tf32():
        gen = torch.Generator(device="cuda").manual_seed(44)
        for label, calls in (("latent vae: ", vae_step),
                             ("latent unet: ", unet_step + unet_fwd)):
            w = hold_calls(list(dict.fromkeys(calls)), gen, label=label)
            worst = {k: max(worst[k], w[k]) for k in KERNELS}
    log("[latent] (a) every kernel call of a VAE step (batch 64) and of a latent U-Net step "
        "(batch 128) and forward (batch 16) held against its plain version in bf16 and fp32")
    res["vae_step_kernels"] = kernel_totals(vae_step, f"VAE train step (batch {VAE_BATCH})")
    part("kernels")

    # (b) whole models
    res["vae_forward"] = _vae_forward_check(vae, faces)
    res["vae_step_parity"] = _vae_step_parity(vae, faces)
    base_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res["unet_step_parity"] = phase_train_parity(exp, base_sd, latents, tag="latent",
                                                 flash_per_forward=LATENT_FLASH_PER_FORWARD)
    torch.cuda.empty_cache()
    part("parity")

    # (d) the steps
    res["vae_epoch"] = _vae_epoch(vae, faces, routes["vae_step"])
    res["unet_epoch"] = phase_train_epoch(exp, model, latents, tag="latent",
                                          per_step=routes["unet_step"], steps=LATENT_STEPS)
    del model, base_sd
    torch.cuda.empty_cache()
    part("steps")

    # (c) the CLI in fresh processes, then latent_sample on its checkpoint
    res["cli"], last, vae_dir = _latent_cli(tmp, vae_step, unet_step, unet_fwd)
    part("cli")
    res["sample"] = _latent_sample_checks(last, vae_dir)
    part("latent_sample")
    res["part_seconds"] = part.done()
    res["launches"] = {k: {"vae_epoch": res["vae_epoch"]["launches"][k],
                           "unet_epoch": res["unet_epoch"]["launches"][k],
                           **{f"cli_{c}": res["cli"][c]["launches"][k]
                              for c in ("train-vae", "train", "sample-ddim", "sample-dpmpp",
                                        "sample-ddpm")}}
                       for k in KERNELS}
    del vae
    torch.cuda.empty_cache()
    return res, worst


def phase_remat(preset, base_sd, images):
    """One train step of celeba64_attn at batch 128, dropout 0.1, from the
    same weights and seed with remat False, True and "masks": the updated
    params, grad norm, loss and generator bit-equal; launches as the
    config says; peak memory of each."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step

    sched = make_schedule(preset.diffusion, device="cuda")
    x = torch.from_numpy(images[:TRAIN_BATCH]).cuda()
    out, first = {}, None
    for remat in (False, True, "masks"):
        model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda", remat=remat)
        model.load_state_dict(base_sd, strict=True)
        model = model.to(memory_format=torch.channels_last).train()
        n_res, n_attn = _resblocks(model), _attnblocks(model)
        state, tx = init_train_state(model, preset.train, seed=6)
        step = make_train_step(model, sched, tx, preset.train)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with cudnn_deterministic():
            reset_counts()
            state, m = step(state, x)
            torch.cuda.synchronize()
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = remat_launches(n_res, remat, n_attn)
        got = {k: counts[k] for k in want}
        if (n_res, n_attn) != (22, 5) or got != want:
            raise AssertionError(f"remat={remat!r}: {n_res} ResBlocks, {n_attn} AttnBlocks, "
                                 f"launches {got}, expected {want}")
        res = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   params=_flat(model.parameters()), gen=state.generator.get_state(),
                   launches=got, peak_gib=peak / 2**30,
                   step_peak_over_state_gib=(peak - base) / 2**30)
        log(f"[remat] remat={remat!r}: launches {got} (config: {n_res} ResBlocks, {n_attn} "
            f"AttnBlocks); peak memory {res['peak_gib']:.2f} GiB ({res['step_peak_over_state_gib']:.2f}"
            f" GiB over the state); loss {res['loss']:.6f}, grad norm {res['grad_norm']:.6f}")
        first = first or res
        same = (res["loss"] == first["loss"] and res["grad_norm"] == first["grad_norm"]
                and torch.equal(res["params"], first["params"])
                and torch.equal(res["gen"], first["gen"]))
        if not same:
            d = float((res["params"] - first["params"]).abs().max())
            raise AssertionError(f"remat={remat!r} differs from remat=False: loss "
                                 f"{res['loss']} vs {first['loss']}, grad norm "
                                 f"{res['grad_norm']} vs {first['grad_norm']}, params max "
                                 f"|diff| {d:.3e}")
        out[str(remat)] = {k: v for k, v in res.items() if k not in ("params", "gen")}
        del model, state, step, tx
        torch.cuda.empty_cache()
    log("[remat] updated params, grad norm, loss and the generator bit-equal across "
        "remat False, True and 'masks'")
    return out


def build_hq256():
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser, count_params
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    preset = get_preset(HQ_PRESET)
    torch.manual_seed(1)
    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda",
                         remat=preset.remat)
    n = count_params(model)
    if n != 63_100_675 or preset.remat is not True:
        raise AssertionError(f"{HQ_PRESET}: {n} params, remat {preset.remat!r}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    log(f"[hq256] {HQ_PRESET}: {n:,} params (seed 1), remat={preset.remat}, "
        f"batch {preset.batch_size} = {preset.train.grad_accum_steps} x "
        f"{preset.batch_size // preset.train.grad_accum_steps}")
    return preset, model.to(memory_format=torch.channels_last).train()


def phase_hq256():
    """celebahq256 at full width with remat=True and the preset's
    TrainConfig: every kernel call of one micro-batch against its plain
    version; HQ_STEPS train steps (wall, device time, idle share, launches,
    top kernels); remat's peak memory against no remat's; each kernel's
    times at these shapes."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step

    preset, model = build_hq256()
    accum = preset.train.grad_accum_steps
    micro = preset.batch_size // accum
    S, T = preset.img_size, preset.diffusion.T
    t0 = time.perf_counter()
    x = torch.from_numpy(np.ascontiguousarray(
        blob_faces_array(preset.batch_size, img_size=S, seed=1))).cuda()
    log(f"[hq256] {preset.batch_size} synthetic blob faces at {S}x{S} in "
        f"{time.perf_counter() - t0:.1f} s")
    sched = make_schedule(preset.diffusion, device="cuda")
    n_res, n_attn = _resblocks(model), _attnblocks(model)
    per_micro = remat_launches(n_res, True, n_attn)
    if (n_res, n_attn) != (27, 3):
        raise AssertionError(f"{HQ_PRESET}: {n_res} ResBlocks, {n_attn} AttnBlocks")

    # the calls of one micro-batch's forward, recompute and backward
    calls = []
    gen = torch.Generator(device="cuda").manual_seed(9)
    t = torch.randint(1, T, (micro,), generator=gen, device="cuda")
    with record_calls(calls):
        model(x[:micro], t, generator=gen).float().square().mean().backward()
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    kinds = {"gn_silu_fwd": "gn", "gn_silu_bwd": "gn_bwd", "flash_attn_fwd": "flash_attn_fwd",
             "flash_attn_bwd_dq": "flash_attn_bwd_dq", "flash_attn_bwd_dkv": "flash_attn_bwd_dkv"}
    got = {k: sum(c[0] == v for c in calls) for k, v in kinds.items()}
    got["gn_silu_bwd_dtb"] = sum(c[0] == "gn_bwd" and c[4] for c in calls)
    if got != per_micro:
        raise AssertionError(f"a {HQ_PRESET} micro-batch made the calls {got}, the config "
                             f"says {per_micro}")
    log(f"[hq256] one micro-batch of {micro} (forward, remat recompute, backward) calls "
        f"{got} = the config's {n_res} ResBlocks x 2 GN (+ the head, + {2 * n_res} "
        f"recomputed) and {n_attn} attentions")
    routes = {}
    for c in calls:
        if c[0] in ("gn", "gn_bwd"):
            plan = (_gn_fwd_plan if c[0] == "gn" else _gn_plan)(c, torch.bfloat16)
            key = f"{c[0]} {'x'.join(map(str, c[1]))} -> {plan[0]}{'s' if plan[2] else 'r'}"
            routes[key] = routes.get(key, 0) + 1
    log("[hq256] GN routes by call (cluster, s = chunk in shared memory, r = re-read), bf16: "
        + "; ".join(f"{k} x{n}" for k, n in routes.items()))
    worst = hold_calls(calls, torch.Generator(device="cuda").manual_seed(10), "hq256 ")

    # HQ_STEPS train steps of the preset's batch, accumulated over micro-batches
    state, tx = init_train_state(model, preset.train, seed=5)
    step = make_train_step(model, sched, tx, preset.train)
    state, _ = step(state, x)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the path's launches: set to 0 just before, read just after
    t0 = time.perf_counter()
    for _ in range(HQ_STEPS):
        state, m = step(state, x)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / HQ_STEPS * 1e3
    counts = read_counts()
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * accum * HQ_STEPS for k, v in per_micro.items()}
    got = {k: counts[k] for k in want}
    if got != want or not np.isfinite(loss) or not np.isfinite(float(m["grad_norm"])):
        raise AssertionError(f"{HQ_STEPS} {HQ_PRESET} steps: launches {got} (want {want}), "
                             f"loss {loss}, grad norm {float(m['grad_norm'])}")
    dev, table = device_ms(lambda: step(state, x), iters=1, warmup=0)
    log(f"[hq256] {HQ_STEPS} train steps: wall {wall:.1f} ms per step "
        f"({preset.batch_size * 1e3 / wall:.1f} images/s), device {dev:.1f} ms, device idle "
        f"{pct(idle_of(dev, wall, table))}, loss {loss:.5f}, peak memory "
        f"{step_peak:.2f} GiB; launches per step "
        f"{ {k: v // HQ_STEPS for k, v in got.items()} }")
    for name, ms, count in table[:15]:
        log(f"[hq256]   {ms:9.4f} ms  x{count:<5d} {name[:110]}")

    # memory: one micro-batch's forward and backward with remat and without
    plain = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
    plain.load_state_dict(model.state_dict())
    plain = plain.to(memory_format=torch.channels_last).train()
    peaks = {}
    for name, mdl in (("remat", model), ("no_remat", plain)):
        mdl.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen = torch.Generator(device="cuda").manual_seed(9)
        mdl(x[:micro], t, generator=gen).float().square().mean().backward()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        mdl.zero_grad(set_to_none=True)
    del plain
    torch.cuda.empty_cache()
    log(f"[hq256] one micro-batch of {micro}, forward and backward, peak memory over the "
        f"weights: remat=True {peaks['remat']:.2f} GiB, no remat {peaks['no_remat']:.2f} GiB")
    if not peaks["remat"] < peaks["no_remat"]:
        raise AssertionError(f"remat's peak is not below no remat's: {peaks}")

    tot = kernel_totals(calls, f"{HQ_PRESET} micro-batch ({micro})")
    per_step = {k: {f: (v if f == "ms_source" else v * accum) for f, v in r.items()}
                for k, r in tot.items()}
    return dict(step_wall_ms=wall, step_device_ms=dev, device_ms_source=ms_source(table),
                idle_share=idle_of(dev, wall, table),
                images_per_s=preset.batch_size * 1e3 / wall, loss=loss,
                step_peak_gib=step_peak, micro_peak_over_weights_gib=peaks,
                launches=got, launches_per_step={k: v // HQ_STEPS for k, v in got.items()},
                gn_routes=routes, worst=worst), per_step


# ------------------------------------------------------------------ data

DATA_JPEGS = 8192  # blob faces as JPEG (quality 95) at CelebA's aligned 178x218
DATA_PNGS = 64
DATA_PARITY = 64  # images held native against PIL, each format
DATA_RATE_IMAGES = 2048  # images per decode-rate measurement
DATA_CLI_BATCHES = 10  # --max-batches of each CLI training run
DATA_EVAL_SIZE = 128  # (f): eval --eval-size
DATA_CLI_EPOCHS = 3  # epoch 1 saves a checkpoint while epoch 2 runs; epoch 3 runs alone
CELEBA_TRAIN = 162_770  # CelebA's official train split
PREFETCH_BATCHES = 64
PREFETCH_STEPS = 20  # train steps timed with and without device_prefetch
#: the JAX package's ``info --preset celeba64_attn``, pinned by the CPU tests
JAX_INFO = REPO / "tests" / "jax_info_celeba64_attn.json"


def _face_corpus_bytes(faces):
    """DATA_JPEGS JPEG and DATA_PNGS PNG encodings at 178x218 (W x H) of the
    64-px ``faces``, each face in variants (flip, brightness) so the files
    differ; encoded on every core."""
    import numpy as np
    from PIL import Image

    u8 = ((faces + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)

    def encode(i, fmt):
        face = u8[i % len(u8)]
        v = i // len(u8)
        if v & 1:
            face = face[:, ::-1]
        face = np.clip(face.astype(np.int16) + 6 * (v >> 1) - 24, 0, 255).astype(np.uint8)
        img = Image.fromarray(np.ascontiguousarray(face)).resize((178, 218), Image.BICUBIC)
        buf = io.BytesIO()
        img.save(buf, format=fmt, **({"quality": 95} if fmt == "JPEG" else {}))
        return buf.getvalue()

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        jpegs = list(pool.map(lambda i: encode(i, "JPEG"), range(DATA_JPEGS)))
        pngs = list(pool.map(lambda i: encode(i * 7 + 3, "PNG"), range(DATA_PNGS)))
    return jpegs, pngs


def _decode_rate(dataset, workers, n):
    """Images/s of a DataLoader over the first ``n`` items of ``dataset``."""
    from ddpm_diffusion_model_tpu_torch.data import DataLoader, ImageFolderDataset

    ds = ImageFolderDataset(None, dataset.transform, img_size=dataset.img_size,
                            crop=dataset.crop, initial_resize=dataset.initial_resize,
                            use_native=dataset.decoder == "native",
                            paths=dataset.paths[:n])
    t0 = time.perf_counter()
    seen = sum(len(x) for x, _ in DataLoader(ds, TRAIN_BATCH, shuffle=False,
                                             drop_last=False, num_workers=workers))
    return seen / (time.perf_counter() - t0)


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_cli(argv):
    """``python -m ddpm_diffusion_model_tpu_torch.cli`` in this process (so
    the launch counts stay readable); its stdout; any exit fails."""
    from ddpm_diffusion_model_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            raise AssertionError(f"cli {argv[0]} exited with {e.code!r}:\n"
                                 f"{out.getvalue()[-3000:]}") from e
    return out.getvalue()


def phase_data(preset, base_sd, faces, tmp, train_ips=None):
    """The data pipeline and the CLI on celeba64_attn: (a) a zip of blob
    faces as CelebA-sized JPEGs and PNGs; (b) the decoder route, native
    against PIL, decode rates; (c) ``cli train`` from the zip, from the host
    loader and from the device cache, with its launches; (d) the device
    cache at CelebA's train split; (e) ``device_prefetch`` bit-equal to a
    synchronous copy, and the step with and without it; (f) the other CLI
    commands from (c)'s checkpoint, four of them in fresh processes started
    together."""
    import zipfile

    import numpy as np
    import torch
    from PIL import Image

    from ddpm_diffusion_model_tpu_torch import native
    from ddpm_diffusion_model_tpu_torch.data import (DataLoader, DeviceCacheLoader,
                                                     device_prefetch,
                                                     get_celeba_loader_from_zip,
                                                     materialize_corpus)
    from ddpm_diffusion_model_tpu_torch.data.loader import dequantize, quantize_u8
    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    res = {"cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads()}
    # (a) the corpus
    t0 = time.perf_counter()
    jpegs, pngs = _face_corpus_bytes(faces)
    zpath = os.path.join(tmp, "faces.zip")
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_STORED) as zf:
        for i, b in enumerate(jpegs):
            zf.writestr(f"img_align_celeba/{i:06d}.jpg", b)
        for i, b in enumerate(pngs):
            zf.writestr(f"img_align_celeba/png/{i:06d}.png", b)
    res["corpus"] = dict(jpegs=len(jpegs), pngs=len(pngs), zip_mib=os.path.getsize(zpath) / 2**20,
                         seconds=time.perf_counter() - t0)
    log(f"[data] (a) {len(jpegs)} JPEGs (q95) + {len(pngs)} PNGs at 178x218 zipped: "
        f"{res['corpus']['zip_mib']:.1f} MiB in {res['corpus']['seconds']:.1f} s")

    # (b) decoding through the zip loader's dataset
    # the directory the CLI extracts to from ``tmp`` (its default, relative)
    zl = get_celeba_loader_from_zip(zpath, os.path.join(tmp, "data", "celeba_zip"),
                                    img_size=64, batch_size=TRAIN_BATCH)
    ds = zl.dataset
    res["decoder"] = ds.decoder
    log(f"[data] (b) {len(ds)} images; decoder route {ds.decoder}"
        + ("" if ds.decoder == "native" else f" (native off: {native.unavailable_reason()})"))
    png_paths = [p for p in ds.paths if p.endswith(".png")][:DATA_PARITY]
    jpg_paths = [p for p in ds.paths if p.endswith(".jpg")][:DATA_PARITY]
    if ds.decoder == "native":
        errs = {}
        for kind, paths in (("png", png_paths), ("jpeg", jpg_paths)):
            d = []
            for p in paths:
                with Image.open(p) as img:
                    d.append(np.abs(ds._load(ds.paths.index(p)) - ds.transform(img)))
            d = np.stack(d)
            errs[kind] = dict(max=float(d.max()), mean=float(d.mean()))
        if errs["png"]["max"] > 2.5 / 255 or errs["jpeg"]["mean"] >= 0.02:
            raise AssertionError(f"native against PIL beyond tests/test_native.py's bars: {errs}")
        res["native_vs_pil"] = errs
        log(f"[data] (b) native vs PIL on {DATA_PARITY} PNGs: max |err| "
            f"{errs['png']['max']:.5f} (bar {2.5 / 255:.5f}); on {DATA_PARITY} JPEGs: mean "
            f"|err| {errs['jpeg']['mean']:.5f} (bar 0.02)")
    rates = {}
    routes = ["native", "pil"] if ds.decoder == "native" else ["pil"]
    for route in routes:
        probe = ds if route == "native" else type(ds)(
            None, ds.transform, img_size=64, crop=ds.crop, initial_resize=ds.initial_resize,
            use_native=False, paths=ds.paths)
        for w in sorted({8, os.cpu_count()}):
            rates[f"{route}_w{w}"] = _decode_rate(probe, w, DATA_RATE_IMAGES)
    res["decode_images_per_s"] = rates
    log(f"[data] (b) decode images/s ({DATA_RATE_IMAGES} images, batch {TRAIN_BATCH}; "
        f"os.cpu_count() {os.cpu_count()}, torch threads {torch.get_num_threads()}): "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()))
    if ds.decoder != "native":
        log("[data] (b) FINDING: no native decoder on this host; the loader decodes "
            "with PIL")

    # (c) training through the CLI, from the host loader and the device cache
    cli_runs = {}
    for label, extra in (("host", []), ("device_cache", ["--device-cache"])):
        ck = os.path.join(tmp, f"ck_{label}")
        reset_counts()
        t0 = time.perf_counter()
        with _cwd(tmp):
            out = run_cli(["train", "--preset", RUN_PRESET, "--data", "zip", "--zip-path",
                           zpath, "--epochs", str(DATA_CLI_EPOCHS),
                           "--max-batches", str(DATA_CLI_BATCHES),
                           "--no-samples", "--ckpt-dir", ck, *extra])
        sec = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(ck, f"{RUN_PRESET}_metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        steps = DATA_CLI_EPOCHS * DATA_CLI_BATCHES
        want = {k: v * steps for k, v in LAUNCHES_PER_STEP.items()}
        got = {k: counts[k] for k in want}
        final = json.loads(out.strip().splitlines()[-1])
        ips = [r["imgs_per_s"] for r in recs]
        if (got != want or [r["global_step"] for r in recs]
                != [DATA_CLI_BATCHES * (e + 1) for e in range(DATA_CLI_EPOCHS)]
                or not np.isfinite(final["final_loss"])):
            raise AssertionError(f"cli train ({label}): launches {got} (want {want}), "
                                 f"metrics {recs}, result {final}")
        cli_runs[label] = dict(imgs_per_s_by_epoch=ips, imgs_per_s_epoch2=ips[1],
                               imgs_per_s_epoch3=ips[2], final_loss=final["final_loss"],
                               seconds=sec, launches=got)
        log(f"[data] (c) cli train --data zip {' '.join(extra)}: {steps} steps at batch "
            f"{TRAIN_BATCH}, bf16, 31,312,131 params; images/s by epoch "
            + ", ".join(f"{v:.1f}" for v in ips)
            + f" (epoch 2 runs beside epoch 1's checkpoint save); {sec:.1f} s in all; "
            f"final loss {final['final_loss']:.5f}; launches {got}")
        for ln in out.splitlines():
            if ln.startswith(("[DATA]", "[CORPUS]", "[CACHE]", "[RESUME]")):
                log(f"[data] (c)   {ln}")
    res["cli_train"] = cli_runs
    if train_ips is not None:
        log(f"[data] (c) against phase 6c's step on an in-memory batch: {train_ips:.1f} "
            f"images/s; epoch 2 / 3 from the host loader "
            f"{cli_runs['host']['imgs_per_s_epoch2']:.1f} / "
            f"{cli_runs['host']['imgs_per_s_epoch3']:.1f}, from the device cache "
            f"{cli_runs['device_cache']['imgs_per_s_epoch2']:.1f} / "
            f"{cli_runs['device_cache']['imgs_per_s_epoch3']:.1f}")

    # (d) the device cache at CelebA's train split, tiled from the decoded corpus
    t0 = time.perf_counter()
    decoded = materialize_corpus(ds, num_workers=os.cpu_count())
    dec_s = time.perf_counter() - t0
    codes = quantize_u8(decoded)
    tiled = codes[np.arange(CELEBA_TRAIN) % len(codes)]
    cache = DeviceCacheLoader(tiled, TRAIN_BATCH, seed=0, quantize=True, device="cuda")
    nbytes = cache.corpus_bytes
    if nbytes != CELEBA_TRAIN * 64 * 64 * 3 or cache.corpus.dtype != torch.uint8:
        raise AssertionError(f"cache holds {nbytes} B of {cache.corpus.dtype}")
    order = cache.epoch_order()
    host_order = DataLoader(range(CELEBA_TRAIN), TRAIN_BATCH, seed=0)._epoch_indices()
    if not np.array_equal(order, host_order):
        raise AssertionError("the cache's epoch order is not DataLoader's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_batches, first = 0, None
    for x, _ in cache:
        if first is None:
            first = x.clone()
        n_batches += 1
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    want_first = dequantize(torch.from_numpy(tiled[order[:TRAIN_BATCH]]))
    if n_batches != CELEBA_TRAIN // TRAIN_BATCH or not torch.equal(first.cpu(), want_first):
        raise AssertionError(f"cache epoch: {n_batches} batches; first batch equal to the "
                             f"host path: {torch.equal(first.cpu(), want_first)}")
    res["device_cache"] = dict(images=CELEBA_TRAIN, corpus_bytes=nbytes,
                               upload_s=cache.upload_seconds,
                               upload_gb_per_s=nbytes / cache.upload_seconds / 1e9,
                               epoch_gathers=n_batches, epoch_s=epoch_s,
                               gather_us=epoch_s / n_batches * 1e6,
                               decode_all_s=dec_s, decode_all_images_per_s=len(ds) / dec_s)
    log(f"[data] (d) decoded the {len(ds)} images in {dec_s:.2f} s "
        f"({len(ds) / dec_s:.1f} images/s, {os.cpu_count()} workers); cache of "
        f"{CELEBA_TRAIN} images at 64 px as uint8: {nbytes} B ({nbytes / 1e9:.3f} GB), "
        f"uploaded in {cache.upload_seconds:.3f} s ({nbytes / cache.upload_seconds / 1e9:.2f} "
        f"GB/s); one epoch's {n_batches} gathers of {TRAIN_BATCH} in {epoch_s:.3f} s "
        f"({epoch_s / n_batches * 1e6:.1f} us each); order = DataLoader's, first batch "
        f"bit-equal to the host path")
    del cache, tiled, codes
    torch.cuda.empty_cache()

    # (e) device_prefetch: bit-equal to a synchronous copy; the step with and without
    batches = [np.ascontiguousarray(decoded[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(PREFETCH_BATCHES)]
    n_eq = 0
    for (x, _), b in zip(device_prefetch(iter(batches), size=2, device="cuda"), batches):
        sync = torch.from_numpy(b).cuda()
        n_eq += int(torch.equal(x, sync))
    if n_eq != PREFETCH_BATCHES:
        raise AssertionError(f"device_prefetch: {n_eq} of {PREFETCH_BATCHES} batches "
                             "bit-equal to the synchronous copy")
    model = UNetDenoiser(preset.model, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(base_sd)
    model = model.to(memory_format=torch.channels_last)
    state, tx = init_train_state(model, preset.train, seed=1)
    step = make_train_step(model, make_schedule(preset.diffusion, device="cuda"), tx,
                           preset.train)
    walls = {}
    for label in ("sync", "prefetch", "prefetch", "sync"):
        src = iter(batches[:PREFETCH_STEPS])
        feed = (device_prefetch(src, size=2, device="cuda") if label == "prefetch"
                else ((torch.from_numpy(b).cuda(), None) for b in src))
        step(state, torch.from_numpy(batches[0]).cuda())  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, _ in feed:
            state, _m = step(state, x)
        torch.cuda.synchronize()
        walls.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / PREFETCH_STEPS)
    res["prefetch"] = dict(batches_bit_equal=n_eq, of=PREFETCH_BATCHES,
                           step_wall_ms=walls)
    log(f"[data] (e) device_prefetch: {n_eq}/{PREFETCH_BATCHES} batches bit-equal to the "
        f"synchronous copy; step wall over {PREFETCH_STEPS} steps (sync, prefetch, "
        f"prefetch, sync): {walls['sync'][0]:.2f}, {walls['prefetch'][0]:.2f}, "
        f"{walls['prefetch'][1]:.2f}, {walls['sync'][1]:.2f} ms")
    del model, state, step
    torch.cuda.empty_cache()

    # (f) the other commands from (c)'s checkpoint, each in a fresh process,
    # all started together
    last = os.path.join(tmp, "ck_host", f"{RUN_PRESET}_last")
    blank = lambda n: np.zeros((n, 64, 64, 3), np.float32)  # noqa: E731
    cmds = {}
    jobs = [("sample-ddim", ["--n", "16", "--steps", "50"],
             make_grid(blank(16), nrow=grid_nrow(16)).shape),
            ("strip", ["--sampler", "ddim"], make_grid(blank(17), nrow=17, padding=2).shape),
            ("sample-ddpm", ["--n", "16"], make_grid(blank(16), nrow=grid_nrow(16)).shape)]
    argvs = [[cmd, "--ckpt", last, "--ema", *extra, "--out", os.path.join(tmp, f"{cmd}.png")]
             for cmd, extra, _ in jobs]
    argvs.append(["eval", "--ckpt", last, "--data", "blobs", "--eval-size",
                  str(DATA_EVAL_SIZE), "--rfid-n", "16"])
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(argvs)) as pool:
        runs = [pool.submit(run_cli_process, argv, tmp) for argv in argvs]
        outs = [r.result() for r in runs]
    together = time.perf_counter() - t0
    launches = dict.fromkeys(KERNELS, 0)
    for _, counts, _ in outs:
        launches = {k: launches[k] + counts[k] for k in KERNELS}
    for (cmd, extra, shape), (_, _, sec) in zip(jobs, outs):
        got = np.asarray(Image.open(os.path.join(tmp, f"{cmd}.png"))).shape
        if got != shape:
            raise AssertionError(f"{cmd}: PNG {got}, make_grid gives {shape}")
        cmds[cmd] = dict(exit=0, png=list(got), seconds=sec)
        log(f"[data] (f) {cmd} {' '.join(extra)} (fresh process): exit 0, PNG {got} as "
            f"make_grid gives, {sec:.2f} s with the process start")
    out, _, sec = outs[-1]
    ev = json.loads(out.strip().splitlines()[-1])
    if (set(ev) != {"ckpt", "global_step", "val_loss", "val_loss_ema", "rfid_ema"}
            or not all(np.isfinite(ev[k]) for k in ("val_loss", "val_loss_ema", "rfid_ema"))):
        raise AssertionError(f"eval: {ev}")
    cmds["eval"] = dict(exit=0, seconds=sec, **{k: ev[k] for k in
                                                ("val_loss", "val_loss_ema", "rfid_ema")})
    log(f"[data] (f) eval --data blobs --eval-size {DATA_EVAL_SIZE} --rfid-n 16 (fresh "
        f"process): exit 0, JAX's keys, "
        f"val_loss {ev['val_loss']:.5f}, val_loss_ema {ev['val_loss_ema']:.5f}, rfid_ema "
        f"{ev['rfid_ema']:.4f}, {sec:.2f} s with the process start")
    log(f"[data] (f) the four processes together: {together:.1f} s")
    cmds["seconds_together"] = together
    info = run_cli(["info", "--preset", RUN_PRESET])
    if info != JAX_INFO.read_text():
        raise AssertionError("info --preset celeba64_attn differs from the JAX package's")
    cmds["info"] = dict(exit=0, equals_jax=True)
    log("[data] (f) info --preset celeba64_attn: exit 0, the JAX package's JSON")
    res["commands"] = cmds
    res["commands_launches"] = launches
    return res


# ------------------------------------------------------------------ parallel

RING_SHAPE = (DIT256_BATCH * DIT_HEADS, 4096, 64)  # dit_s4_256_config's attention
RING_SIZES = (2, 4, 8)
PAR_STEPS = 2  # (c): --max-batches of each torchrun CLI run
PAR_TIMED_STEPS = 10  # (b): celeba64_attn steps timed with and without a placed state
PAR_N = 16  # (c): sample-ddim --sharded's grid
TORCHRUN = (sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "1")


def _ring_hold(q, k, v, do, S, dn, single, plain):
    """The virtual ring over S blocks (the same hop code the distributed
    ring runs) against one flash call and the plain versions at phase 3's
    bars, its launches exact: S^2 flash forwards at N / S and S^2 of each
    backward kernel.  Returns (the max |err| by kernel, the launches counted
    over the forward and the backward)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.ops.ring_attention import (virtual_ring_attention,
                                                                   virtual_ring_attention_bwd)

    reset_counts()
    o, lse = virtual_ring_attention(q, k, v, S)
    dq, dk, dv = virtual_ring_attention_bwd(q, k, v, o, lse, do, S)
    torch.cuda.synchronize()
    c = read_counts()
    got = {k_: c[k_] for k_ in FLASH_KERNELS}
    if got != dict.fromkeys(FLASH_KERNELS, S * S):
        raise AssertionError(f"virtual ring S={S} {dn}: launches {got}, expected {S * S} each")
    errs = {"flash_attn_fwd": 0.0, "flash_attn_bwd_dq": 0.0, "flash_attn_bwd_dkv": 0.0}
    for ref_name, (o1, lse1, dq1, dk1, dv1) in (("one call", single), ("plain", plain)):
        tag = f"ring S={S} {dn} vs {ref_name}"
        errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"],
                                     check_close(f"{tag} O", o, o1, *TOL[dn]))
        check_close(f"{tag} LSE", lse, lse1, 1e-4, 1e-5)
        errs["flash_attn_bwd_dq"] = max(errs["flash_attn_bwd_dq"],
                                        check_scaled(f"{tag} dQ", dq, dq1, BWD_TOL[dn]))
        errs["flash_attn_bwd_dkv"] = max(errs["flash_attn_bwd_dkv"],
                                         check_scaled(f"{tag} dK", dk, dk1, BWD_TOL[dn]),
                                         check_scaled(f"{tag} dV", dv, dv1, BWD_TOL[dn]))
    return errs, got


def _ring_times(q, k, v, do, S):
    """Device ms of one hop of each kernel at N / S, and of the whole
    virtual ring forward and backward (its merges included)."""
    from ddpm_diffusion_model_tpu_torch.ops.ring_attention import (virtual_ring_attention,
                                                                   virtual_ring_attention_bwd)

    fa = _kernel_modules()[1]
    n = q.shape[1] // S
    qb, kb, vb, dob = (t[:, :n].contiguous() for t in (q, k, v, do))
    ob, lseb = fa.flash_attn_fwd(qb, kb, vb)
    delta = (dob.float() * ob.float()).sum(-1)
    o, lse = virtual_ring_attention(q, k, v, S)
    return _timed({
        "hop_fwd_ms": (lambda: fa.flash_attn_fwd(qb, kb, vb), 5),
        "hop_dq_ms": (lambda: fa.flash_attn_bwd_dq(qb, kb, vb, dob, lseb, delta), 5),
        "hop_dkv_ms": (lambda: fa.flash_attn_bwd_dkv(qb, kb, vb, dob, lseb, delta), 5),
        "ring_fwd_ms": (lambda: virtual_ring_attention(q, k, v, S), 3),
        "ring_bwd_ms": (lambda: virtual_ring_attention_bwd(q, k, v, o, lse, do, S), 3)})


def _timed(fns: dict) -> dict:
    """``{key: device ms}`` of each ``key: (fn, iters)``, never from CUDA
    events with launch gaps (these feed the kernels line), and
    ``ms_source``: where each came from."""
    out, sources = {}, {}
    for key, (fn, iters) in fns.items():
        ms, table = device_ms(fn, iters=iters, gaps_ok=False)
        out[key], sources[key] = ms, ms_source(table)
    out["ms_source"] = sources
    return out


def _virtual_ring():
    """(a) The ring at dit_s4_256_config's attention, (48, 4096, 64), bf16
    and fp32, S = 2, 4, 8."""
    import torch

    fa = _kernel_modules()[1]
    res, worst = {}, dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(61)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        q, k, v, do = (torch.randn(RING_SHAPE, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o1, lse1 = fa.flash_attn_fwd(q, k, v)
        single = (o1, lse1, *fa.flash_attn_bwd(q, k, v, o1, lse1, do))
        op, lsep = fa.flash_attn_reference(q, k, v)
        deltap = (do.float() * op.float()).sum(-1)
        plain = (op, lsep, fa.flash_attn_bwd_dq_reference(q, k, v, do, lsep, deltap),
                 *fa.flash_attn_bwd_dkv_reference(q, k, v, do, lsep, deltap))
        del deltap
        r = {}
        if dtype == torch.bfloat16:
            d1 = (do.float() * o1.float()).sum(-1)
            r["single"] = _timed({
                "fwd_ms": (lambda: fa.flash_attn_fwd(q, k, v), 5),
                "dq_ms": (lambda: fa.flash_attn_bwd_dq(q, k, v, do, lse1, d1), 5),
                "dkv_ms": (lambda: fa.flash_attn_bwd_dkv(q, k, v, do, lse1, d1), 5)})
            r["bound_ms"] = {
                name: bounds(*fn(RING_SHAPE, 2), "bfloat16")["bound_ms"]
                for name, fn in (("fwd", flash_bytes_flops), ("dq", flash_dq_bytes_flops),
                                 ("dkv", flash_dkv_bytes_flops))}
        for S in RING_SIZES:
            with no_tf32():
                errs, got = _ring_hold(q, k, v, do, S, dn, single, plain)
            worst = {k_: max(worst[k_], errs.get(k_, 0.0)) for k_ in KERNELS}
            r[f"S{S}"] = {"max_abs_err": errs, "launches_fwd_plus_bwd": got}
            if dtype == torch.bfloat16:
                r[f"S{S}"].update(_ring_times(q, k, v, do, S))
            log(f"[parallel] (a) virtual ring S={S} {RING_SHAPE} {dn}: {S * S} hops of each "
                f"kernel at N = {RING_SHAPE[1] // S}; max|err| against one call and the plain "
                f"versions: " + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items())
                + ("" if dtype != torch.bfloat16 else
                   f"; device ms: hop fwd {r[f'S{S}']['hop_fwd_ms']:.4f}, dQ "
                   f"{r[f'S{S}']['hop_dq_ms']:.4f}, dK/dV {r[f'S{S}']['hop_dkv_ms']:.4f}; the "
                   f"ring fwd {r[f'S{S}']['ring_fwd_ms']:.4f}, bwd "
                   f"{r[f'S{S}']['ring_bwd_ms']:.4f}"))
        if dtype == torch.bfloat16:
            s = r["single"]
            log(f"[parallel] (a) one call at {RING_SHAPE} bf16: fwd {s['fwd_ms']:.4f} ms, dQ "
                f"{s['dq_ms']:.4f}, dK/dV {s['dkv_ms']:.4f} (bounds fwd "
                f"{r['bound_ms']['fwd']:.4f}, dQ {r['bound_ms']['dq']:.4f}, dK/dV "
                f"{r['bound_ms']['dkv']:.4f})")
        res[dn] = r
        del q, k, v, do, single, plain, op, lsep
        torch.cuda.empty_cache()
    return res, worst


def _nccl_world1(tmp, sample_ckpt):
    """(b) A world-1 NCCL group in this process: the ring bit-equal to the
    flash call, dit_s4_256 with attn_impl="ring" bit-equal to "auto"
    (forward and one step, 0 / 0 / 12 / 12 / 12 launches), the
    celeba64_attn step with and without a placed state, and
    sample_grid_sharded of ``sample_ckpt``'s EMA (the grid (c) compares)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import flash_attention as fa
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.ops.ring_attention import (context_parallel_mesh,
                                                                   ring_attention_sharded)
    from ddpm_diffusion_model_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                                         place_state)
    from ddpm_diffusion_model_tpu_torch.sampling import sample_grid_sharded
    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, load_run,
                                                         make_train_step)
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    res = {}
    initialize_distributed("cuda", init_method=f"file://{tmp}/nccl_store", rank=0,
                           world_size=1)
    try:
        res["backend"] = str(dist.get_backend())
        cp = make_mesh((1,), ("cp",), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(62)
        shape = (DIT256_BATCH, DIT_HEADS, 4096, 64)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        outs = []
        for fn in (lambda a, b, c: ring_attention_sharded(a, b, c, cp, "cp"),
                   fa.flash_attention):
            a, b, c = (t.clone().requires_grad_() for t in (q, k, v))
            o = fn(a, b, c)
            (o.float() * g.float()).sum().backward()
            outs.append((o.detach(), a.grad, b.grad, c.grad))
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise AssertionError("ring_attention_sharded at world 1 differs from flash_attention")
        log(f"[parallel] (b) NCCL world 1 ({res['backend']}): ring_attention_sharded "
            f"{shape} bf16 bit-equal to flash_attention, forward and dQ, dK, dV")

        exp = dit_experiment(DIT_256)
        auto = build_dit(exp, seed=32)
        sd = {k_: v_.detach().clone() for k_, v_ in auto.state_dict().items()}
        ring = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda",
                              attn_impl="ring")
        ring.load_state_dict(sd)
        sched = make_schedule(exp.diffusion, device="cuda")
        x = torch.randn(DIT256_BATCH, 256, 256, 3, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (DIT256_BATCH,), generator=gen, device="cuda")
        with torch.inference_mode(), context_parallel_mesh(cp, "cp"):
            fr = ring.eval()(x, t)
        with torch.inference_mode():
            fa_ = auto.eval()(x, t)
        if not torch.equal(fr, fa_):
            raise AssertionError("dit_s4_256 forward: attn_impl='ring' differs from 'auto'")
        steps = {}
        for name, model in (("auto", auto), ("ring", ring)):
            state, tx = init_train_state(model, exp.train, seed=5)
            step = make_train_step(model, sched, tx, exp.train)
            reset_counts()
            ctx = context_parallel_mesh(cp, "cp") if name == "ring" else contextlib.nullcontext()
            with ctx:
                state, m = step(state, x)
            torch.cuda.synchronize()
            c = read_counts()
            steps[name] = (float(m["loss"]), _flat(model.parameters()),
                           {k_: c[k_] for k_ in KERNELS})
        want = DIT_LAUNCHES_PER_STEP
        if steps["ring"][2] != {k_: want[k_] for k_ in KERNELS}:
            raise AssertionError(f"ring step launches {steps['ring'][2]}, expected "
                                 f"{ {k_: want[k_] for k_ in KERNELS} }")
        if steps["ring"][0] != steps["auto"][0] or not torch.equal(steps["ring"][1],
                                                                   steps["auto"][1]):
            raise AssertionError("dit_s4_256 step: attn_impl='ring' differs from 'auto'")
        res["dit_ring"] = {"launches_per_step": steps["ring"][2], "bit_equal": True}
        log(f"[parallel] (b) dit_s4_256 at batch {DIT256_BATCH}, attn_impl='ring' under "
            f"context_parallel_mesh: forward and one step bit-equal to 'auto', launches "
            f"{steps['ring'][2]}")
        del auto, ring, sd, steps, fr, fa_, q, k, v, g, outs
        torch.cuda.empty_cache()

        # the celeba64_attn step at batch 128 with and without a placed state
        preset = get_preset("celeba64_attn")
        images = torch.from_numpy(_par_images(TRAIN_BATCH)).cuda()
        times = {}
        for mode in ("none", "dp"):
            torch.manual_seed(preset.seed)
            model = build_denoiser(preset.model, dtype=torch.bfloat16, device="cuda").to(
                memory_format=torch.channels_last)
            state, tx = init_train_state(model, preset.train, seed=0)
            if mode == "dp":
                state = place_state(state, make_mesh(device="cuda"))
            step = make_train_step(model, make_schedule(preset.diffusion, device="cuda"), tx,
                                   preset.train)
            box = [state]

            def run():
                box[0], _m = step(box[0], images)

            wall = cuda_time_ms(run, iters=PAR_TIMED_STEPS, warmup=2)
            dev, table = device_ms(run, iters=3, warmup=1)
            coll = sum(ms for name, ms, _n in table if "nccl" in name.lower())
            host = []  # the host's time in the step call, the device left running
            for _ in range(PAR_TIMED_STEPS):
                t0 = time.perf_counter()
                run()
                host.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            times[mode] = dict(wall_ms=wall, device_ms=dev, device_ms_source=ms_source(table),
                               nccl_ms=coll, host_ms=float(np.median(host)),
                               idle_share=idle_of(dev, wall, table))
            where = ("placed over a world-1 NCCL mesh (data parallel)" if mode == "dp"
                     else "on one card")
            log(f"[parallel] (b) celeba64_attn step at {TRAIN_BATCH}, bf16, state {where}"
                f": wall {wall:.3f} ms, device {dev:.3f} ms (NCCL kernels {coll:.3f} ms), idle "
                f"{pct(times[mode]['idle_share'])}, the host in the step call "
                f"{times[mode]['host_ms']:.3f} ms (median)")
            if mode == "dp":  # the all-reduce of the grads' size alone
                buf = torch.zeros(sum(p.numel() for p in model.parameters()) + 1,
                                  device="cuda")
                enq, tot = [], []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    dist.all_reduce(buf)
                    enq.append(1e3 * (time.perf_counter() - t0))
                    torch.cuda.synchronize()
                    tot.append(1e3 * (time.perf_counter() - t0))
                times["all_reduce"] = dict(numel=buf.numel(), enqueue_ms=float(np.median(enq)),
                                           done_ms=float(np.median(tot)))
                log(f"[parallel] (b) one all_reduce of {buf.numel():,} fp32 at world 1: the "
                    f"call returns in {times['all_reduce']['enqueue_ms']:.3f} ms, done in "
                    f"{times['all_reduce']['done_ms']:.3f} ms (host clock, median of 5)")
                del buf
            del model, state, step, box
            torch.cuda.empty_cache()
        res["step_times"] = times

        # (c)'s grid, in this process
        model, sched, state, _meta = load_run(sample_ckpt, preset, "cuda")
        mesh = make_mesh(device="cuda")
        out = os.path.join(tmp, "grid_inprocess.png")
        reset_counts()
        x01 = sample_grid_sharded(model, None, sched, mesh, kind="ddim", n=PAR_N, img_size=64,
                                  seed=1234, steps=50, ema_params=state.ema_params,
                                  save_path=out)
        res["grid_launches"] = {k_: read_counts()[k_] for k_ in KERNELS}
        res["grid"] = out
        if x01.shape != (PAR_N, 64, 64, 3) or not np.isfinite(x01).all():
            raise AssertionError(f"sample_grid_sharded: {x01.shape}")
    finally:
        dist.destroy_process_group()
    return res


def _par_images(n):
    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array

    return blob_faces_array(n, img_size=64, seed=7)


# the CLI child with cuDNN's deterministic algorithms, so two processes
# doing the same work give the same bits; the command's arguments come in a
# JSON file (torchrun before 2.13 would read an abbreviation such as ``--n``
# after the script as its own option)
PAR_CHILD = """\
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
import chip_smoke
from ddpm_diffusion_model_tpu_torch import cli
with open(sys.argv[3]) as f:
    cli.main(json.load(f))
with open(sys.argv[2], "w") as f:
    json.dump(chip_smoke.read_counts(), f)
"""


def _cli_start(name, argv, tmp, torchrun=True):
    """Start ``cli`` ``argv`` in a fresh process (under ``torchrun --standalone
    --nproc_per_node 1``, or plain), its output into files named for
    ``name``; returns the handle :func:`_cli_wait` takes."""
    child = os.path.join(tmp, "par_child.py")
    if not os.path.exists(child):
        with open(child, "w") as f:
            f.write(PAR_CHILD)
    paths = {k: os.path.join(tmp, f"{name}.{k}") for k in ("argv", "counts", "out", "err")}
    with open(paths["argv"], "w") as f:
        json.dump(list(argv), f)
    launcher = list(TORCHRUN) if torchrun else [sys.executable]
    out, err = open(paths["out"], "w"), open(paths["err"], "w")
    p = subprocess.Popen([*launcher, child, str(REPO), paths["counts"], paths["argv"]],
                         cwd=tmp, stdout=out, stderr=err)
    return name, p, paths, (out, err), time.perf_counter()


def _cli_wait(handle):
    """(stdout, the launch counts the process ends with, seconds) of a
    :func:`_cli_start` process; it must exit 0."""
    name, p, paths, files, t0 = handle
    try:
        rc = p.wait(timeout=900)
    finally:
        for f in files:
            f.close()
    sec = time.perf_counter() - t0
    with open(paths["out"]) as f:
        out = f.read()
    if rc != 0:
        with open(paths["err"]) as f:
            err = f.read()
        raise AssertionError(f"cli {name} exited with {rc}:\n{out[-2000:]}\n{err[-3000:]}")
    with open(paths["counts"]) as f:
        return out, collections.Counter(json.load(f)), sec


def _state_diff(a, b, start):
    """Max |diff| of the params and EMA of checkpoints ``a`` and ``b``, and
    ||params_a - params_b|| over the norm of ``b``'s move from ``start``."""
    import torch

    sa, sb = (torch.load(os.path.join(p, "state.pt"), map_location="cpu", weights_only=True)
              for p in (a, b))
    diff = max(float((sa[key][n].float() - sb[key][n].float()).abs().max())
               for key in ("params", "ema_params") for n in sb[key])
    flat = lambda st: torch.cat([st["params"][n].float().reshape(-1)  # noqa: E731
                                 for n in start])
    pa, pb = flat(sa), flat(sb)
    s0 = torch.cat([start[n].float().cpu().reshape(-1) for n in start])
    return diff, float((pa - pb).norm() / (pb - s0).norm())


def _parallel_cli(tmp):
    """(c) Fresh processes on the card, started together (they share the
    card): train --mesh dp under torchrun (bit-equal to the same run
    without a mesh), --mesh fsdp (phase 6a's bar on the params, 1e-2 of the
    steps' move), --mesh dp --device-cache-sharded, train-vae --mesh dp,
    and sample-ddim --sharded on a checkpoint of the runs' initial state
    written here; exact launches; every run exits 0.  Returns the results
    and that checkpoint."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.training import (build_model, init_train_state,
                                                         save_checkpoint)
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    res = {}
    preset = get_preset("celeba64_attn")
    model, _sched = build_model(preset, "cuda")  # the runs' init
    start = {n: p.detach().cpu() for n, p in model.named_parameters()}
    last = "celeba64_attn_last"
    ck = os.path.join(tmp, "ck_init", last)
    save_checkpoint(ck, init_train_state(model, preset.train)[0],
                    configs={"experiment": preset.to_dict()})
    del model
    torch.cuda.empty_cache()
    data = ["--data", "synthetic", "--synthetic-size", str(PAR_STEPS * TRAIN_BATCH),
            "--max-batches", str(PAR_STEPS), "--epochs", "1", "--no-samples"]
    train = ["train", "--preset", "celeba64_attn", *data]
    modes = (("dp", ["--mesh", "dp"]), ("fsdp", ["--mesh", "fsdp"]),
             ("dp_sharded_cache", ["--mesh", "dp", "--device-cache-sharded"]))
    t0 = time.perf_counter()
    handles = [_cli_start("none", [*train, "--ckpt-dir", "ck_none"], tmp, torchrun=False)]
    handles += [_cli_start(mode, [*train, "--ckpt-dir", f"ck_{mode}", *extra], tmp)
                for mode, extra in modes]
    handles.append(_cli_start("train_vae", [
        "train-vae", "--out", "vae_mesh", "--data", "synthetic", "--synthetic-size",
        str(PAR_STEPS * VAE_BATCH), "--batch-size", str(VAE_BATCH), "--epochs", "1",
        "--mesh", "dp"], tmp))
    handles.append(_cli_start("sample", [
        "sample-ddim", "--ckpt", ck, "--preset", "celeba64_attn", "--ema", "--n", str(PAR_N),
        "--steps", "50", "--out", "grid_torchrun.png", "--sharded"], tmp))
    done = {h[0]: _cli_wait(h) for h in handles}
    res["concurrent_seconds"] = time.perf_counter() - t0
    res["none"] = {"seconds": done["none"][2]}
    want = {k: PAR_STEPS * LAUNCHES_PER_STEP[k] for k in KERNELS}
    for mode, extra in modes:
        out, counts, sec = done[mode]
        got = {k: counts[k] for k in KERNELS}
        if got != want:
            raise AssertionError(f"torchrun train {mode}: launches {got}, expected {want}")
        loss = json.loads(out.strip().splitlines()[-1])["final_loss"]
        if not np.isfinite(loss):
            raise AssertionError(f"torchrun train {mode}: final loss {loss}")
        r = {"seconds": sec, "launches": got, "final_loss": loss}
        if mode != "dp_sharded_cache":
            diff, rel = _state_diff(os.path.join(tmp, f"ck_{mode}", last),
                                    os.path.join(tmp, "ck_none", last), start)
            r.update(max_abs_diff_vs_no_mesh=diff, params_vs_move=rel)
            if mode == "dp" and diff != 0.0:
                raise AssertionError(f"train --mesh dp at world 1 differs from the run "
                                     f"without a mesh by {diff}")
            if rel > 1e-2:
                raise AssertionError(f"train --mesh {mode} at world 1: params differ by "
                                     f"{rel:.3e} of the steps' move")
        res[mode] = r
        log(f"[parallel] (c) torchrun train --preset celeba64_attn {' '.join(extra)}: exit 0 "
            f"in {sec:.1f} s, {PAR_STEPS} steps, launches {got}, final loss {loss:.5f}"
            + (f"; params and EMA max |diff| against the run without a mesh "
               f"{r['max_abs_diff_vs_no_mesh']:.3e} ({r['params_vs_move']:.3e} of the move)"
               if "params_vs_move" in r else ""))
    out, counts, sec = done["train_vae"]
    got = {k: counts[k] for k in KERNELS}
    want_vae = {k: PAR_STEPS * VAE_LAUNCHES_PER_STEP[k] for k in KERNELS}
    if got != want_vae:
        raise AssertionError(f"torchrun train-vae --mesh dp: launches {got}, expected "
                             f"{want_vae}")
    loss = json.loads(out.strip().splitlines()[-1])["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"torchrun train-vae --mesh dp: loss {loss}")
    res["train_vae"] = {"seconds": sec, "launches": got, "loss": loss}
    log(f"[parallel] (c) torchrun train-vae --mesh dp: exit 0 in {sec:.1f} s, {PAR_STEPS} "
        f"steps at batch {VAE_BATCH}, launches {got}, loss {loss:.5f}; the six processes "
        f"together {res['concurrent_seconds']:.1f} s")
    out, counts, sec = done["sample"]
    got = {k: counts[k] for k in KERNELS}
    n_fwd = 49  # a DDIM-50 grid: 49 forwards
    want_s = dict(dict.fromkeys(KERNELS, 0), gn_silu_fwd=n_fwd * GN_LAUNCHES_PER_FORWARD,
                  flash_attn_fwd=n_fwd * FLASH_LAUNCHES_PER_FORWARD)
    if got != want_s:
        raise AssertionError(f"torchrun sample-ddim --sharded: launches {got}, expected "
                             f"{want_s}")
    res["sample_ddim_sharded"] = {"seconds": sec, "launches": got,
                                  "line": out.strip().splitlines()[-1]}
    log(f"[parallel] (c) torchrun sample-ddim --sharded n={PAR_N}: exit 0 in {sec:.1f} s, "
        f"launches {got}: {res['sample_ddim_sharded']['line']}")
    return res, ck


def phase_parallel(tmp):
    """Data, fully-sharded and context parallelism on one card: (a) the
    virtual ring at N = 4096 against one flash call and the plain versions;
    (c) fresh torchrun processes of the CLI, run before (b), which samples
    (c)'s grid in this process; (b) a world-1 NCCL group in this process."""
    import numpy as np
    from PIL import Image

    res = {}
    res["ring"], worst = _virtual_ring()
    res["cli"], ck = _parallel_cli(tmp)
    with cudnn_deterministic():
        res["world1"] = _nccl_world1(tmp, ck)
    a, b = (np.asarray(Image.open(os.path.join(tmp, p))).astype(np.int16)
            for p in ("grid_torchrun.png", "grid_inprocess.png"))
    if a.shape != b.shape or np.abs(a - b).max() > 1:
        raise AssertionError("sample-ddim --sharded under torchrun differs from "
                             "sample_grid_sharded in this process by more than one "
                             "8-bit level")
    if res["world1"]["grid_launches"] != res["cli"]["sample_ddim_sharded"]["launches"]:
        raise AssertionError("the in-process grid's launches differ from the CLI's")
    res["grid_pixels_differing"] = int((a != b).sum())
    log(f"[parallel] (c) the torchrun grid against sample_grid_sharded in this process "
        f"{a.shape}: {res['grid_pixels_differing']} of {a.size} values differ (by one 8-bit "
        f"level at most)")
    ring8 = res["ring"]["bfloat16"]["S8"]["launches_fwd_plus_bwd"]
    res["launches"] = {k: {"ring_S8_fwd_plus_bwd": ring8.get(k, 0),
                           "dit_ring_step": res["world1"]["dit_ring"]["launches_per_step"][k],
                           **{f"cli_{m}": res["cli"][m]["launches"][k]
                              for m in ("dp", "fsdp", "dp_sharded_cache")},
                           "cli_train_vae": res["cli"]["train_vae"]["launches"][k],
                           "cli_sample_ddim_sharded":
                               res["cli"]["sample_ddim_sharded"]["launches"][k]}
                       for k in KERNELS}
    return res, worst


# ------------------------------------------------------------------ model parallelism

MP_TP_ATTN = (2, 4)  # (a): celeba64_attn's 4 heads over R virtual ranks
MP_TP_DIT = (2, 3, 6)  # (a): celeba64_dit_s4's 6 heads
MP_EP = (2, 4, 8)  # (b): celeba64_dit_moe's 8 experts
MP_PP = ((2, 2), (2, 4), (3, 3), (3, 6), (4, 4), (4, 8))  # (c): (S, M), 12 blocks
MP_PP_BATCH = {2: TRAIN_BATCH, 3: 126, 4: TRAIN_BATCH}  # divisible by M = S and 2S
MP_GRID_N = 16  # (c): the DDIM-50 grid through the pipeline
MP_GRID_BAR = 1e-3  # (c): [0, 1] pixels, fp32, against the plain grid
MP_SERVE_N = 4  # (e): the served request
MP_SERVE_STEPS = 10
MP_SERVE_BAR = 1e-5  # (e): [0, 1] pixels against the in-process service
# calls traced: one step of each parallel form and of the unsharded model
# (a trace of one call cannot come back with a kernel count that is no
# multiple of the calls: no retrace), 10 each of a head-sharded flash call
# and of SDPA on the same rows
MP_TIMED = 1
MP_ITERS = (10, 0, 10)
MP_PP_STEPS = ((2, 2), (3, 3), (4, 4), (4, 8))  # (c): the (S, M) of the steps held


def _mp_ctx(kind, size):
    """A context factory: the virtual form of ``kind`` ("tp", "ep") over
    ``size`` ranks in this process."""
    from ddpm_diffusion_model_tpu_torch.parallel import (VirtualMesh, expert_parallel_mesh,
                                                         tensor_parallel_mesh)

    if kind == "tp":
        return lambda: tensor_parallel_mesh(VirtualMesh((size,), ("model",)))
    return lambda: expert_parallel_mesh(VirtualMesh((size,), ("expert",)))


def _mp_pp(S, M, mesh=None):
    """A wrapper: the model as a ``PipelinedDiT`` over S virtual stages (or
    over ``mesh``'s ``pp`` axis), M microbatches."""
    from ddpm_diffusion_model_tpu_torch.parallel import PipelinedDiT, VirtualMesh

    return lambda m: PipelinedDiT(m, mesh if mesh is not None else
                                  VirtualMesh((S,), ("pp",)), microbatches=M)


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _mp_forwards(name, model, model32, x, t, forms, plain, routing=False):
    """Each parallel form's fp32 and bf16 forward on the kernels against
    the unsharded plain path (``plain``: the fp32 and bf16 outputs), at
    phase 4's bars; ``forms`` maps a label to (ctx factory or None, wrap
    or None).  With ``routing`` (the MoE) the aux and each layer's routing
    too: equal to the unsharded kernels' but for near-ties."""
    import torch

    out = {}
    for label, (ctx, wrap) in forms.items():
        res = {}
        seen = {}
        for dn, m in (("fp32", model32), ("bf16", model)):
            hooks, got = [], []
            if routing:
                hooks = [blk.moe.register_forward_hook(
                    lambda _m, a, _o, got=got: got.append(a[0].detach())) for blk in m.blocks]
            call = wrap(m) if wrap is not None else m
            with torch.inference_mode(), no_tf32(), (ctx() if ctx else contextlib.nullcontext()):
                y = call(x, t, return_aux=True) if routing else (call(x, t), None)
            for hk in hooks:
                hk.remove()
            y, aux = y
            res[dn] = y
            seen[dn] = (got, aux)
        e = {"fp32_vs_plain": _rel(res["fp32"], plain["fp32"]),
             "bf16_vs_fp32": _rel(res["bf16"], plain["fp32"]),
             "plain_bf16_vs_fp32": _rel(plain["bf16"], plain["fp32"])}
        if not torch.isfinite(res["bf16"]).all() or e["fp32_vs_plain"] > 1e-5 \
                or e["bf16_vs_fp32"] > 1.25 * e["plain_bf16_vs_fp32"] + 1e-3:
            raise AssertionError(f"{name} {label} forward against the unsharded plain path: {e}")
        if routing:
            aux, aux0 = float(seen["fp32"][1]), float(plain["aux"])
            e["aux_rel"] = abs(aux - aux0) / abs(aux0)
            r, r0 = _routing(seen["fp32"][0], model32), _routing(plain["moe_in"], model32)
            flips = [int((a["idx"] != b["idx"]).sum()) for a, b in zip(r, r0)]
            gaps = [float(b["gap"][a["idx"] != b["idx"]].max())
                    for a, b in zip(r, r0) if (a["idx"] != b["idx"]).any()]
            e.update(tokens_routed_differently=sum(flips), worst_gap=max(gaps or [0.0]))
            if e["aux_rel"] > 1e-5 or e["worst_gap"] > DIT_NEAR_TIE:
                raise AssertionError(f"{name} {label}: aux or routing off the unsharded "
                                     f"MoE's: {e}")
        out[label] = e
        log(f"[model_parallel] {name} {label} forward at batch {x.shape[0]}, relative RMS "
            f"against the unsharded plain path: " + ", ".join(
                f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}" for k, v in e.items()))
    return out


def _mp_plain(model, model32, x, t, moe=False):
    """The unsharded fp32 and bf16 forwards on the plain versions (and the
    MoE's fp32 aux and router inputs)."""
    import torch

    seen = []
    hooks = ([blk.moe.register_forward_hook(lambda _m, a, _o: seen.append(a[0].detach()))
              for blk in model32.blocks] if moe else [])
    out = {}
    with torch.inference_mode(), no_tf32(), plain_path():
        if moe:
            out["fp32"], out["aux"] = model32(x, t, return_aux=True)
        else:
            out["fp32"] = model32(x, t)
        for hk in hooks:
            hk.remove()
        out["bf16"] = model(x, t)
    out["moe_in"] = seen
    return out


def _step_errs(r, ref):
    eps32 = 1.1920929e-07
    return {"loss": abs(r["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_norm": abs(r["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
            "grads": float((r["grads"] - ref["grads"]).norm() / ref["grads"].norm()),
            "params": float((r["params"] - ref["params"]).norm()
                            / (ref["move"].norm() + eps32 * ref["params"].norm()))}


_MP_REFS = {}


def _mp_steps(name, exp, base_sd, x, draws, forms, bf16_forms):
    """One step of each parallel form (fp32; bf16 too for ``bf16_forms``) on
    the kernels against the unsharded step on the plain versions (made once
    per model), at phase 6a's bars; returns the errors and each form's
    launches and recorded kernel calls (of its last run)."""
    import torch

    if name not in _MP_REFS:
        with no_tf32():
            refs = {"fp32": _one_step(exp, base_sd, torch.float32, plain_path, x, draws)}
        refs["bf16"] = _one_step(exp, base_sd, torch.bfloat16, plain_path, x, draws)
        _MP_REFS[name] = refs
        torch.cuda.empty_cache()
    refs = _MP_REFS[name]
    base_b = _step_errs(refs["bf16"], refs["fp32"])
    out, launches, calls = {"plain_bf16_vs_fp32": base_b}, {}, {}
    for label, (ctx, wrap) in forms.items():
        for dn, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            if dn == "bf16" and label not in bf16_forms:
                continue
            rec = []
            with no_tf32() if dn == "fp32" else contextlib.nullcontext(), record_calls(rec):
                r = _one_step(exp, base_sd, dt, ctx or contextlib.nullcontext, x, draws,
                              wrap=wrap)
            e = _step_errs(r, refs["fp32"])
            out[f"{label}_{dn}"] = e
            if dn == "fp32" and (e["loss"] > 1e-5 or e["grad_norm"] > 1e-4
                                 or e["grads"] > 1e-4 or e["params"] > 1e-2):
                raise AssertionError(f"{name} {label} fp32 step against the unsharded plain "
                                     f"step: {e}")
            if dn == "bf16":
                for key in e:
                    if e[key] > 1.25 * base_b[key] + 1e-3:
                        raise AssertionError(f"{name} {label} bf16 step less accurate than "
                                             f"the unsharded plain path in {key}: {e}, "
                                             f"plain {base_b}")
            launches[label] = {k: r["counts"][k] for k in KERNELS}
            calls[label] = rec
            ran = {k: sum(1 for c in rec if c[0] == k) for k in FLASH_KERNELS}
            if any(launches[label][k] != ran[k] or not ran[k] for k in FLASH_KERNELS):
                raise AssertionError(f"{name} {label} {dn}: flash launches {launches[label]} "
                                     f"against the wrapper calls {ran}")
            torch.cuda.empty_cache()
        log(f"[model_parallel] {name} {label} one step at batch {x.shape[0]} on the kernels "
            f"against the unsharded plain step (fp32 at phase 6a's bars): "
            + "; ".join(f"{k}: " + ", ".join(f"{kk} {vv:.2e}" for kk, vv in v.items())
                        for k, v in out.items() if k.startswith(label + "_")))
    return out, launches, calls


def _check_head_calls(name, calls, R, n_attn, heads):
    """The flash calls of a TP'd parity run (the grads' pass and the step's,
    each a forward and a backward at TRAIN_BATCH): R of each kernel per
    attention and pass, every one at (B * heads / R, N, d)."""
    for k in FLASH_KERNELS:
        got = [c[1] for c in calls if c[0] == k]
        if len(got) != 2 * R * n_attn or any(s[0] != TRAIN_BATCH * heads // R for s in got):
            raise AssertionError(f"{name} R={R}: {k} called at {sorted(set(got))} "
                                 f"({len(got)} calls), expected {2 * R * n_attn} at "
                                 f"({TRAIN_BATCH * heads // R}, N, d)")


def _mp_step_ms(exp, base_sd, x, ctx=None, wrap=None):
    """Device ms of one bf16 train step on the batch ``x`` (dropout as the
    preset has it) under ``ctx`` / through ``wrap``."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step

    model = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(base_sd)
    model = model.to(memory_format=torch.channels_last)
    model = wrap(model) if wrap is not None else model
    state, tx = init_train_state(model, exp.train, seed=5)
    step = make_train_step(model, make_schedule(exp.diffusion, device="cuda"), tx, exp.train)
    box = [state]

    def run():
        with ctx() if ctx else contextlib.nullcontext():
            box[0], _m = step(box[0], x)

    ms, table = device_ms(run, iters=MP_TIMED, warmup=1)
    del model, state, step, box
    torch.cuda.empty_cache()
    return ms, ms_source(table)


def _bubble(S, M, model, x, t):
    """The pipeline's bubble from measured stage times: each block call of a
    bf16 forward through S virtual stages timed by CUDA events (launch gaps
    in), grouped into stage s's work on microbatch m at tick s + m; on S
    cards a tick lasts its slowest stage, so the idle share is 1 - (the
    stages' busy time) / (S x the sum of the ticks).  Returns it beside
    the schedule's (S - 1) / (M + S - 1)."""
    import torch

    from ddpm_diffusion_model_tpu_torch.parallel.pp import bubble_share

    per = DIT_DEPTH // S
    marks = []
    hooks = []
    for i, blk in enumerate(model.blocks):
        def pre(_m, _a, i=i):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append([i, ev, None])

        def post(_m, _a, _o):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[-1][2] = ev

        hooks += [blk.register_forward_pre_hook(pre), blk.register_forward_hook(post)]
    pp = _mp_pp(S, M)(model)
    with torch.inference_mode():
        pp(x, t)  # warm
        marks.clear()
        pp(x, t)
    torch.cuda.synchronize()
    for hk in hooks:
        hk.remove()
    dur, done = {}, {s: 0 for s in range(S)}
    i = 0
    while i < len(marks):
        s = marks[i][0] // per
        ms = sum(m[1].elapsed_time(m[2]) for m in marks[i:i + per])
        dur[(s, done[s])] = ms
        done[s] += 1
        i += per
    if any(v != M for v in done.values()):
        raise AssertionError(f"pipeline S={S} M={M}: stage-microbatch counts {done}")
    ticks = [max(dur.get((s, t_ - s), 0.0) for s in range(S)) for t_ in range(M + S - 1)]
    busy = sum(dur.values())
    return dict(measured=1.0 - busy / (S * sum(ticks)), schedule=bubble_share(S, M),
                stage_ms=busy / (S * M), source="CUDA events per stage, launch gaps in")


def _mp_grid(exp, base_sd):
    """(c) A DDIM-50 grid of 16 (fp32) through a 4-stage PipelinedDiT against
    the plain model's, on the kernels, from one x_T: max |diff| in [0, 1]
    pixels; its launches."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import ddim_from_init
    from ddpm_diffusion_model_tpu_torch.sampling.loops import to_unit_interval
    from ddpm_diffusion_model_tpu_torch.sampling.timesteps import build_ddim_schedule

    model = build_denoiser(exp.model, dtype=torch.float32, device="cuda")
    model.load_state_dict(base_sd)
    model.eval()
    sched = make_schedule(exp.diffusion, device="cuda")
    ts = build_ddim_schedule("t_linear", DDIM_STEPS, sched.T)
    gen = torch.Generator(device="cuda").manual_seed(71)
    x0 = torch.randn(MP_GRID_N, 64, 64, 3, generator=gen, device="cuda")
    grids = {}
    with torch.inference_mode(), no_tf32():
        for label, m in (("plain", model), ("pipelined", _mp_pp(4, 4)(model).eval())):
            reset_counts()
            grids[label] = to_unit_interval(ddim_from_init(m, sched, x0, ts)).float()
            torch.cuda.synchronize()
            grids[label + "_launches"] = {k: read_counts()[k] for k in KERNELS}
    diff = float((grids["pipelined"] - grids["plain"]).abs().max())
    if not torch.isfinite(grids["pipelined"]).all() or diff > MP_GRID_BAR:
        raise AssertionError(f"DDIM-50 through the pipeline: max |diff| {diff:.3e} against "
                             f"the plain grid, bar {MP_GRID_BAR}")
    want = dict(dict.fromkeys(KERNELS, 0), flash_attn_fwd=(DDIM_STEPS - 1) * DIT_DEPTH * 4)
    if grids["pipelined_launches"] != want:
        raise AssertionError(f"DDIM-50 through the pipeline: launches "
                             f"{grids['pipelined_launches']}, expected {want}")
    del model
    torch.cuda.empty_cache()
    return dict(max_abs_diff=diff, launches=grids["pipelined_launches"])


def _mp_world1(tmp, sds):
    """(d) A world-1 NCCL group: a placed step on a ('data', X) mesh of one
    rank each under the TP and EP contexts and through a distributed
    PipelinedDiT, bit-equal (loss and every param) to the step with no
    context, no placement and the plain model; the launches of each."""
    import torch
    import torch.distributed as dist

    from ddpm_diffusion_model_tpu_torch.models import build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.parallel import (PipelinedDiT, expert_parallel_mesh,
                                                         initialize_distributed, make_mesh,
                                                         place_state, tensor_parallel_mesh)
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step

    res = {}
    initialize_distributed("cuda", init_method=f"file://{tmp}/nccl_mp_store", rank=0,
                           world_size=1)
    try:
        x = torch.from_numpy(_par_images(TRAIN_BATCH)).cuda()
        for kind, exp, axis in (("tp", sds["tp"][0], "model"), ("ep", sds["ep"][0], "expert"),
                                ("pp", sds["pp"][0], "pp")):
            sd = sds[kind][1]
            mesh = make_mesh((1, 1), ("data", axis), device="cuda")
            got = {}
            for placed in (False, True):
                torch.manual_seed(0)
                model = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda")
                model.load_state_dict(sd)
                model = model.to(memory_format=torch.channels_last)
                ctx = contextlib.nullcontext()
                if placed and kind == "pp":
                    model = PipelinedDiT(model, mesh)
                elif placed:
                    ctx = (tensor_parallel_mesh if kind == "tp" else
                           expert_parallel_mesh)(mesh, axis)
                state, tx = init_train_state(model, exp.train, seed=5)
                if placed:
                    state = place_state(state, mesh)
                step = make_train_step(model, make_schedule(exp.diffusion, device="cuda"), tx,
                                       exp.train)
                reset_counts()
                with ctx:
                    state, m = step(state, x)
                torch.cuda.synchronize()
                got[placed] = (float(m["loss"]), _flat(model.parameters()),
                               {k: read_counts()[k] for k in KERNELS})
                del model, state, step
            if got[True][0] != got[False][0] or not torch.equal(got[True][1], got[False][1]) \
                    or got[True][2] != got[False][2]:
                raise AssertionError(f"world-1 NCCL {kind} step on ('data', {axis!r}): loss "
                                     f"{got[True][0]} vs {got[False][0]}, launches "
                                     f"{got[True][2]} vs {got[False][2]}, params equal "
                                     f"{torch.equal(got[True][1], got[False][1])}")
            res[kind] = {"bit_equal": True, "loss": got[True][0], "launches": got[True][2]}
            how = "through PipelinedDiT" if kind == "pp" else f"under the {kind} context"
            log(f"[model_parallel] (d) world-1 NCCL ('data', {axis!r}) = (1, 1), "
                f"{exp.run_name} placed step {how}: loss and every param bit-equal to the "
                f"plain step, launches {got[True][2]}")
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return res


def _mp_serve_start(tmp):
    """(e) A celeba64_attn checkpoint directory, and ``python -m ...serving``
    on it under ``torchrun --nproc_per_node 1``, started now so its start
    overlaps the phase's correctness work; returns what
    :func:`_mp_serve_check` takes."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import (build_model, init_train_state,
                                                         save_checkpoint)
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    preset = get_preset("celeba64_attn")
    model, _sched = build_model(preset, "cuda")
    ck = os.path.join(tmp, "mp_ck", "celeba64_attn_last")
    save_checkpoint(ck, init_train_state(model, preset.train)[0],
                    configs={"experiment": preset.to_dict()})
    del model
    torch.cuda.empty_cache()
    log_path = os.path.join(tmp, "mp_serve.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([*TORCHRUN, "-m", f"{PKG}.serving", "--ckpt", ck, "--port",
                                 "0"], cwd=str(REPO), stdout=logf, stderr=subprocess.STDOUT)
    return ck, proc, log_path


def _mp_serve_stop(proc):
    """SIGTERM to the service's process (it drains and exits 0), then the
    launcher's exit code; the launcher is killed if it outlives that."""
    try:
        with open(f"/proc/{proc.pid}/task/{proc.pid}/children") as f:
            ranks = [int(c) for c in f.read().split()]
        for pid in ranks:
            os.kill(pid, 15)
        return proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _mp_serve_check(ck, proc, log_path):
    """(e) The service under torchrun: /sample equal to the in-process
    service from the same seed, /metrics' mesh null (one rank), SIGTERM to
    the service drains it and the launcher exits 0."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.serving import SamplerService

    svc = SamplerService.from_checkpoint(ck, device="cuda")
    want, _used = svc.sample(n=MP_SERVE_N, steps=MP_SERVE_STEPS, seed=3)
    del svc
    torch.cuda.empty_cache()
    try:
        t0, line = time.perf_counter(), None
        while line is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the served torchrun process did not start:\n"
                                     + open(log_path).read()[-3000:])
            time.sleep(0.5)
            line = next((ln for ln in open(log_path).read().splitlines()
                         if "[SERVE] sampling service on http://" in ln), None)
        base = line.split("on ")[1].split()[0]
        x = np.load(io.BytesIO(_get(f"{base}/sample?n={MP_SERVE_N}&steps={MP_SERVE_STEPS}"
                                    f"&seed=3&format=npy")[2]))
        diff = float(np.abs(x - want).max())
        m = json.loads(_get(f"{base}/metrics")[2])
    finally:
        rc = _mp_serve_stop(proc)
    out = open(log_path).read()
    if rc != 0 or "[SERVE] draining" not in out or "[SERVE] stopped" not in out:
        raise AssertionError(f"torchrun serving: exit {rc} after SIGTERM:\n{out[-3000:]}")
    if diff > MP_SERVE_BAR or m["mesh"] is not None or m["devices"] != 1 \
            or m["sharded_batches"] != 0:
        raise AssertionError(f"torchrun serving: /sample max |diff| {diff:.3e} against the "
                             f"in-process service, /metrics mesh {m['mesh']}, devices "
                             f"{m['devices']}, sharded {m['sharded_batches']}")
    launches = {"gn_silu_fwd": m["kernel_launches"]["gn_silu_fwd"],
                "flash_attn_fwd": m["kernel_launches"]["flash_attn_fwd"]}
    log(f"[model_parallel] (e) torchrun --nproc_per_node 1 -m {PKG}.serving: /sample n="
        f"{MP_SERVE_N} steps={MP_SERVE_STEPS} max |diff| {diff:.2e} against the in-process "
        f"service, /metrics mesh {m['mesh']}, devices {m['devices']}, launches {launches}; "
        f"SIGTERM drained, exit 0")
    return dict(max_abs_diff=diff, mesh=m["mesh"], devices=m["devices"], launches=launches)


def phase_model_parallel(base_sd, tmp):
    """Tensor, expert and pipeline parallelism at full width, virtual forms
    in this process (every rank's rank-local code in turn), a world-1 NCCL
    group and the mesh-aware service under torchrun (started first, so its
    start overlaps the rest; stopped whatever happens)."""
    serve = _mp_serve_start(tmp)
    try:
        return _mp_body(base_sd, tmp, serve)
    finally:
        if serve[1].poll() is None:
            _mp_serve_stop(serve[1])


def _mp_body(base_sd, tmp, serve):
    import torch

    from ddpm_diffusion_model_tpu_torch.models import AttnBlock, build_denoiser
    from ddpm_diffusion_model_tpu_torch.ops.diffusion import sample_timesteps
    from ddpm_diffusion_model_tpu_torch.training import StepDraws
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    res = {"launches": {}}
    worst = dict.fromkeys(KERNELS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(70)
    images = torch.from_numpy(_par_images(TRAIN_BATCH)).cuda()
    x16 = torch.randn(BATCH, 64, 64, 3, generator=gen, device="cuda")
    t16 = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    x128 = torch.randn(TRAIN_BATCH, 64, 64, 3, generator=gen, device="cuda")
    t128 = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device="cuda")
    attn = get_preset("celeba64_attn")
    draws = StepDraws(sample_timesteps(TRAIN_BATCH, attn.diffusion.T, gen, "cuda"),
                      torch.randn(images.shape, generator=gen, device="cuda"))
    sub_calls, step_ms = [], {}
    part = PartClock("model_parallel")

    def models(exp, sd):
        m = build_denoiser(exp.model, dtype=torch.bfloat16, device="cuda")
        m.load_state_dict(sd)
        m32 = build_denoiser(exp.model, dtype=torch.float32, device="cuda")
        m32.load_state_dict(sd)
        return (m.to(memory_format=torch.channels_last).eval(),
                m32.to(memory_format=torch.channels_last).eval())

    # (a) TP on celeba64_attn: the forward at 16, one step at 128
    model, model32 = models(attn, base_sd)
    n_attn = sum(isinstance(m, AttnBlock) for m in model.modules())
    plain = _mp_plain(model, model32, x16, t16)
    res["tp_attn_forward"] = _mp_forwards("celeba64_attn", model, model32, x16, t16,
                                          {f"TP R={R}": (_mp_ctx("tp", R), None)
                                           for R in MP_TP_ATTN}, plain)
    del model, model32, plain
    torch.cuda.empty_cache()
    forms = {f"TP R={R}": (_mp_ctx("tp", R), None) for R in MP_TP_ATTN}
    res["tp_attn_step"], launches, calls = _mp_steps("celeba64_attn", attn, base_sd, images,
                                                     draws, forms, [f"TP R={MP_TP_ATTN[-1]}"])
    for R in MP_TP_ATTN:
        _check_head_calls("celeba64_attn", calls[f"TP R={R}"], R, n_attn, HEADS)
        res["launches"][f"tp_attn_R{R}_parity"] = launches[f"TP R={R}"]
        sub_calls += calls[f"TP R={R}"]

    # (a) TP on celeba64_dit_s4: one step at 128 at R = 2, 3, 6
    dit = dit_experiment("celeba64_dit_s4")
    dit_sd = {k: v.detach().clone() for k, v in build_dit(dit, seed=72).state_dict().items()}
    forms = {f"TP R={R}": (_mp_ctx("tp", R), None) for R in MP_TP_DIT}
    res["tp_dit_step"], launches, calls = _mp_steps("celeba64_dit_s4", dit, dit_sd, images,
                                                    draws, forms, ["TP R=3"])
    for R in MP_TP_DIT:
        _check_head_calls("celeba64_dit_s4", calls[f"TP R={R}"], R, DIT_DEPTH, DIT_HEADS)
        res["launches"][f"tp_dit_R{R}_parity"] = launches[f"TP R={R}"]
        sub_calls += calls[f"TP R={R}"]
    # every flash call at the head-sharded shapes against its plain version
    flash = [c for c in sub_calls if c[0] in FLASH_KERNELS]
    w = hold_calls(flash, gen, label="[model_parallel] ")
    worst = {k: max(worst[k], w[k]) for k in KERNELS}

    part("tp")

    # (b) EP on celeba64_dit_moe: the forward at 16 and one step at 128
    moe = dit_experiment("celeba64_dit_moe")
    moe_sd = {k: v.detach().clone() for k, v in build_dit(moe, seed=73).state_dict().items()}
    model, model32 = models(moe, moe_sd)
    plain = _mp_plain(model, model32, x16, t16, moe=True)
    res["ep_forward"] = _mp_forwards("celeba64_dit_moe", model, model32, x16, t16,
                                     {f"EP R={R}": (_mp_ctx("ep", R), None) for R in MP_EP},
                                     plain, routing=True)
    del model, model32, plain
    torch.cuda.empty_cache()
    forms = {f"EP R={R}": (_mp_ctx("ep", R), None) for R in MP_EP}
    res["ep_step"], launches, _calls = _mp_steps("celeba64_dit_moe", moe, moe_sd, images,
                                                 draws, forms, [f"EP R={MP_EP[-1]}"])
    res["launches"][f"ep_R{MP_EP[-1]}_parity"] = launches[f"EP R={MP_EP[-1]}"]

    part("ep")

    # (c) PP on celeba64_dit_s4 at 128 (126 at S = 3: M = 3 and 6 divide it):
    # forward and one step, M = S and 2S
    model, model32 = models(dit, dit_sd)
    res["pp_forward"], res["bubble"] = {}, {}
    for n in sorted(set(MP_PP_BATCH.values())):
        plain = _mp_plain(model, model32, x128[:n], t128[:n])
        res["pp_forward"].update(_mp_forwards(
            "celeba64_dit_s4", model, model32, x128[:n], t128[:n],
            {f"PP S={S} M={M}": (None, _mp_pp(S, M)) for S, M in MP_PP
             if MP_PP_BATCH[S] == n}, plain))
    for S, M in MP_PP:
        n = MP_PP_BATCH[S]
        b = _bubble(S, M, model, x128[:n], t128[:n])
        res["bubble"][f"S{S}M{M}"] = b
        log(f"[model_parallel] (c) bubble S={S} M={M}: measured {100 * b['measured']:.1f}% "
            f"(stage ms per microbatch {b['stage_ms']:.3f}, {b['source']}) against the "
            f"schedule's (S-1)/(M+S-1) = {100 * b['schedule']:.1f}%")
    del model, model32, plain
    torch.cuda.empty_cache()
    from ddpm_diffusion_model_tpu_torch.training.step import _micro

    res["pp_step"] = {}
    for n in sorted(set(MP_PP_BATCH.values())):
        forms = {f"PP S={S} M={M}": (None, _mp_pp(S, M)) for S, M in MP_PP_STEPS
                 if MP_PP_BATCH[S] == n}
        errs, launches, _calls = _mp_steps(  # the plain steps at 128 are the TP part's
            "celeba64_dit_s4" + ("" if n == TRAIN_BATCH else f" at {n}"), dit, dit_sd,
            images[:n], _micro(draws, slice(0, n)),
            forms, ["PP S=4 M=4"])
        res["pp_step"][f"batch {n}"] = errs
        if "PP S=4 M=4" in launches:
            res["launches"]["pp_S4M4_parity"] = launches["PP S=4 M=4"]
    res["pp_grid"] = _mp_grid(dit, dit_sd)
    res["launches"]["pp_grid_ddim50"] = res["pp_grid"]["launches"]
    log(f"[model_parallel] (c) DDIM-50 grid of {MP_GRID_N} (fp32) through a 4-stage "
        f"PipelinedDiT: max |diff| {res['pp_grid']['max_abs_diff']:.2e} in [0, 1] pixels "
        f"against the plain grid, launches {res['pp_grid']['launches']}")

    part("pp")

    # device ms of a parallel step against the unsharded one (bf16, batch 128)
    for key, exp, sd, ctx, wrap in (
            ("celeba64_attn", attn, base_sd, None, None),
            ("celeba64_attn TP R=4", attn, base_sd, _mp_ctx("tp", 4), None),
            ("celeba64_dit_moe", moe, moe_sd, None, None),
            ("celeba64_dit_moe EP R=8", moe, moe_sd, _mp_ctx("ep", 8), None),
            ("celeba64_dit_s4", dit, dit_sd, None, None),
            ("celeba64_dit_s4 PP S=4 M=8", dit, dit_sd, None, _mp_pp(4, 8))):
        ms, src = _mp_step_ms(exp, sd, images, ctx, wrap)
        step_ms[key] = {"device_ms": ms, "device_ms_source": src}
    res["step_device_ms"] = step_ms
    log("[model_parallel] device ms of one bf16 step at batch 128 (virtual forms run every "
        "rank's part on this card): " + "; ".join(
            f"{k} {v['device_ms']:.3f} ({v['device_ms_source']})" for k, v in step_ms.items()))

    # the flash kernels at the head-sharded shapes of N = 256 (R = 2 and 4 of
    # celeba64_attn's 4 heads; R = 3 and 6 of the DiT's 6 give the same):
    # time, bound and SDPA over the same rows (one head each); the plain
    # versions' times are the 64-px rows' (not timed again here)
    res["head_sharded"] = {}
    for k in FLASH_KERNELS:
        for R in MP_TP_ATTN:
            shape = (TRAIN_BATCH * HEADS // R, 256, 64)
            _name, r = _call_row((k, shape), gen, heads=1, iters=MP_ITERS, with_plain=False)
            res["head_sharded"].setdefault(k, {})[str(shape)] = r
            log(f"[model_parallel] {k} {shape} bf16: kernel {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ({'operations' if r['flops_ms'] > r['bytes_ms'] else 'bytes'}"
                f"), SDPA {r['library_ms']:.4f}, sources {r['ms_source']}")
    part("times")

    # (d) world-1 NCCL and (e) the service under torchrun
    with cudnn_deterministic():
        res["world1"] = _mp_world1(tmp, {"tp": (attn, base_sd), "ep": (moe, moe_sd),
                                         "pp": (dit, dit_sd)})
    for kind, r in res["world1"].items():
        res["launches"][f"world1_{kind}_step"] = r["launches"]
    part("world1")
    res["serving"] = _mp_serve_check(*serve)
    part("serving")
    res["part_seconds"] = part.done()
    res["launches"]["torchrun_serving"] = dict(dict.fromkeys(KERNELS, 0),
                                               **res["serving"]["launches"])
    res["launches"] = {k: {p: v[k] for p, v in res["launches"].items()} for k in KERNELS}
    return res, worst


# ------------------------------------------------------------- utils


UTILS_STEP = 1234  # the saved directory's step and schedule clock
UTILS_EMA_GN_SCALE = 1.5  # its EMA: the params with every GroupNorm scale x 1.5
UTILS_N = 16  # /sample's grid and the traced forward's batch
UTILS_DDIM_STEPS = 50  # 49 forwards: 2,205 GN+SiLU and 245 flash forwards
UTILS_SERVE_BAR = 1e-5  # /sample against ddim_infer_sample, [0, 1] pixels
UTILS_NAN_BATCH = 8  # the anomaly-mode step
UTILS_TRACES = 4  # profiler traces taken at most while CUPTI drops events
UTILS_WRONG_PRESET = "celeba64_low"  # the experiment the served .pt's extra names
#: the port's kernel Functions, as anomaly mode names their backward nodes
KERNEL_FUNCTIONS = ("_GNSiLUBackward", "_FlashAttentionBackward")


def _utils_model(preset, base_sd):
    """A fresh ``celeba64_attn`` (bf16, channels-last) holding ``base_sd``:
    earlier phases train the main model in place."""
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser

    model = UNetDenoiser(preset.model, device="cuda")
    model.load_state_dict(base_sd, strict=True)
    return model.to(memory_format=torch.channels_last)


def _utils_cli(argv):
    """The port's CLI in-process; its printed JSON line."""
    from ddpm_diffusion_model_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _same_payload(a_path, b_path):
    """Two reference-format files: the same tensors bit for bit in the same
    key and shadow order, the same step and decay."""
    import torch

    a = torch.load(a_path, weights_only=True)
    b = torch.load(b_path, weights_only=True)
    if list(a["model"]) != list(b["model"]) or len(a["ema"]["shadow"]) != len(a["model"]):
        raise AssertionError("the two exports differ in their keys or shadow length")
    for k, x, y, sx, sy in zip(a["model"], a["model"].values(), b["model"].values(),
                               a["ema"]["shadow"], b["ema"]["shadow"]):
        if not (torch.equal(x, y) and torch.equal(sx, sy)):
            raise AssertionError(f"the two exports differ at {k}")
    if a["step"] != b["step"] or a["ema"]["decay"] != b["ema"]["decay"]:
        raise AssertionError(f"step {a['step']} / {b['step']}, decay {a['ema']['decay']} / "
                             f"{b['ema']['decay']}")
    return len(a["model"])


def _utils_round_trip(preset, base_sd, tmp):
    """(a) a port directory (distinct EMA, step and schedule clock 1234)
    through ``cli export-torch`` and ``cli import-torch``: ``load_run`` of
    the import bit-equal to what was saved, a second export equal to the
    first.  Returns the directory's and the export's paths and the EMA
    weights."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import (init_train_state, load_run,
                                                         save_checkpoint)

    model = _utils_model(preset, base_sd)
    state, _tx = init_train_state(model, preset.train)
    state.ema_params = {k: v * UTILS_EMA_GN_SCALE if "norm" in k and k.endswith("weight")
                        else v.clone() for k, v in state.ema_params.items()}
    state.step = UTILS_STEP
    state.opt_state["schedule_count"] = UTILS_STEP
    saved = os.path.join(tmp, "utils_run")
    save_checkpoint(saved, state, configs={"experiment": preset.to_dict()})
    a = os.path.join(tmp, "utils_a.pt")
    info_a = _utils_cli(["export-torch", "--ckpt", saved, "--out", a])
    imported = os.path.join(tmp, "utils_imported")
    info_i = _utils_cli(["import-torch", "--preset", "celeba64_attn", "--torch-ckpt", a,
                         "--out", imported, "--require-ema"])
    m2, _sched, st, meta = load_run(imported, preset, "cuda")
    for k, p in m2.named_parameters():
        if not (torch.equal(p, dict(model.named_parameters())[k])
                and torch.equal(st.ema_params[k], state.ema_params[k])):
            raise AssertionError(f"import-torch of the export: {k} differs")
    if (st.step, st.opt_state["schedule_count"], st.ema_decay) != \
            (UTILS_STEP, UTILS_STEP, state.ema_decay) or meta["global_step"] != UTILS_STEP:
        raise AssertionError(f"import-torch: step {st.step}, schedule clock "
                             f"{st.opt_state['schedule_count']}, decay {st.ema_decay}")
    b = os.path.join(tmp, "utils_b.pt")
    _utils_cli(["export-torch", "--ckpt", imported, "--out", b])
    n = _same_payload(a, b)
    if info_a["params"] != 31_312_131 or info_i["params"] != 31_312_131 or not info_i["ema"]:
        raise AssertionError(f"export {info_a}, import {info_i}")
    log(f"[utils] (a) export-torch -> import-torch -> load_run: {n} tensors of params and "
        f"EMA bit-equal, step and schedule clock {UTILS_STEP}, decay {st.ema_decay}; a second "
        f"export equal to the first tensor for tensor in key and shadow order")
    ema = {k: v.detach().float().cpu() for k, v in state.ema_params.items()}
    del model, m2, state, st
    torch.cuda.empty_cache()
    return saved, a, ema, dict(export=info_a, import_=info_i)


def _utils_serve_start(preset, a, tmp):
    """The export with a wrong experiment (``UTILS_WRONG_PRESET``) in its
    extra, an ``ExperimentConfig`` JSON of ``celeba64_attn``, and ``python
    -m ...serving --ckpt x.pt --config exp.json --port 0`` on them."""
    import torch

    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset

    payload = torch.load(a, weights_only=True)
    payload["extra"]["experiment"] = get_preset(UTILS_WRONG_PRESET).to_dict()
    x_pt = os.path.join(tmp, "utils_wrong.pt")
    torch.save(payload, x_pt)
    exp_json = os.path.join(tmp, "utils_exp.json")
    with open(exp_json, "w") as f:
        f.write(preset.to_json())
    log_path = os.path.join(tmp, "utils_serve.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-m", f"{PKG}.serving", "--ckpt", x_pt,
                                 "--config", exp_json, "--port", "0"], cwd=str(REPO),
                                stdout=logf, stderr=subprocess.STDOUT)
    return proc, log_path


def _utils_serve_check(preset, ema, proc, log_path, tmp):
    """(a) /sample n=16 DDIM-50 through ``--config`` against
    ``ddim_infer_sample`` of the EMA weights from the same seed; /metrics'
    launches; SIGTERM drains.  Returns the result and the served images."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.models import UNetDenoiser
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.sampling import ddim_infer_sample
    from ddpm_diffusion_model_tpu_torch.utils.images import grid_nrow, make_grid

    # built as the service builds a .pt's model (no channels-last copy)
    model = UNetDenoiser(preset.model, device="cuda")
    model.load_state_dict(ema, strict=True)
    model.eval()
    ref = ddim_infer_sample(model, None, make_schedule(preset.diffusion, device="cuda"),
                            n=UTILS_N, img_size=64, out_path=os.path.join(tmp, "utils_ref.png"),
                            seed=5, steps=UTILS_DDIM_STEPS, device="cuda")
    del model
    torch.cuda.empty_cache()
    try:
        t0, line = time.perf_counter(), None
        while line is None:
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                raise AssertionError("the served process did not start:\n"
                                     + open(log_path).read()[-3000:])
            time.sleep(0.2)
            line = next((ln for ln in open(log_path).read().splitlines()
                         if "[SERVE] sampling service on http://" in ln), None)
        start_s = time.perf_counter() - t0
        base = line.split("on ")[1].split()[0]
        m0 = json.loads(_get(f"{base}/metrics")[2])["kernel_launches"]
        t0 = time.perf_counter()
        code, _h, body = _get(f"{base}/sample?n={UTILS_N}&steps={UTILS_DDIM_STEPS}&eta=0"
                              f"&seed=5&format=npy")
        sec = time.perf_counter() - t0
        x = np.load(io.BytesIO(body))
        m1 = json.loads(_get(f"{base}/metrics")[2])["kernel_launches"]
        health = json.loads(_get(f"{base}/healthz")[2])
    finally:
        proc.send_signal(15)
        try:
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = open(log_path).read()
    served = {k: m1[k] - m0[k] for k in ("gn_silu_fwd", "flash_attn_fwd")}
    forwards = UTILS_DDIM_STEPS - 1
    want = {"gn_silu_fwd": GN_LAUNCHES_PER_FORWARD * forwards,
            "flash_attn_fwd": FLASH_LAUNCHES_PER_FORWARD * forwards}
    diff = float(np.abs(make_grid(x, nrow=grid_nrow(UTILS_N)) - ref).max())
    if code != 200 or x.shape != (UTILS_N, 64, 64, 3) or diff > UTILS_SERVE_BAR \
            or served != want or health["img_size"] != 64:
        raise AssertionError(f"serving --config: /sample {code} {x.shape}, against "
                             f"ddim_infer_sample max |diff| {diff}, launches {served} "
                             f"(expected {want}), /healthz {health}")
    if rc != 0 or "[SERVE] stopped" not in out:
        raise AssertionError(f"serving --config: exit {rc} after SIGTERM:\n{out[-3000:]}")
    log(f"[utils] (a) python -m {PKG}.serving --ckpt x.pt --config exp.json (the .pt's "
        f"extra names {UTILS_WRONG_PRESET}): ready in {start_s:.1f} s; /sample n={UTILS_N} "
        f"steps={UTILS_DDIM_STEPS} eta=0 in {sec:.2f} s, against ddim_infer_sample from the "
        f"same seed max |diff| {diff:.3e} (bar {UTILS_SERVE_BAR:g}); /metrics launches "
        f"{served} (expected {want}, /metrics since start {m1}); SIGTERM drained, exit 0")
    return dict(launches=dict(dict.fromkeys(KERNELS, 0), **served), max_diff=diff,
                seconds=sec, start_s=start_s), x


def _trace_kernel_events(path):
    """(GN+SiLU forward, flash forward) kernel events of a Chrome trace."""
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return (sum("gn_silu_fwd_kernel" in n for n in names),
            sum("flash_fwd" in n for n in names))


#: (b) in a fresh process: ``load_run`` of phase 20's directory, then
#: ``_utils_trace`` (argv: repo, result JSON, directory, trace directory)
TRACE_CHILD = """\
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from ddpm_diffusion_model_tpu_torch.training import load_run
from ddpm_diffusion_model_tpu_torch.utils.config import get_preset
model, _sched, _state, _meta = load_run(sys.argv[3], get_preset("celeba64_attn"), "cuda")
res = chip_smoke._utils_trace(model.eval(), sys.argv[4])
with open(sys.argv[2], "w") as f:
    json.dump(res, f)
"""


def _utils_trace_start(saved, tmp):
    """(b) :data:`TRACE_CHILD` on the directory ``saved``, started now.  A
    process of its own: in this one, after the earlier phases (about 14
    minutes on the card), the profiler's traces lost kernel events (4 of a
    forward's 45 GN events, in four traces running)."""
    out_path = os.path.join(tmp, "utils_trace.json")
    log_path = os.path.join(tmp, "utils_trace.log")
    with open(log_path, "w") as logf:
        proc = subprocess.Popen([sys.executable, "-c", TRACE_CHILD, str(REPO), out_path, saved,
                                 tmp], cwd=str(REPO), stdout=logf, stderr=subprocess.STDOUT)
    return proc, out_path, log_path


def _utils_trace_wait(proc, out_path, log_path):
    rc = proc.wait(timeout=600)
    out = open(log_path).read()
    if rc != 0:
        raise AssertionError(f"the traced forward's process exited {rc}:\n{out[-3000:]}")
    for ln in out.splitlines():
        if ln.startswith("[utils]"):
            log(ln + " (a fresh process)")
    with open(out_path) as f:
        return json.load(f)


def _utils_trace(model, tmp):
    """(b) ``profiler_trace`` of one bf16 forward at 16: exactly 45 GN+SiLU
    and 5 flash forward kernel events.  CUPTI now and then drops a trace's
    device events: up to ``UTILS_TRACES`` traces, none with more."""
    import torch

    from ddpm_diffusion_model_tpu_torch.training import profiler_trace

    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(UTILS_N, 64, 64, 3, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (UTILS_N,), generator=gen, device="cuda")
    want = (GN_LAUNCHES_PER_FORWARD, FLASH_LAUNCHES_PER_FORWARD)
    seen = []
    with torch.inference_mode():
        model(x, t)
        torch.cuda.synchronize()
        reset_counts()
        for i in range(UTILS_TRACES):
            logdir = os.path.join(tmp, f"utils_trace{i}")
            with profiler_trace(logdir):
                model(x, t)
            (name,) = os.listdir(logdir)
            seen.append(_trace_kernel_events(os.path.join(logdir, name)))
            if seen[-1][0] > want[0] or seen[-1][1] > want[1]:
                raise AssertionError(f"profiler_trace: kernel events {seen[-1]} above {want}")
            if seen[-1] == want:
                break
        counts = read_counts()
    if seen[-1] != want:
        raise AssertionError(f"profiler_trace: kernel events {seen} in {len(seen)} traces, "
                             f"expected {want}")
    launches = {k: counts[k] for k in KERNELS}
    if launches != dict(dict.fromkeys(KERNELS, 0), gn_silu_fwd=want[0] * len(seen),
                        flash_attn_fwd=want[1] * len(seen)):
        raise AssertionError(f"profiler_trace: launches {launches} over {len(seen)} forwards")
    log(f"[utils] (b) profiler_trace of a bf16 forward at {UTILS_N}: {want[0]} GN+SiLU and "
        f"{want[1]} flash forward kernel events in the trace ({len(seen)} trace(s): {seen})")
    return dict(traces=len(seen), events=seen, launches=launches)


def _utils_nan(preset, base_sd):
    """(c) One bf16 train step at batch 8 under ``nan_debugging``: finite
    params and grads, 45 / 45 / 5 / 5 / 5 launches; then, with a NaN put
    into the head's GroupNorm scale after the forward, the backward raises
    naming a kernel's ``autograd.Function``; the anomaly mode before is
    back after."""
    import numpy as np
    import torch

    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array
    from ddpm_diffusion_model_tpu_torch.ops import make_schedule
    from ddpm_diffusion_model_tpu_torch.training import init_train_state, make_train_step
    from ddpm_diffusion_model_tpu_torch.utils.debugging import (assert_tree_finite,
                                                                nan_debugging,
                                                                tree_all_finite)

    model = _utils_model(preset, base_sd).train()
    state, tx = init_train_state(model, preset.train, seed=7)
    step = make_train_step(model, make_schedule(preset.diffusion, device="cuda"), tx,
                           preset.train)
    x = torch.from_numpy(np.ascontiguousarray(blob_faces_array(UTILS_NAN_BATCH, img_size=64,
                                                               seed=11))).float().cuda()
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    t0 = time.perf_counter()
    with nan_debugging():
        reset_counts()
        state, m = step(state, x)
        torch.cuda.synchronize()
        counts = read_counts()
        params = dict(model.named_parameters())
        grads = {k: p.grad for k, p in params.items()}
        assert_tree_finite(params, "params")
        assert_tree_finite(grads, "grads")
        finite = bool(tree_all_finite({"params": params, "grads": grads}))
        step_s = time.perf_counter() - t0

        def poison(*_):
            model.out_norm.weight.data[0] = float("nan")

        hook = model.register_forward_hook(poison)
        try:
            step(state, x)
            raise AssertionError("nan_debugging: the step with a NaN GroupNorm scale "
                                 "finished")
        except RuntimeError as e:
            err = str(e).splitlines()[0]
        finally:
            hook.remove()
    after = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    launches = {k: counts[k] for k in KERNELS}
    want = {k: LAUNCHES_PER_STEP[k] for k in KERNELS}
    if launches != want or not finite or not np.isfinite(float(m["loss"])):
        raise AssertionError(f"nan_debugging step: launches {launches} (expected {want}), "
                             f"finite {finite}, loss {float(m['loss'])}")
    if not any(f"Function '{f}' returned nan" in err for f in KERNEL_FUNCTIONS) \
            or after != prev:
        raise AssertionError(f"nan_debugging: the NaN case raised {err!r}; anomaly mode "
                             f"{after} after, {prev} before")
    log(f"[utils] (c) a bf16 step at batch {UTILS_NAN_BATCH} under nan_debugging in "
        f"{step_s:.2f} s: loss {float(m['loss']):.4f}, params and grads finite, launches "
        f"{launches}; a NaN in out_norm's scale after the forward: {err!r}; anomaly mode "
        f"{after} after, as before")
    del model, state
    torch.cuda.empty_cache()
    return dict(launches=launches, loss=float(m["loss"]), error=err, seconds=step_s)


def _utils_mfu(train, dit):
    """(d) MFU of the bf16 steps at batch 128 timed by phases 6c and 16
    (no new run): ``train_step_flops`` over their device and wall ms, each
    in (0, 1); None for a phase that did not run."""
    from ddpm_diffusion_model_tpu_torch.utils.config import get_preset
    from ddpm_diffusion_model_tpu_torch.utils.flops import PEAK_TFLOPS, mfu, train_step_flops

    res = {}
    for name, r in (("celeba64_attn", train),
                    ("celeba64_dit_s4", dit and dit["presets"]["celeba64_dit_s4"]["epoch"])):
        if r is None:
            log(f"[utils] (d) MFU of {name}: not measured (its step phase did not run)")
            res[name] = None
            continue
        f = train_step_flops(get_preset(name).model, TRAIN_BATCH)
        dev, wall = r["step_device_ms"], r["step_wall_ms"]
        res[name] = dict(flops=f, device_ms=dev, device_ms_source=r["device_ms_source"],
                         wall_ms=wall, mfu_device=mfu(f, dev / 1e3),
                         mfu_wall=mfu(f, wall / 1e3), peak_tflops=PEAK_TFLOPS["h100"])
        if not (0 < res[name]["mfu_wall"] < 1 and 0 < res[name]["mfu_device"] < 1):
            raise AssertionError(f"MFU of {name}: {res[name]}")
        log(f"[utils] (d) MFU of a {name} bf16 step at {TRAIN_BATCH}: {f / 1e12:.3f} TFLOP in "
            f"{dev:.3f} ms device ({r['device_ms_source']}) = "
            f"{100 * res[name]['mfu_device']:.1f}%, in {wall:.3f} ms wall = "
            f"{100 * res[name]['mfu_wall']:.1f}% of {PEAK_TFLOPS['h100']:g} TFLOP/s")
    return res


def phase_utils(preset, base_sd, tmp, train=None, dit=None):
    """(a) ``cli export-torch`` and ``import-torch`` at full width, and the
    service's ``--config`` over a ``.pt`` whose extra names another model;
    (b) ``profiler_trace``; (c) ``nan_debugging`` over the kernels; (d) the
    MFU of the steps phases 6c and 16 timed; (e) ``sample_statistics`` of
    the served grid and ``model_summary``'s total."""
    from ddpm_diffusion_model_tpu_torch.utils.sample_metrics import sample_statistics
    from ddpm_diffusion_model_tpu_torch.utils.summary import model_summary, param_table

    part = PartClock("utils")
    res = {}
    saved, a, ema, res["cli"] = _utils_round_trip(preset, base_sd, tmp)
    # the service and the traced forward start in processes of their own
    # while (c) runs here
    proc, log_path = _utils_serve_start(preset, a, tmp)
    trace = _utils_trace_start(saved, tmp)
    try:
        part("round_trip")
        res["nan_debugging"] = _utils_nan(preset, base_sd)
        part("nan_debugging")
        res["trace"] = _utils_trace_wait(*trace)
        part("trace")
        res["serving"], x = _utils_serve_check(preset, ema, proc, log_path, tmp)
        part("serving")
    finally:  # the checks stop both processes; a failure before them must too
        for p in (proc, trace[0]):
            if p.poll() is None:
                p.kill()
                p.wait()
    model = _utils_model(preset, base_sd)
    rows = param_table(model)
    total = model_summary(model).splitlines()[-1]
    del model
    res["mfu"] = _utils_mfu(train, dit)
    stats = sample_statistics(x)
    if not stats["finite"] or stats["diversity"] <= 0 or not total.endswith("31,312,131") \
            or sum(r[2] for r in rows) != 31_312_131:
        raise AssertionError(f"sample_statistics {stats}; summary {total!r}")
    res["sample_statistics"], res["summary_rows"] = stats, len(rows)
    log(f"[utils] (e) sample_statistics of the served grid {stats}; model_summary: "
        f"{len(rows)} rows, total 31,312,131")
    part("rest")
    res["part_seconds"] = part.done()
    res["launches"] = {k: {"serve_ddim50": res["serving"]["launches"][k],
                           "trace_forward": res["trace"]["launches"][k],
                           "nan_debugging_step": res["nan_debugging"]["launches"][k]}
                       for k in KERNELS}
    return res


REPLACES = {
    "gn_silu_fwd": ("ddpm_diffusion_model_tpu/ops/fused_norm.py:115 _moments_kernel "
                    "+ :127 _apply_kernel"),
    "gn_silu_bwd": ("ddpm_diffusion_model_tpu/ops/fused_norm.py:215 _bwd_partial_kernel "
                    "+ :244 _bwd_apply_kernel + :255 _bwd_apply_kernel_nodtb"),
    "flash_attn_fwd": "ddpm_diffusion_model_tpu/ops/flash_attention.py:47 _fwd_kernel",
    "flash_attn_bwd_dq": "ddpm_diffusion_model_tpu/ops/flash_attention.py:132 _dq_kernel",
    "flash_attn_bwd_dkv": "ddpm_diffusion_model_tpu/ops/flash_attention.py:169 _dkv_kernel",
}
SOURCE = {"gn_silu_fwd": "gn_silu.cu", "gn_silu_bwd": "gn_silu.cu",
          "flash_attn_fwd": "flash_attn.cu", "flash_attn_bwd_dq": "flash_attn_bwd.cu",
          "flash_attn_bwd_dkv": "flash_attn_bwd.cu"}


PHASES = ("kernels", "unet", "serving", "train", "update", "run", "sample", "solvers", "remat",
          "hq256", "data", "cfg", "sr", "distill", "dit", "latent", "parallel", "model_parallel",
          "utils", "times")


def main(argv=None) -> int:
    """Every phase, as the chip check runs it (no arguments).  ``--only
    a,b`` runs the build and only the named phases (to try a change on
    the card): it prints no result line."""
    argv = sys.argv[1:] if argv is None else argv
    only = set(PHASES)
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = set(argv[1].split(","))
        if not only <= set(PHASES):
            print(f"chip_smoke: phases are {', '.join(PHASES)}", file=sys.stderr)
            return 2
    elif argv:
        print("usage: chip_smoke.py [--only phase,...]", file=sys.stderr)
        return 2
    if not (REPO / PKG / "__init__.py").is_file():
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    from ddpm_diffusion_model_tpu_torch.data import blob_faces_array
    from ddpm_diffusion_model_tpu_torch.utils.flops import PEAK_TFLOPS

    PEAK_FLOPS["bfloat16"] = PEAK_TFLOPS["h100"] * 1e12

    name, smi = phase_device()
    queued_probe = check_queued_timing()
    phase_build()
    preset, model = build_model()
    base_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gn_calls, fl_calls = main_path_shapes(model)
    train_calls = train_path_shapes(model)
    if "kernels" in only:
        worst = phase_kernels(gn_calls, fl_calls, train_calls)
    if "unet" in only:
        phase_unet(model)
    torch.backends.cudnn.allow_tf32 = True  # the library default, from here on
    if "serving" in only:
        serving = phase_serving(preset, model)
    t0 = time.perf_counter()
    images = blob_faces_array(4 * TRAIN_BATCH, img_size=64, seed=0)
    log(f"[train] {len(images)} synthetic blob faces in {time.perf_counter() - t0:.1f} s")
    if "train" in only:
        parity = phase_train_parity(preset, base_sd, images)
        train = phase_train_epoch(preset, model, images)
    phase_s = {}
    if "update" in only:
        t0 = time.perf_counter()
        update = phase_update()
        phase_s["update"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
        if only & {"run", "sample", "solvers"}:
            t0 = time.perf_counter()
            run, ckpt_dir = phase_run(preset, base_sd, images, tmp)
            phase_s["run"] = time.perf_counter() - t0
        if "sample" in only:
            t0 = time.perf_counter()
            sample = phase_sample(preset, ckpt_dir, tmp)
            phase_s["sample"] = time.perf_counter() - t0
        if "solvers" in only:
            t0 = time.perf_counter()
            solvers, solvers_worst = phase_solvers(preset, ckpt_dir, tmp)
            phase_s["solvers"] = time.perf_counter() - t0
    if "remat" in only:
        t0 = time.perf_counter()
        remat = phase_remat(preset, base_sd, images)
        phase_s["remat"] = time.perf_counter() - t0
    if "hq256" in only:
        t0 = time.perf_counter()
        hq, hq_tot = phase_hq256()
        phase_s["hq256"] = time.perf_counter() - t0
    if "data" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            data = phase_data(preset, base_sd, images, tmp,
                              train["images_per_s"] if "train" in only else None)
        phase_s["data"] = time.perf_counter() - t0
    if "cfg" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            cfg, cfg_worst = phase_cfg(preset, base_sd, images, tmp)
        phase_s["cfg"] = time.perf_counter() - t0
    if "sr" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            sr, sr_worst = phase_sr(preset, base_sd, tmp)
        phase_s["sr"] = time.perf_counter() - t0
    if "distill" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            distill, distill_worst, distill_tot = phase_distill(preset, base_sd, images, tmp)
        phase_s["distill"] = time.perf_counter() - t0
    if "dit" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            dit, dit_worst = phase_dit(images, tmp)
        phase_s["dit"] = time.perf_counter() - t0
    if "latent" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            latent, latent_worst = phase_latent(images, tmp)
        phase_s["latent"] = time.perf_counter() - t0
    if "parallel" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            parallel, parallel_worst = phase_parallel(tmp)
        phase_s["parallel"] = time.perf_counter() - t0
    if "model_parallel" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            mp, mp_worst = phase_model_parallel(base_sd, tmp)
        phase_s["model_parallel"] = time.perf_counter() - t0
    if "utils" in only:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=str(REPO / "build")) as tmp:
            utils = phase_utils(preset, base_sd, tmp, train if "train" in only else None,
                                dit if "dit" in only else None)
        phase_s["utils"] = time.perf_counter() - t0
    log(f"[phases] seconds of the slice's phases: "
        + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))
    if only != set(PHASES):
        log(f"[dev] ran only {sorted(only)}: no result line")
        return 0
    tot, fwd = phase_times(model, gn_calls, fl_calls)
    ttot = kernel_totals(train_calls, f"train step (batch {TRAIN_BATCH})")
    routes = gn_bwd_routes()
    fwd_routes = gn_fwd_routes()

    kernels = []
    for k in KERNELS:
        r = ttot[k]
        row = {
            "name": k, "route": "cuda", "source": f"{PKG}/csrc/{SOURCE[k]}",
            "replaces": REPLACES[k], "launches": train["launches"][k],
            "max_abs_err": max(worst[k], hq["worst"][k], solvers_worst[k], cfg_worst[k],
                               sr_worst[k], distill_worst[k], dit_worst[k],
                               latent_worst[k], parallel_worst[k], mp_worst[k]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["flops_ms"] else "operations",
            "library_ms": r["library_ms"], "ms_source": r["ms_source"],
            "per": f"train step, batch {TRAIN_BATCH}, bf16 ({TRAIN_STEPS} steps launched)",
            "launches_by_path": {"train": train["launches"][k], "run": run["launches"][k],
                                 "sample": sample["launches"][k],
                                 "remat_true": remat["True"]["launches"][k],
                                 "hq256": hq["launches"][k],
                                 "data_cli_train": data["cli_train"]["host"]["launches"][k],
                                 "data_cli_train_cached":
                                     data["cli_train"]["device_cache"]["launches"][k],
                                 **{f"solvers_{p}": v
                                    for p, v in solvers["launches"][k].items()},
                                 **{f"cfg_{p}": v for p, v in cfg["launches"][k].items()},
                                 **{f"sr_{p}": v for p, v in sr["launches"][k].items()},
                                 **{f"distill_{p}": v
                                    for p, v in distill["launches"][k].items()},
                                 **{f"dit_{p}": v for p, v in dit["launches"][k].items()},
                                 **{f"latent_{p}": v
                                    for p, v in latent["launches"][k].items()},
                                 **{f"parallel_{p}": v
                                    for p, v in parallel["launches"][k].items()},
                                 **{f"model_parallel_{p}": v
                                    for p, v in mp["launches"][k].items()},
                                 **{f"utils_{p}": v for p, v in utils["launches"][k].items()}},
        }
        if k in tot:  # the forward kernels also serve
            s = tot[k]
            row["serving"] = {"launches": serving["launches"][k], "ms": s["ms"],
                              "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                              "library_ms": s["library_ms"], "ms_source": s["ms_source"],
                              "per": f"U-Net forward, batch {BATCH}, bf16"}
        h = hq_tot[k]
        row["hq256"] = {"launches": hq["launches"][k], "launches_per_step":
                        hq["launches_per_step"][k], "max_abs_err": hq["worst"][k],
                        "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                        "bound_by": "bytes" if h["bytes_ms"] >= h["flops_ms"] else "operations",
                        "library_ms": h["library_ms"], "ms_source": h["ms_source"],
                        "per": f"{HQ_PRESET} train step, batch 64 = 8 x 8, bf16, remat=True"}
        row["distill"] = {"launches_per_update": {
            kind: distill["runs"][kind]["launches_per_update"][k] for kind in DISTILL_KINDS},
            "max_abs_err": distill_worst[k]}
        if k in distill_tot:  # the forward kernels at the guided teacher's 256 rows
            d = distill_tot[k]
            row["distill"].update(
                ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
                bound_by="bytes" if d["bytes_ms"] >= d["flops_ms"] else "operations",
                library_ms=d["library_ms"], ms_source=d["ms_source"],
                per=f"guided teacher forward, {2 * TRAIN_BATCH} rows, bf16")
        row["dit"] = {"launches_per_step": DIT_LAUNCHES_PER_STEP[k], "max_abs_err": dit_worst[k]}
        for what, rows, per in (
                ("n256", dit["n256_step"], f"DiT-S/4 train step, batch {TRAIN_BATCH}, bf16"),
                ("n4096", dit["n4096"], f"one call at N = 4096, (48, 4096, 64), bf16")):
            if k in rows:
                d = rows[k]
                row["dit"][what] = dict(
                    ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
                    bound_by="bytes" if d["bytes_ms"] >= d["flops_ms"] else "operations",
                    library_ms=d["library_ms"], ms_source=d["ms_source"], per=per,
                    **({"fp32_fma_ms": d["fp32_fma_ms"]} if "fp32_fma_ms" in d else {}))
        row["latent"] = {"launches_per_step": {
            "vae": latent["vae_epoch"]["launches_per_step"][k],
            "unet": latent["unet_epoch"]["launches_per_step"][k]},
            "max_abs_err": latent_worst[k]}
        if k in latent["vae_step_kernels"]:  # the GN kernels at the VAE's shapes
            v = latent["vae_step_kernels"][k]
            row["latent"].update(
                ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                bound_by="bytes" if v["bytes_ms"] >= v["flops_ms"] else "operations",
                library_ms=v["library_ms"], ms_source=v["ms_source"],
                per=f"VAE train step, batch {VAE_BATCH}, bf16")
        if k in FLASH_KERNELS:  # each hop of the ring at N = 4096 / S
            ring = parallel["ring"]["bfloat16"]
            short = {"flash_attn_fwd": "fwd", "flash_attn_bwd_dq": "dq",
                     "flash_attn_bwd_dkv": "dkv"}[k]
            ring_key = "ring_fwd_ms" if short == "fwd" else "ring_bwd_ms"
            row["parallel"] = {
                "per": f"virtual ring over {RING_SHAPE}, bf16: one hop at N / S, the "
                       "whole ring pass, one call at N",
                "one_call_ms": ring["single"][f"{short}_ms"],
                "bound_ms": ring["bound_ms"][short], "max_abs_err": parallel_worst[k],
                "ms_source": {"one_call_ms": ring["single"]["ms_source"][f"{short}_ms"],
                              **{f"S{S}": {
                                  "hop_ms": ring[f"S{S}"]["ms_source"][f"hop_{short}_ms"],
                                  "ring_ms": ring[f"S{S}"]["ms_source"][ring_key]}
                                 for S in RING_SIZES}},
                **{f"S{S}": {"launches_fwd_plus_bwd": ring[f"S{S}"]["launches_fwd_plus_bwd"][k],
                             "hop_ms": ring[f"S{S}"][f"hop_{short}_ms"],
                             "ring_ms": ring[f"S{S}"][ring_key]}
                   for S in RING_SIZES}}
            row["model_parallel"] = {
                "per": "one call at a head-sharded shape (B * heads / R, 256, 64) of a "
                       "virtual TP step at batch 128, bf16; the library SDPA over the same "
                       "rows, one head each",
                "max_abs_err": mp_worst[k],
                **{shape: dict(ms=r["ms"], bound_ms=r["bound_ms"],
                               bound_by="bytes" if r["bytes_ms"] >= r["flops_ms"]
                               else "operations", library_ms=r["library_ms"],
                               ms_source={k_: v for k_, v in r["ms_source"].items() if v})
                   for shape, r in mp["head_sharded"][k].items()}}
        kernels.append(row)
    log(json.dumps({"kernels": kernels, "train_step_b128_bf16": train,
                    "train_parity": parity, "update": update, "unet_forward_b16_bf16": fwd,
                    "latency_s_n16_steps50": serving["latency_s_n16_steps50"],
                    "gn_bwd_routes_ms": routes, "gn_fwd_routes_ms": fwd_routes,
                    "run": run, "sample": sample, "remat": remat,
                    "hq256": {k: v for k, v in hq.items() if k != "worst"},
                    "data": data, "solvers": solvers, "cfg": cfg, "sr": sr,
                    "distill": {k: v for k, v in distill.items()
                                if k != "teacher_forward_kernels"},
                    "dit": {k: v for k, v in dit.items() if k not in ("n256_step", "n4096")},
                    "latent": {k: v for k, v in latent.items() if k != "vae_step_kernels"},
                    "parallel": parallel,
                    "model_parallel": {k: v for k, v in mp.items() if k != "head_sharded"},
                    "utils": utils,
                    "phase_seconds": phase_s,
                    "profiler_retraces": TRACE_RETRIES, "not_profiled": NOT_PROFILED,
                    "queued_events_probe": queued_probe,
                    "card": smi}))
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
