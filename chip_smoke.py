#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of
``diffusion_model_universal_torch/configs/ddpm_config.yaml`` (C=128, 32²,
T=1000, 4 heads, serve batch 16) with random weights made from a seed:

1. builds the hand-written CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints the build seconds;
2. records every GroupNorm and attention call shape of one full-width
   forward, and holds each kernel against its plain PyTorch version at
   each of those shapes, in bf16 and f32 (K1 also bit-identical over two
   calls, with its launch plan logged once per shape), and at edge shapes
   (``GN_EDGE_SHAPES``: the re-read path, rows that are not whole 16-byte
   vectors, a misaligned x, two samples a block);
   K3 also at S ∈ {1, 4, 16, 17, 64, 65, 256, 1024} × D ∈ {32, 64, 128}
   and odd shapes (``MHA_EDGE_SHAPES``); K3 and K4's sm90 route must
   refuse a launch plan off by one from the one Python gives them;
3. holds one f32 UNet forward (B=2) and a 3-step sampler run on the card
   against the same module on the CPU, where the plain versions run; then
   the config at ``image_size: 128`` (attention at S=256): one f32
   forward at B=1 card vs CPU, and 3 bf16 sampler steps at B=16 on the
   card;
4. serves three ``POST /generate`` requests and one ``GET /healthz``
   through the port's HTTP server (bf16, 1000 ancestral steps each),
   checks the outputs, and checks that each request advanced the kernels'
   launch counters by exactly T × launches per forward;
5. times each kernel at its main-path shapes beside its plain version,
   one PyTorch library call computing the same function, and its bound
   (K3 also at S=256 and 1024, D=64, B·N=64);
   traces a few sampler steps with ``torch.profiler``; and times sampler
   steps with the ops called through their autograd Functions and with
   the kernels called directly.

Then the training path (batch 128, bf16 autocast over f32 weights, remat
on, dropout 0.1, the config's SNR-weighted MSE, Adam and EMA):

6. records every GroupNorm and attention call of one training step and
   holds the GroupNorm backward (K2) against its plain version at each of
   its shapes in f32 and bf16, and at edge shapes; two calls must give
   bit-identical results (its plan logged once per shape); and holds K1
   and K3 at their training shapes;
7. holds one f32 training step (B=2, loss and every gradient) on the card
   against the CPU, and reports the same step's loss in bf16 autocast;
   checks that the GroupNorm backward (K2) refuses a second derivative on
   the card and that attention's grad-of-grad matches ``mha_plain``'s;
8. runs the training CLI at full width as a subprocess on the synthetic
   dataset (2 epochs, checkpoints, validation, a sample grid), resumes it
   from its latest checkpoint for a third epoch, and generates from the
   final checkpoint's EMA weights;
9. times training steps in-process (ms/step, images/s), checks that each
   step launched K1, K2 and K3 exactly as often as counted, traces a few
   steps with ``torch.profiler``, and times every kernel at the training
   shapes.

Then the experiment CLIs' kernels (``scripts/exp_conv_kernel.py`` and
``scripts/exp_boundary_kernel.py`` of the port):

10. holds the 3×3 conv K5 in both K orders at the six stride-1 shapes of
    ``bench.py`` (bf16 at B=2048, on its TMA + wgmma route; f32 at B=16,
    on the CUDA cores) and at batch-packed edge shapes (bf16 on the WMMA
    route), and K4 (fused affine+SiLU→conv; bf16 at 32² and on the CLI's
    --check inputs on its TMA + wgmma route, at 8²·256→256 on WMMA, f32 on
    the CUDA cores), checking each call's route by its launch counts;
    K6 (out-head) on each of its routes at ``K6_HOLDS`` (the bench shape,
    the CLI's --check inputs, MNIST's 28²·64→1, a 1 MB sample, C=512 and
    2048, G=16, B=1, Cout 2 and 6; heads of Cout 8, 9, 12 and 16 in
    passes of at most 7; on the CUDA-core kernel C in chunks on group
    boundaries (f32 at C=1760 and 2048, bf16 at 2080 into an f32 sum),
    a 700-wide row in column tiles and C=12 by element loads; bf16 on
    the cluster + tensor-core route, bf16 shapes it does not take on the
    CUDA-core kernel, f32 on that kernel; every template instance of both
    kernels), checking each call's route and its launches (one a pass
    and chunk); and K7 (in-conv; bf16 on the
    tensor cores, f32 on the CUDA cores) at 32², C=128, each against its
    plain version; checks refusals and ``Conv3x3Function``'s gradients;
    runs both CLIs' ``--check`` and ``--bench`` as subprocesses, each of
    which must launch every kernel it covers; and times the four kernels
    at their bench shapes beside their plain versions, ``F.conv2d`` and
    their bounds, K5 and K4 in turns with their earlier WMMA kernel, K6 in
    turns with its CUDA-core kernel (also at 32²·128→8 and →16, B=2048,
    64²·128→3, B=256, and 28²·64→1, B=2048).

Then the samplers, through the entry points a user calls:

11. a. holds each new sampler on the card against the same sampler on
       the CPU (f32, B=2, full width, the same x_T and injected draws,
       within 1e-3 + 1e-3·|ref|: each network call at the card's input,
       then the samples on the same network outputs): DDIM S=4 at η=0 and 0.5, DPM++ S=4,
       Heun S=3, strided S=4, CFG 3.0 through DDIM S=4 and DPM++ S=4 on
       the conditional model, inpainting at ``num_timesteps: 10`` (a cut),
       and on the learned-variance model 3 ancestral steps, strided S=4,
       ``nll_bits_per_dim`` at ``num_timesteps: 10`` and the hybrid loss
       with every gradient;
    b. serves ``ddim_config.yaml`` (``--model_type ddim``; one DDIM-50
       request also traced with ``torch.profiler``), the same with
       ``num_classes: 10`` and ``ddpm_config.yaml`` with ``learn_sigma:
       true`` over HTTP in bf16 at the serve batch, and times three
       requests after a warm-up for each of ``SERVE_CASES`` (DDIM-50,
       DPM++-20, Heun-18, strided-100; CFG 3.0 through DDIM-50 and
       DPM++-20; strided-100 with the learned variance), each of which
       must launch K1 and K3 exactly 53× and 5× its UNet forwards;
    c. runs ``train --model_type ddim`` for a few steps at full width (a
       DDIM sample grid), ``generate --ema --sampler dpm++`` from its
       checkpoint, ``generate --class_id 3`` and ``--inpaint_image/
       --inpaint_mask`` on a saved conditional model, and ``train`` with
       ``learn_sigma: true``.

Then the score-based and energy-based families, at the published widths
of ``score_based_config.yaml`` (the same C=128 UNet with a σ embedding)
and ``energy_based_config.yaml`` (the EnergyNet, C=128 on 3+128 input
channels):

12. a. holds each family on the card against the CPU (f32, B=2, the same
       weights and injected draws, within 1e-3 + 1e-3·|ref|): the σ-UNet
       at σ 0.01, 1 and 50; 2 levels × 2 Langevin steps (each score, then
       the iterate relative to its size); the DSM loss and every gradient;
       the EnergyNet's E and ∇ₓE; CD + GP and the energy DSM with their
       second-order gradients; 2 levels of each energy sampler;
    b. serves each family over HTTP in bf16 at the serve batch with one
       cut, 50 levels × 10 Langevin steps (``FAMILIES``): a warm-up and
       three timed requests, the seconds, images/s, host ms a network
       evaluation, the published ladder's forecast and the device busy
       share of 5 of a request's levels (``torch.profiler``); the score
       request must launch K1 and K3 exactly 53× and 5× its 500
       forwards, the energy request no K1, K2 or K3 (its GroupNorm is the
       plain version, as the reference's is XLA's);
    c. runs ``train`` for 3 steps at each config's batch of 64 on the
       synthetic set (the score training must launch K1, K2 and K3, the
       energy training none) and ``generate --ema`` from its checkpoint,
       the YAML copies cut to 5 levels (``FAMILY_CLI_CUTS``).

Then the sample-quality harness (``utils/benchmarks.py``,
``utils/inception.py``, ``utils/vgg.py``), with InceptionV3 weights drawn
from a seed and written as the reference's ``.npz``:

13. a. holds the seeded extractor (B=4, 32² and 128²), InceptionV3 (B=2,
       a 32² input resized to 299²), the VGG16 taps (B=2, 32²) and one
       DDPM training loss with ``perceptual_weight: 0.1`` and its
       gradients (B=2) on the card against the CPU in f32, within
       1e-3 + 1e-3·|ref|;
    b. runs ``train --eval_only --benchmark`` on ``ddpm_config.yaml`` at
       full width as a subprocess, the synthetic set as the test set,
       ``HARNESS_BENCH`` (64 samples in batches of 16 by DPM++-20) and
       ``DMU_INCEPTION_WEIGHTS`` at the seeded file: finite metrics in the
       results file, no fallback, four sample grids, and K1 and K3
       launched exactly 53× and 5× the 76 UNet forwards of the benchmark;
    c. times one in-process ``--benchmark`` run of two batches of 16,
       split into sampling and extraction, and InceptionV3 in f32 at 299²
       at B=64 and 128 (CUDA events), the network alone and from 32²
       images.
    13a also runs InceptionV3 under PyTorch's default TF32 setting (the
    ``train`` CLI's): as it is, and through the harness's
    ``f32_extraction``, which must hold 1e-4 of the largest output.

Then MNIST and CelebA, the transforms and the trainer's remaining
options (``grad_accum_steps``, ``ema_dtype``, ``adam_mu_dtype``,
``remat_policy: save_convout``, ``track_histograms``, ``--profile``):

14. a. holds on the card against the CPU in f32: the resize's arithmetic
       (28→32, 128→64), rotation (nearest: at most 0.1% of the pixels at
       a rounding tie; bilinear), the crop and the colour jitter on the
       same draws; K1, K2 and K3 at every call shape of a 64² training
       step (B=2 f32, B=64 bf16 autocast: attention at S=4, 16 and 64),
       each in bf16 and f32 against its plain version, and 100/53/9
       dispatches a step; one f32 step with ``remat_policy:
       save_convout`` and one accumulated update of 2 × B=2 (loss and
       every gradient within 1e-3 + 1e-3·|ref|); three steps with the
       bf16 EMA and μ, each within one bf16 ulp of the CPU's plus the
       steps' own error;
    b. runs ``train`` at full width on MNIST IDX files written from the
       seed (``MNIST_SIZES``) with every option on and ``--profile 3``:
       the trace names K1's, K2's and K3's kernels, histograms are logged
       at the counted steps, the final checkpoint keeps bf16 EMA and μ,
       and K1–K3 launch exactly as counted;
    c. trains CelebA at 64² in-process from a ``celeba_128.npz`` written
       from the seed (B=64, ``CELEBA_TRANSFORMS``: rotation, crop and
       jitter in the loader on the card): ``CELEBA_STEPS`` timed steps
       with exact launches, a profiled window, and the loader's device ms
       for rotation + crop + jitter at B=128;
    d. times an update at B=128 with A=1 and A=2, in turns; ms a step
       and peak ``max_memory_allocated`` with no remat, full remat and
       ``save_convout``; and K1, K2 and K3 at the 64² training shapes
       beside their plain versions, the library call and the bound.

Then data parallelism over ``torch.distributed`` (``parallel/mesh.py``,
``train --num_devices`` and ``--multihost``), at the full width of
``ddpm_config.yaml`` (B=128, the synthetic set of ``DP_SAMPLES``):

15. a. takes one f32 update with the plain trainer and one with the
       data-parallel trainer in a NCCL group of world 1 on the same
       batch, draws and dropout state, which must be bit-equal (cuDNN
       deterministic);
    b. spawns ``DP_RANKS`` gloo ranks sharing the card through the port's
       launcher: one f32 update (dropout 0) held against one process on
       the same global batch and draws (loss rtol 1e-5, gradient norms
       rtol 1e-4, Adam μ 1e-7 + rtol 1e-3); in bf16 with remat
       (dropout 0) ``validate()`` against one process (rtol 1e-6, f64
       sums), ``DP_UPDATES`` updates with the replicas' parameters, EMA
       and μ bit-equal after each and K1/K2/K3 exactly 100/53/9 an update
       on each rank; a SIGTERM to rank 1 alone makes both ranks save at
       the same step, rank 0 alone writes the checkpoint and the launcher
       returns 143; then ``train --multihost --resume latest`` under a
       torchrun environment of world 1 (one process, bf16, remat) must
       report NCCL, print the ranks' parameter digest, and launch K1–K3
       exactly as counted over its epoch of 8 updates;
    c. times an update of B=128 on the two ranks sharing the card beside
       one process: a measure of sharing one card, not of scaling.

The last three lines of standard output are the ``kernels`` JSON line
(all seven kernels; K1–K3 with their 64² training rows and the launches
of each path, phase 15's per rank),
the card's name and power limit from ``nvidia-smi``, and the result
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before the result line. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import copy
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

from diffusion_model_universal_torch.utils.timing import card_line, cuda_ms

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "diffusion_model_universal_torch" / "configs" / "ddpm_config.yaml"
SERVE_BATCH = 16
SEED = 0
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and the rate of
# the operations each kernel's inputs allow.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # |a−b| ≤ tol + tol·|b|
UNET_TOL = 1e-3

GN_REPLACES = "diffusion_model_universal_tpu/ops/group_norm.py:167"
GN_BWD_REPLACES = "diffusion_model_universal_tpu/ops/group_norm.py:184"
MHA_REPLACES = "diffusion_model_universal_tpu/ops/attention.py:38"

TRAIN_BATCH = 128           # ddpm_config.yaml's training.batch_size
#: Kernel launches of one training step of the UNet with remat on: K1 53
#: times in the forward and 47 more when the backward recomputes the
#: down/up stages, K2 once per GroupNorm, K3 5 + 4 recomputed.
#: tests/test_torch_train.py counts the same on the CPU.
LAUNCHES_PER_STEP = {"gn": 100, "gn_bwd": 53, "mha": 9}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def hold(name: str, got, want, tol: float, rtol: float | None = None
         ) -> float:
    """Check |got − want| ≤ tol + rtol·|want| elementwise (in f32; rtol
    defaults to tol) and that got is finite; returns max |got − want|."""
    rtol = tol if rtol is None else rtol
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    ok = bool((d <= tol + rtol * want.float().abs()).all()) and bool(
        got.float().isfinite().all())
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol:.3g} abs + {rtol:g} "
        f"rel) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


# -- timing ---------------------------------------------------------------

def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ---------------------------------------------------------------

def build_kernels():
    from diffusion_model_universal_torch.ops import _build
    secs = _build.build_all()
    log(f"[build] {len(_build.kernel_names())} kernels built in "
        f"{secs:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    return secs


def model_config():
    from diffusion_model_universal_torch.utils.config import (
        canonicalize_model_config, load_config, resolve_interpolations)
    cfg = resolve_interpolations(load_config(str(CONFIG)))
    return canonicalize_model_config(cfg["model_config"])


def make_f32_model(cfg):
    """Full-width f32 DDPM on the card from seeded weights, with the
    zero-initialized leaves given small seeded values."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    model = DDPM(dict(cfg, compute_dtype="float32"), device=DEVICE, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.net.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def record_shapes(model):
    """Every (GroupNorm, attention) call shape of one forward at the serve
    batch, with its count per forward."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    gn_calls, mha_calls = {}, {}
    gn, mha = gn_ops.group_norm_silu, attn_ops.multi_head_attention

    def rec_gn(x, scale, bias, groups, time_bias=None, eps=1e-5,
               apply_silu=True):
        b, h, w, c = x.shape
        key = (b, h * w, c, groups, time_bias is not None, apply_silu)
        gn_calls[key] = gn_calls.get(key, 0) + 1
        return gn(x, scale, bias, groups, time_bias, eps, apply_silu)

    def rec_mha(q, k, v):
        mha_calls[tuple(q.shape)] = mha_calls.get(tuple(q.shape), 0) + 1
        return mha(q, k, v)

    gn_ops.group_norm_silu, attn_ops.multi_head_attention = rec_gn, rec_mha
    try:
        x = torch.randn(model.sample_shape(SERVE_BATCH), device=DEVICE)
        t = torch.full((SERVE_BATCH,), 999, device=DEVICE, dtype=torch.long)
        with torch.no_grad():
            model.apply(x, t)
        torch.cuda.synchronize()
    finally:
        gn_ops.group_norm_silu, attn_ops.multi_head_attention = gn, mha
    return gn_calls, mha_calls


def gn_inputs(key, dtype, gen):
    import torch
    b, s, c, groups, has_tb, _ = key
    x = (torch.randn((b, 1, s, c), generator=gen, device=DEVICE) * 2 + 0.5)
    scale = torch.rand(c, generator=gen, device=DEVICE) + 0.5
    bias = torch.randn(c, generator=gen, device=DEVICE) * 0.1
    tb = (torch.randn((b, c), generator=gen, device=DEVICE) * 0.5
          if has_tb else None)
    return x.to(dtype), scale, bias, tb


def mha_inputs(shape, dtype, gen):
    """q, k, v as the UNet passes them: head-split views of [B, S, N·D]."""
    import torch
    b, n, s, d = shape
    return [torch.randn((b, s, n * d), generator=gen, device=DEVICE).to(
        dtype).view(b, s, n, d).transpose(1, 2) for _ in range(3)]


def log_plan(kernel: str, dname: str, key, plan) -> None:
    """Logs the launch plan of K1/K2 at one shape and dtype, once."""
    tag = (kernel, dname, key, plan)
    if tag not in LOGGED_PLANS:
        LOGGED_PLANS.add(tag)
        log(f"  {kernel} {dname} {gn_label(key)} plan: {plan.describe()}")


LOGGED_PLANS = set()


def hold_gn_one(key, dtype, gen, x=None) -> float:
    """K1 against its plain version on one shape (``x`` given, or made
    from ``gen``) within TOL; two calls must be bit-identical."""
    import torch
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    dname = str(dtype).removeprefix("torch.")
    x0, scale, bias, tb = gn_inputs(key, dtype, gen)
    x = x0 if x is None else x
    groups, silu = key[3], key[5]
    got = gn_ops.group_norm_silu_cuda(x, scale, bias, groups, tb,
                                      apply_silu=silu)
    again = gn_ops.group_norm_silu_cuda(x, scale, bias, groups, tb,
                                        apply_silu=silu)
    want = gn_ops.group_norm_silu_plain(x, scale, bias, groups, tb,
                                        apply_silu=silu)
    torch.cuda.synchronize()
    log_plan("K1", dname, key, gn_ops.plan_for_call(x, groups, False, got))
    check(torch.equal(got, again),
          f"K1 {dname} {gn_label(key)} differs between calls")
    return hold(f"K1 {dname} {gn_label(key)} (bit-identical over two "
                "calls)", got, want, TOL[dname])


def hold_kernels(gn_calls, mha_calls):
    """Each kernel against its plain version at ``gn_calls``/``mha_calls``
    shapes in bf16 and f32 (K1 also bit-identical over two calls);
    returns the max abs errors by (shape, dtype)."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    errs = {"gn": {}, "mha": {}}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        tol = TOL[dname]
        for key in sorted(gn_calls):
            errs["gn"][(key, dname)] = hold_gn_one(key, dtype, gen)
        for shape in sorted(mha_calls):
            q, k, v = mha_inputs(shape, dtype, gen)
            got = attn_ops.mha_cuda(q, k, v)
            want = attn_ops.mha_plain(q, k, v)
            torch.cuda.synchronize()
            errs["mha"][(shape, dname)] = hold(
                f"K3 {dname} {mha_label(shape)}", got, want, tol)
    return errs


#: GroupNorm shapes off this config's path, K1 and K2 alike: the 64²
#: config's S=4096 (in f32 K1, and K2 in both dtypes, too large for an
#: 8-block cluster's shared memory: the re-read path), odd sizes, rows
#: that are not a whole number of 16-byte vectors (C=12, 6 and 3: 8-, 4-
#: and 2-byte vectors in bf16; at S=1024 the rows go through shared memory
#: without bulk copies), 512 channels a group, and a batch of 600
#: single-pixel samples (two samples a block).
GN_EDGE_SHAPES = [(2, 4096, 128, 32, True, True), (3, 7, 24, 8, False, True),
                  (1, 9, 48, 16, True, False), (3, 5, 12, 4, True, True),
                  (2, 1024, 12, 4, True, True), (2, 9, 6, 3, False, True),
                  (2, 7, 3, 1, True, False), (2, 4, 1024, 2, True, True),
                  (600, 1, 512, 32, True, True)]


#: K3 off this config's path: S ∈ MHA_EDGE_S × D ∈ MHA_EDGE_D at B·N = 4
#: (one key tile, several, ragged last tiles; S ≤ 16 packs four heads a
#: block, S = 256 is the 128² UNet's down3/up1, S = 1024 a 32×32 map),
#: and shapes the earlier kernel refused or that take other paths: S=128
#: D=128 (refused before), B·N = 3 (a partial group of four heads), D=20
#: (rows not whole 16-byte copies: scalar loads), D=300 (two output
#: chunks), D=520 at S=5.
MHA_EDGE_S = (1, 4, 16, 17, 64, 65, 256, 1024)
MHA_EDGE_D = (32, 64, 128)
MHA_EDGE_SHAPES = ([(2, 2, s, d) for s in MHA_EDGE_S for d in MHA_EDGE_D]
                   + [(2, 2, 128, 128), (3, 1, 7, 32), (1, 2, 33, 20),
                      (2, 1, 40, 300), (1, 1, 5, 520)])


def hold_edges():
    """Shapes off this config's path: GN_EDGE_SHAPES, x one element off
    16-byte alignment, K3 at MHA_EDGE_SHAPES, and odd sizes; then inputs
    the wrappers must refuse."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    log("[hold] off-path shapes:")
    before = attn_ops.MHA_KERNEL.launches
    hold_kernels({key: 1 for key in GN_EDGE_SHAPES},
                 {shape: 1 for shape in MHA_EDGE_SHAPES})
    check(attn_ops.MHA_KERNEL.launches - before == 2 * len(MHA_EDGE_SHAPES),
          "K3 did not launch once per edge shape and dtype")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    key = (2, 64, 128, 32, True, True)
    for dtype in (torch.bfloat16, torch.float32):
        n = 2 * 64 * 128
        flat = torch.randn(n + 1, generator=gen, device=DEVICE).to(dtype)
        hold_gn_one(key, dtype, gen, x=flat[1:].view(2, 1, 64, 128))
    x = torch.zeros((2, 4, 4, 32), device=DEVICE)
    w = torch.ones(32, device=DEVICE)
    wide = torch.zeros((1, 1, 1, 16384), device=DEVICE)
    ww = torch.ones(16384, device=DEVICE)
    q = torch.zeros((1, 1, 8, 16), device=DEVICE, dtype=torch.float16)
    refusals = [
        ("float16 x", lambda: gn_ops.group_norm_silu_cuda(x.half(), w, w, 8)),
        ("non-contiguous x", lambda: gn_ops.group_norm_silu_cuda(
            x.transpose(1, 2), w, w, 8)),
        ("groups not dividing C", lambda: gn_ops.group_norm_silu_cuda(
            x, w, w, 5)),
        ("a row of 16384 channels (K1)", lambda: gn_ops.group_norm_silu_cuda(
            wide, ww, ww, 32)),
        ("float16 attention", lambda: attn_ops.mha_cuda(q, q, q)),
    ]
    for what, call in refusals:
        try:
            call()
        except ValueError:
            log(f"  refuses {what}: ok")
        else:
            raise SmokeFailure(f"a wrapper accepted {what}")
    hold_plan_refusals()


def hold_plan_refusals():
    """K3 and K4's sm90 route launch on the plan Python gives them, and
    their C entries check it: a plan off by one refuses to launch."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    q = torch.zeros((2, 4, 16, 64), device=DEVICE, dtype=torch.bfloat16)
    x = torch.zeros((1, 16, 16, 128), device=DEVICE, dtype=torch.bfloat16)
    ab = torch.ones((1, 128), device=DEVICE)
    w = torch.zeros((3, 3, 128, 128), device=DEVICE, dtype=torch.bfloat16)
    mha_plan, gn_smem = attn_ops.mha_launch_plan, cv.gn_sm90_smem_bytes
    k4 = cv.GN_SILU_CONV3X3_KERNELS["sm90"]
    cases = [
        ("K3, units + 1", attn_ops, "mha_launch_plan",
         lambda *a: mha_plan(*a)._replace(units=mha_plan(*a).units + 1),
         lambda: attn_ops.mha_cuda(q, q, q), attn_ops.MHA_KERNEL),
        ("K3, a key tile short", attn_ops, "mha_launch_plan",
         lambda *a: mha_plan(*a)._replace(
             key_tiles=mha_plan(*a).key_tiles - 1),
         lambda: attn_ops.mha_cuda(q, q, q), attn_ops.MHA_KERNEL),
        ("K4 sm90, shared bytes + 16", cv, "gn_sm90_smem_bytes",
         lambda *a: gn_smem(*a) + 16,
         lambda: cv.gn_silu_conv3x3_cuda(x, ab, ab, w), k4),
    ]
    for what, module, name, wrong, call, kernel in cases:
        before = kernel.launches
        setattr(module, name, wrong)
        try:
            call()
        except RuntimeError:
            log(f"  refuses a plan off by one ({what}): ok")
        else:
            raise SmokeFailure(f"{what}: the kernel launched a wrong plan")
        finally:
            attn_ops.mha_launch_plan, cv.gn_sm90_smem_bytes = \
                mha_plan, gn_smem
        check(kernel.launches == before, f"{what}: counted a launch")
    check(cv.gn_silu_conv3x3_route(x.shape, w.shape, x.dtype).name == "sm90",
          "the K4 refusal shape left the sm90 route")


def gn_label(key) -> str:
    b, s, c, groups, has_tb, silu = key
    return (f"B{b} S{s} C{c} G{groups}{' +tb' if has_tb else ''}"
            f"{' +silu' if silu else ''}")


def mha_label(shape) -> str:
    b, n, s, d = shape
    return f"B{b} N{n} S{s} D{d}"


def hold_unet(model, batch: int = 2, steps: bool = True):
    """One f32 forward at ``batch`` and (``steps``) 3 sampler steps on the
    card, against the same module on the CPU (plain versions there)."""
    import torch
    cpu_model = copy.copy(model)
    cpu_model.net = copy.deepcopy(model.net).cpu()
    cpu_model.device = torch.device("cpu")
    cpu_model.schedule = type(model.schedule)(
        **{k: v.cpu() for k, v in vars(model.schedule).items()})
    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn(model.sample_shape(batch), generator=gen)
    t = torch.tensor([0, 731][:batch])
    size = model.sample_shape(1)[1]
    with torch.no_grad():
        want = cpu_model.apply(x, t)
        got = model.apply(x.to(DEVICE), t.to(DEVICE)).cpu()
    log(f"[unet] full-width f32 forward B={batch} at {size}², output |max| "
        f"{float(want.abs().max()):.3f}")
    errs = [hold(f"UNet forward {size}², card vs CPU", got, want, UNET_TOL)]
    if not steps:
        return errs[0]
    draws = [torch.randn(model.sample_shape(batch), generator=gen)
             for _ in range(4)]
    it_c, it_g = iter(draws), iter([d.to(DEVICE) for d in draws])
    with torch.inference_mode():
        want = cpu_model._denoise_range(next(it_c), 3, 0,
                                        lambda: next(it_c))
        got = model._denoise_range(next(it_g), 3, 0,
                                   lambda: next(it_g)).cpu()
    errs.append(hold(f"3 sampler steps t=2..0 {size}², card vs CPU", got,
                     want, UNET_TOL))
    return max(errs)


def hold_unet_128(cfg):
    """Phase 3b: the config at ``image_size: 128`` (only that key
    overridden; C=128, so down3/up1's attention has S=256, D=64, which the
    earlier K3 refused): one f32 forward at B=1 on the card against the
    CPU within UNET_TOL, then 3 bf16 sampler steps at the serve batch on
    the card, finite and of the expected shape, K3 launched each step."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.models.convert import \
        unet_params_to_jax
    from diffusion_model_universal_torch.ops import attention as attn_ops
    cfg128 = dict(cfg, image_size=128)
    t0 = time.perf_counter()
    model = make_f32_model(cfg128)
    shapes = {}
    mha = attn_ops.multi_head_attention

    def rec(q, k, v):
        shapes[tuple(q.shape)] = shapes.get(tuple(q.shape), 0) + 1
        return mha(q, k, v)

    attn_ops.multi_head_attention = rec
    try:   # two forwards: the CPU's and the card's
        err = hold_unet(model, batch=1, steps=False)
    finally:
        attn_ops.multi_head_attention = mha
    shapes = {k: n // 2 for k, n in shapes.items()}
    log(f"[unet128] attention shapes of a B=1 forward: "
        f"{ {mha_label(k): n for k, n in sorted(shapes.items())} }")
    check(any(s[2] == 256 for s in shapes), "no S=256 attention at 128²")
    bf = DDPM(cfg128, device=DEVICE, seed=SEED)
    bf.load_params(unet_params_to_jax(model.net))
    del model
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    before = attn_ops.MHA_KERNEL.launches
    with torch.inference_mode():
        x = bf._denoise_range(
            torch.randn(bf.sample_shape(SERVE_BATCH), generator=gen,
                        device=DEVICE), 3, 0,
            lambda: torch.randn(bf.sample_shape(SERVE_BATCH), generator=gen,
                                device=DEVICE))
    torch.cuda.synchronize()
    launched = attn_ops.MHA_KERNEL.launches - before
    check(tuple(x.shape) == (SERVE_BATCH, 128, 128, 3)
          and bool(x.isfinite().all()), f"128² sampler steps: {x.shape}")
    check(launched == 3 * sum(shapes.values()),
          f"K3 launched {launched} times in 3 steps, not 3 × "
          f"{sum(shapes.values())}")
    secs = time.perf_counter() - t0
    log(f"[unet128] 3 bf16 sampler steps at B={SERVE_BATCH}, 128²: finite, "
        f"range [{float(x.min()):.2f}, {float(x.max()):.2f}]; K3 launched "
        f"{launched} times; phase {secs:.1f} s")
    return {"unet_max_abs_err": err, "attention_shapes": {
        mha_label(k): n for k, n in sorted(shapes.items())},
        "k3_launches_3_steps": launched, "seconds": secs}


def serve(model_f32, cfg, per_forward):
    """Three requests and a healthz through the port's HTTP server."""
    import numpy as np
    import torch
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.models.convert import \
        unet_params_to_jax
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    from diffusion_model_universal_torch.scripts.serve import (
        build_argparser, make_server)
    from diffusion_model_universal_torch.utils.images import decode_png

    kernels = {"gn": gn_ops.GN_KERNEL, "mha": attn_ops.MHA_KERNEL}
    tmp = tempfile.mkdtemp(prefix="dmu_smoke_")
    ckpt = str(Path(tmp) / "model.ckpt")
    # Default compute dtype on the card (bf16), the f32 model's weights.
    saver = DDPM(cfg, device=DEVICE, seed=SEED)
    saver.load_params(unet_params_to_jax(model_f32.net))
    saver.save(ckpt)
    del saver
    args = build_argparser().parse_args([
        "--config", str(CONFIG), "--model_type", "ddpm",
        "--checkpoint", ckpt, "--port", "0",
        "--serve_batch", str(SERVE_BATCH), "--device", DEVICE])
    srv = make_server(args)
    service = srv.service
    T = service.model.num_timesteps
    log(f"[serve] model on {service.model.device}, compute dtype "
        f"{service.model.compute_dtype}, T={T}, serve_batch {SERVE_BATCH}")
    warm = service.warmup()
    log(f"[serve] warmup request (batch {SERVE_BATCH}): {warm:.2f} s")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    base = f"http://{host}:{port}"
    results = []
    try:
        for k in kernels.values():
            k.launches = 0
        for body in ({"num_samples": SERVE_BATCH, "seed": 1, "format": "npy"},
                     {"num_samples": 4, "seed": 2, "format": "npy"},
                     {"num_samples": 9, "seed": 3, "format": "png"}):
            before = {n: k.launches for n, k in kernels.items()}
            req = urllib.request.Request(
                base + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                payload = r.read()
                ctype = r.headers["Content-Type"]
            secs = time.perf_counter() - t0
            n = body["num_samples"]
            if body["format"] == "npy":
                check(ctype == "application/octet-stream", "npy content type")
                arr = np.load(io.BytesIO(payload))
                check(arr.shape == (n, 32, 32, 3), f"npy shape {arr.shape}")
                check(bool(np.isfinite(arr).all()), "non-finite samples")
                what = (f"npy {arr.shape}, range [{arr.min():.2f}, "
                        f"{arr.max():.2f}]")
            else:
                check(ctype == "image/png", "png content type")
                grid = decode_png(payload)
                side = math.ceil(math.sqrt(n))
                check(grid.shape == (side * 34 + 2, side * 34 + 2, 3),
                      f"png grid shape {grid.shape}")
                what = f"png grid {grid.shape}"
            delta = {nm: k.launches - before[nm] for nm, k in kernels.items()}
            want = {nm: T * per_forward[nm] for nm in kernels}
            check(delta == want, f"launches {delta} != T × per-forward {want}")
            results.append({"request": body, "seconds": secs,
                            "images_per_s_of_batch": SERVE_BATCH / secs})
            log(f"[serve] POST /generate {body}: {what}, {secs:.3f} s "
                f"({SERVE_BATCH / secs:.2f} img/s of the {SERVE_BATCH}-batch)"
                f"; launches {delta}")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            info = json.loads(r.read())
        check(info["status"] == "ok" and info["requests"] == 4,
              f"healthz {info}")
        log(f"[serve] GET /healthz: {info}")
        launches = {nm: k.launches for nm, k in kernels.items()}
        check(all(launches.values()), f"a kernel never launched: {launches}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    check(not thread.is_alive(), "server thread did not stop")
    return service.model, results, launches


#: K3 timed off the main path too (×0 in the totals): S=256 (the 128²
#: UNet's down3/up1) and S=1024, D=64, B·N = 64 as when serving.
MHA_TIME_SHAPES = [(16, 4, 256, 64), (16, 4, 1024, 64)]


def time_kernels(gn_calls, mha_calls, dtype_name="bfloat16"):
    """Per-shape kernel, plain, library and bound ms at the main path's
    serving dtype; K3 also at MHA_TIME_SHAPES (weighted ×0 in totals)."""
    import torch
    import torch.nn.functional as F
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    gn_rows, mha_rows = [], []
    for key in sorted(gn_calls):
        b, s, c, groups, has_tb, silu = key
        x, scale, bias, tb = gn_inputs(key, dtype, gen)
        sl, bl = scale.to(dtype), bias.to(dtype)
        x_nchw = x.permute(0, 3, 1, 2)
        tb4 = tb[:, :, None, None].to(dtype) if has_tb else None

        def library():
            y = F.group_norm(x_nchw + tb4 if has_tb else x_nchw, groups,
                             sl, bl, 1e-5)
            return F.silu(y) if silu else y

        ms = cuda_ms(lambda: gn_ops.group_norm_silu_cuda(
            x, scale, bias, groups, tb, apply_silu=silu))
        plain = cuda_ms(lambda: gn_ops.group_norm_silu_plain(
            x, scale, bias, groups, tb, apply_silu=silu))
        lib = cuda_ms(library)
        n = b * s * c
        nbytes = 2 * n * isz + 2 * c * 4 + (b * c * 4 if has_tb else 0)
        ops = n * (7 + (4 if silu else 0) + (1 if has_tb else 0))
        bms, by = bound(nbytes, ops, dtype_name)
        gn_rows.append({"shape": gn_label(key), "per_forward": gn_calls[key],
                        "ms": ms, "plain_ms": plain, "library_ms": lib,
                        "bound_ms": bms, "bound_by": by})
    for shape in sorted(mha_calls) + MHA_TIME_SHAPES:
        b, n, s, d = shape
        q, k, v = mha_inputs(shape, dtype, gen)
        ms = cuda_ms(lambda: attn_ops.mha_cuda(q, k, v))
        plain = cuda_ms(lambda: attn_ops.mha_plain(q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes = 4 * b * n * s * d * isz
        ops = b * n * (4 * s * s * d + 5 * s * s)
        bms, by = bound(nbytes, ops, dtype_name)
        mha_rows.append({"shape": mha_label(shape),
                         "per_forward": mha_calls.get(shape, 0), "ms": ms,
                         "plain_ms": plain, "library_ms": lib,
                         "bound_ms": bms, "bound_by": by})
    for label, rows in (("K1", gn_rows), ("K3", mha_rows)):
        for r in rows:
            log(f"[time] {label} {dtype_name} {r['shape']} ×{r['per_forward']}"
                f": kernel {r['ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, library "
                f"{r['library_ms'] * 1e3:.2f} us, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return gn_rows, mha_rows


def totals(rows):
    """Sums over the shapes, each weighted by its calls (per forward, or
    per training step): the numbers of that much of the kernel's work."""
    tot = {k: sum(r[k] * r["per_forward"] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(r["bound_ms"] * r["per_forward"] for r in rows
                  if r["bound_by"] == "bytes")
    tot["bound_by"] = ("bytes" if t_bytes * 2 >= tot["bound_ms"]
                       else "operations")
    return tot


def kernel_entry(name, source, replaces, rows, launches, errs, work,
                 **extra):
    tot = totals(rows)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": max(v for (_, d), v in errs.items()
                               if d == "float32"),
        "max_abs_err_bf16": max(v for (_, d), v in errs.items()
                                if d == "bfloat16"),
        "tol": TOL,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
        "library_ms": tot["library_ms"], "work": work, "shapes": rows,
        **extra,
    }


def profile_steps(model, steps: int = 5):
    """Device busy share and the kernels' share over a few sampler steps."""
    import torch
    step = model.posterior_step_fn()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    x = torch.randn(model.sample_shape(SERVE_BATCH), generator=gen,
                    device=DEVICE)
    t_b = torch.full((SERVE_BATCH,), 500, device=DEVICE, dtype=torch.long)
    with torch.inference_mode():
        return profile_run(lambda: step(x, t_b, torch.randn_like(x)), steps,
                           "sampler")


def time_dispatch(model, steps: int = 50, reps: int = 10):
    """Wall ms per sampler step at the serve batch with every GroupNorm
    and attention call made through its autograd Function (the ops' only
    path), and with the kernels called directly: ``reps`` pairs, each
    side first in every other pair. What ``Function.apply`` costs the
    host-bound sampler loop."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    gn, mha = gn_ops.group_norm_silu, attn_ops.multi_head_attention

    def gn_function(x, scale, bias, num_groups, time_bias=None, eps=1e-5,
                    apply_silu=True):
        return gn_ops.GroupNormSiLUFunction.apply(
            x, scale, bias, time_bias, num_groups, eps, apply_silu)

    def gn_direct(x, scale, bias, num_groups, time_bias=None, eps=1e-5,
                  apply_silu=True):
        return gn_ops._gn_fwd(x, scale, bias, num_groups, time_bias, eps,
                              apply_silu)

    variants = {"function": (gn_function, attn_ops.MHAFunction.apply),
                "direct": (gn_direct, attn_ops._mha_fwd)}
    step = model.posterior_step_fn()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    x = torch.randn(model.sample_shape(SERVE_BATCH), generator=gen,
                    device=DEVICE)
    t_b = torch.full((SERVE_BATCH,), 500, device=DEVICE, dtype=torch.long)
    ms = {name: [] for name in variants}
    try:
        with torch.inference_mode():
            for rep in range(reps):
                order = list(variants.items())
                for name, (gn_fn, mha_fn) in order[::1 - 2 * (rep % 2)]:
                    gn_ops.group_norm_silu = gn_fn
                    attn_ops.multi_head_attention = mha_fn
                    for _ in range(3):
                        step(x, t_b, torch.randn_like(x))
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        step(x, t_b, torch.randn_like(x))
                    torch.cuda.synchronize()
                    ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
    finally:
        gn_ops.group_norm_silu, attn_ops.multi_head_attention = gn, mha
    out = {name: {"median": statistics.median(v), "min": min(v),
                  "max": max(v), "runs": v} for name, v in ms.items()}
    out["steps_per_run"] = steps
    out["direct_faster_pairs"] = sum(
        d < f for f, d in zip(ms["function"], ms["direct"]))
    out["function_quartiles"] = statistics.quantiles(ms["function"], n=4)
    log(f"[dispatch] sampler step at B={SERVE_BATCH}, {reps} pairs of runs "
        f"of {steps} steps, direct faster in {out['direct_faster_pairs']}, "
        f"Function quartiles {out['function_quartiles']}: through "
        f"Function.apply "
        f"{out['function']['median']:.3f} ms (min {out['function']['min']:.3f}"
        f", max {out['function']['max']:.3f}), kernels called directly "
        f"{out['direct']['median']:.3f} ms (min {out['direct']['min']:.3f}, "
        f"max {out['direct']['max']:.3f})")
    return out


def profile_run(run_step, steps: int, what: str, warmup: int = 3):
    """Device busy share, kernel launches, our kernels' device ms and the
    top kernels per call of ``run_step`` over ``steps`` calls
    (torch.profiler, after ``warmup`` warm-up calls); 'not measured' when it
    records no device time. Only device-side events (the kernels and
    copies themselves) are summed: a CPU op's entry repeats the device
    time of the kernels it launched. The top CPU ops by the device time
    they launched, and the count of a few host ops, are listed apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, ops, host = {}, {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA:
            dev[e.key] = (us / 1e3, e.count)
        elif us > 0:
            ops[e.key] = (us / 1e3, e.count)
        if e.key in ("aten::copy_", "aten::contiguous", "aten::_to_copy"):
            host[e.key] = e.count / steps
    if not dev:
        log(f"[profile] {what}: device time not measured (profiler saw no "
            "kernels)")
        return None
    busy = sum(v[0] for v in dev.values())
    kernels = sum(v[1] for v in dev.values())
    ours = {tag: sum(v[0] for k, v in dev.items() if tag in k)
            for tag in ("gn_fwd_kernel", "gn_bwd_kernel", "mha_fwd")}
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:8]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1][0])[:6]
    summary = {"what": what, "steps": steps,
               "wall_ms_per_step": wall_ms / steps,
               "device_busy_ms_per_step": busy / steps,
               "device_busy_share": busy / wall_ms,
               "device_kernels_per_step": kernels / steps,
               "host_calls_per_step": host,
               **{f"{tag}_ms_per_step": v / steps for tag, v in ours.items()},
               "top_kernels": [[k[:90], ms / steps, cnt / steps]
                               for k, (ms, cnt) in top],
               "top_ops_by_device_ms": [[k[:60], ms / steps, cnt / steps]
                                        for k, (ms, cnt) in top_ops]}
    log(f"[profile] {what}: {json.dumps(summary)}")
    for k, (ms, cnt) in top:
        log(f"[profile]   {ms / steps:.3f} ms/step  x{cnt / steps:.0f}  "
            f"{k[:90]}")
    return summary


# -- training path --------------------------------------------------------

def train_config(out_dir: str, **training):
    """ddpm_config.yaml with only the overrides the training phases need:
    the synthetic dataset (CIFAR-10's files are not in the repository),
    ``training`` keys, and an output directory under ``out_dir``."""
    from diffusion_model_universal_torch.utils.config import load_config
    cfg = load_config(str(CONFIG))
    cfg["data"] = dict(cfg["data"], dataset="synthetic")
    cfg["training"] = dict(cfg["training"], **training)
    cfg["output"] = dict(cfg["output"], output_dir=str(Path(out_dir) / "out"))
    return cfg


def make_trainer(cfg, out_dir: str):
    """The config's model built for training on the card (f32 weights,
    bf16 autocast, remat, dropout 0.1) and a DDPMTrainer over the
    synthetic set at the config's batch."""
    from diffusion_model_universal_torch.datasets import get_dataset
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.trainers import DDPMTrainer
    run_cfg = train_config(out_dir)
    model = DDPM(cfg, device=DEVICE, seed=SEED, trainable=True)
    loaders = get_dataset(run_cfg, device=model.device)
    return DDPMTrainer(model, *loaders, run_cfg, seed=SEED), loaders[0]


def record_train_step(run_step):
    """Every K1, K2 and K3 dispatch of one call of ``run_step``, by shape
    key, with its count; and how many K2 calls got a non-contiguous dy
    (which the wrapper copies)."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    calls = {"gn": {}, "gn_bwd": {}, "mha": {}, "dy_copies": 0}
    fwd, bwd, mha = gn_ops._gn_fwd, gn_ops._gn_bwd, attn_ops._mha_fwd

    def add(kind, key):
        calls[kind][key] = calls[kind].get(key, 0) + 1

    def rec_fwd(x, scale, bias, groups, time_bias, eps, silu):
        b, h, w, c = x.shape
        add("gn", (b, h * w, c, groups, time_bias is not None, silu))
        return fwd(x, scale, bias, groups, time_bias, eps, silu)

    def rec_bwd(x, scale, bias, time_bias, dy, groups, eps, silu):
        b, h, w, c = x.shape
        add("gn_bwd", (b, h * w, c, groups, time_bias is not None, silu))
        calls["dy_copies"] += int(not dy.is_contiguous())
        return bwd(x, scale, bias, time_bias, dy, groups, eps, silu)

    def rec_mha(q, k, v):
        add("mha", tuple(q.shape))
        return mha(q, k, v)

    gn_ops._gn_fwd, gn_ops._gn_bwd, attn_ops._mha_fwd = (rec_fwd, rec_bwd,
                                                         rec_mha)
    try:
        run_step()
        torch.cuda.synchronize()
    finally:
        gn_ops._gn_fwd, gn_ops._gn_bwd, attn_ops._mha_fwd = fwd, bwd, mha
    return calls


def red_tol(n_terms: int) -> float:
    """Absolute tolerance of an f32 sum of ``n_terms`` terms that K2 and
    its plain version add in different orders. The f32 tolerance TOL
    covers values built from sums of up to 1024 terms (a GroupNorm group
    at S=32², the largest per-element reduction); the rounding error of a
    sum taken in another order grows like the square root of its length,
    so the tolerance is scaled by sqrt(n / 1024)."""
    return TOL["float32"] * max(1.0, math.sqrt(n_terms / 1024))


def hold_gn_bwd_one(key, dname, gen) -> float:
    """K2 against its plain version on one shape: dx within TOL of the
    dtype, dγ/dβ (B·S terms each) and dtb (S terms) within
    :func:`red_tol` abs + the f32 TOL rel; and two calls bit-identical."""
    import torch
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    dtype = getattr(torch, dname)
    x, scale, bias, tb = gn_inputs(key, dtype, gen)
    dy = torch.randn(x.shape, generator=gen, device=DEVICE).to(dtype)
    b, s, _, groups, _, silu = key
    args = (x, scale, bias, tb, dy, groups)
    got = gn_ops.group_norm_silu_bwd_cuda(*args, apply_silu=silu)
    again = gn_ops.group_norm_silu_bwd_cuda(*args, apply_silu=silu)
    want = gn_ops.group_norm_silu_bwd_plain(*args, apply_silu=silu)
    torch.cuda.synchronize()
    log_plan("K2", dname, key, gn_ops.plan_for_call(x, groups, True, dy,
                                                     got[0]))
    rel = TOL["float32"]
    tols = {"dx": (TOL[dname], TOL[dname]), "dscale": (red_tol(b * s), rel),
            "dbias": (red_tol(b * s), rel), "dtb": (red_tol(s), rel)}
    errs = {}
    label = f"K2 {dname} {gn_label(key)}"
    for name, g, a, w in zip(tols, got, again, want):
        if w is None:
            check(g is None, f"{label}: {name} should be None")
            continue
        atol, rtol = tols[name]
        d = (g.float() - w.float()).abs()
        errs[name] = float(d.max())
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{label}: {name} is {g.dtype} {tuple(g.shape)}, plain "
              f"{w.dtype} {tuple(w.shape)}")
        check(bool((d <= atol + rtol * w.float().abs()).all())
              and bool(g.float().isfinite().all()),
              f"{label}: {name} disagrees with its plain version "
              f"(max err {errs[name]:.3e}, tol {atol:g} abs + {rtol:g} rel)")
        check(torch.equal(g, a), f"{label}: {name} differs between calls")
    log(f"  {label}: " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + " ok; bit-identical over two calls")
    return max(errs.values())


def hold_gn_bwd(bwd_calls):
    """Phase 6: K2 at every training shape in bf16 and f32, at edge shapes
    (GN_EDGE_SHAPES and group sizes 12, 24 and 256, S=1, odd B, no time
    bias, no SiLU), and inputs its wrapper must refuse."""
    import torch
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    errs = {}
    for dname in ("bfloat16", "float32"):
        for key in sorted(bwd_calls):
            errs[(key, dname)] = hold_gn_bwd_one(key, dname, gen)
    log("[hold] K2 off-path shapes:")
    for key in GN_EDGE_SHAPES + [
            (5, 1, 768, 32, True, True), (3, 5, 384, 32, True, True),
            (2, 16, 64, 8, False, False), (2, 4, 512, 2, True, True)]:
        for dname in ("bfloat16", "float32"):
            hold_gn_bwd_one(key, dname, gen)
    x = torch.zeros((2, 4, 4, 1024), device=DEVICE)
    w = torch.ones(1024, device=DEVICE)
    wide = torch.zeros((1, 1, 1, 16384), device=DEVICE)
    ww = torch.ones(16384, device=DEVICE)
    for what, call in [
            ("a row of 16384 channels",
             lambda: gn_ops.group_norm_silu_bwd_cuda(wide, ww, ww, None,
                                                     wide, 32)),
            ("dy of another dtype", lambda: gn_ops.group_norm_silu_bwd_cuda(
                x, w, w, None, x.bfloat16(), 32))]:
        try:
            call()
        except ValueError:
            log(f"  K2 refuses {what}: ok")
        else:
            raise SmokeFailure(f"K2's wrapper accepted {what}")
    return errs


def grads_of_step(model, x, t, noise):
    """Loss and parameter gradients of one training step's loss."""
    import torch
    loss = model.loss_function(x, t, noise)
    grads = torch.autograd.grad(loss, list(model.net.parameters()))
    return loss.detach().cpu(), [g.cpu() for g in grads]


def hold_train_step(cfg):
    """Phase 7: one f32 training step at B=2 (dropout off, remat on) on
    the card against the same step on the CPU: loss and every gradient
    within UNET_TOL; then the same step in bf16 autocast, whose loss is
    reported beside the f32 CPU loss."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    f32_cfg = dict(cfg, compute_dtype="float32", dropout=0.0)
    card = DDPM(f32_cfg, device=DEVICE, seed=SEED, trainable=True)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():   # the zero-initialized leaves get small values
        for p in card.net.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    cpu = DDPM(f32_cfg, device="cpu", seed=SEED, trainable=True)
    cpu.net.load_state_dict(card.net.state_dict())
    gen = torch.Generator().manual_seed(SEED + 7)
    x = torch.randn(card.sample_shape(2), generator=gen).clamp(-1, 1)
    t = torch.tensor([17, 803]) % card.num_timesteps
    noise = torch.randn(x.shape, generator=gen)
    want_loss, want = grads_of_step(cpu, x, t, noise)
    got_loss, got = grads_of_step(card, x.to(DEVICE), t.to(DEVICE),
                                  noise.to(DEVICE))
    loss_err = hold("f32 step loss, card vs CPU", got_loss, want_loss,
                    UNET_TOL)
    names = [n for n, _ in card.net.named_parameters()]
    worst, bad = 0.0, []
    for n, g, w in zip(names, got, want):
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= UNET_TOL + UNET_TOL * w.abs()).all()):
            bad.append(n)
    log(f"  f32 step gradients, card vs CPU: {len(names)} tensors, max "
        f"abs err {worst:.3e} (tol {UNET_TOL:g} abs + {UNET_TOL:g} rel) "
        f"{'ok' if not bad else 'FAIL ' + ', '.join(bad[:5])}")
    check(not bad, f"gradients disagree with the CPU: {bad[:5]}")
    bf = DDPM(dict(cfg, dropout=0.0), device=DEVICE, seed=SEED,
              trainable=True)
    bf.net.load_state_dict(card.net.state_dict())
    bf_loss, bf_grads = grads_of_step(bf, x.to(DEVICE), t.to(DEVICE),
                                      noise.to(DEVICE))
    check(bool(bf_loss.isfinite()) and all(bool(g.isfinite().all())
                                           for g in bf_grads),
          "bf16 autocast step is not finite")
    bf_diff = abs(float(bf_loss) - float(want_loss))
    log(f"  bf16 autocast step loss {float(bf_loss):.6f} vs f32 CPU "
        f"{float(want_loss):.6f}: |diff| {bf_diff:.3e}")
    return {"loss_f32_cpu": float(want_loss), "loss_err_f32": loss_err,
            "grad_max_abs_err_f32": worst, "loss_bf16": float(bf_loss),
            "loss_diff_bf16_vs_f32_cpu": bf_diff}


def hold_double_backward():
    """Phase 7b: second derivatives on the card. GroupNormSiLUFunction
    must raise when its backward (K2) is asked for a graph; MHAFunction's
    grad-of-grad of sum((MHA(q,k,v) + q³)²) (forward K3, backward
    autograd through mha_plain) must equal the same through mha_plain,
    f32 (TF32 off). The two differ only by K3's forward error (f32, about
    1e-6 relative), which reaches the loss linearly: held within 1e-4 of
    each result's largest magnitude, abs, plus the f32 TOL rel."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    x = torch.randn((2, 4, 4, 32), generator=gen,
                    device=DEVICE).requires_grad_()
    w = torch.ones(32, device=DEVICE)
    y = gn_ops.group_norm_silu(x, w, w * 0.1, 8)
    try:
        torch.autograd.grad(y.square().sum(), x, create_graph=True)
    except RuntimeError as e:
        check("second derivative" in str(e), f"unexpected error: {e}")
        log("  GroupNormSiLUFunction on CUDA refuses create_graph: ok")
    else:
        raise SmokeFailure("K2's backward accepted create_graph=True")
    (gx,) = torch.autograd.grad(
        gn_ops.group_norm_silu(x, w, w * 0.1, 8).square().sum(), x)
    check(bool(gx.isfinite().all()), "first-order GroupNorm gradient")
    before = attn_ops.MHA_KERNEL.launches
    qkv = mha_inputs((2, 4, 16, 64), torch.float32, gen)
    results = []
    for fn in (attn_ops.multi_head_attention, attn_ops.mha_plain):
        q, k, v = (t.detach().mul(0.5).requires_grad_() for t in qkv)
        loss = (fn(q, k, v) + q ** 3).square().sum()
        (gq,) = torch.autograd.grad(loss, q, create_graph=True)
        results.append([gq.detach(), *torch.autograd.grad(gq.sum(),
                                                          (q, k, v))])
    torch.cuda.synchronize()
    check(attn_ops.MHA_KERNEL.launches == before + 1,
          "MHAFunction's forward did not launch K3 once")
    errs = {}
    for name, got, want in zip(("dq", "d2q", "d2k", "d2v"), *results):
        errs[name] = hold(f"MHAFunction grad-of-grad {name}, f32 card vs "
                          f"mha_plain", got, want,
                          1e-4 * float(want.abs().max()), TOL["float32"])
    return errs


def run_cli(module: str, args, what: str, timeout: int = 900,
            env=None) -> str:
    """Run one of the port's CLIs as a subprocess (in ``env`` when
    given); fails on a non-zero exit. Returns its standard output."""
    cmd = [sys.executable, "-m", f"diffusion_model_universal_torch.scripts."
           f"{module}", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout, env=env)
    secs = time.perf_counter() - t0
    log(f"[cli] {what}: exit {out.returncode} in {secs:.1f} s")
    if out.returncode != 0:
        log(out.stdout[-4000:])
        log(out.stderr[-4000:])
    check(out.returncode == 0, f"{what} exited {out.returncode}")
    return out.stdout


def train_cli(steps_per_epoch: int):
    """Phase 8: the training CLI at full width (2 epochs), a resume from
    its latest checkpoint for a third epoch, and ``generate --ema``."""
    import numpy as np
    import yaml
    from diffusion_model_universal_torch.scripts.train import params_digest
    from diffusion_model_universal_torch.utils.checkpoint import read_state
    from diffusion_model_universal_torch.utils.images import decode_png
    tmp = Path(tempfile.mkdtemp(prefix="dmu_train_"))
    overrides = {"num_epochs": 2, "checkpoint_interval": 1,
                 "sample_interval": 2, "val_interval": steps_per_epoch}
    log(f"[cli] ddpm_config.yaml with data.dataset=synthetic, training "
        f"overrides {overrides}, output_dir under {tmp}")
    try:
        cfg_path = tmp / "train.yaml"
        cfg_path.write_text(yaml.safe_dump(train_config(str(tmp),
                                                        **overrides)))
        base = ["--config", str(cfg_path), "--model_type", "ddpm",
                "--seed", str(SEED)]
        out = run_cli("train", base, "train 2 epochs")
        launches = json.loads(out.split("Kernel launches: ")[1]
                              .splitlines()[0])
        ck = tmp / "out" / "checkpoints"
        for name in ("checkpoint_epoch_0", "checkpoint_epoch_1",
                     "best_model", "final_model"):
            check((ck / name / "state.pt").is_file(), f"no {name}")
        saved = read_state(str(ck / "checkpoint_epoch_1"))
        check(saved["step"] == 2 * steps_per_epoch and saved["epoch"] == 1,
              f"checkpoint_epoch_1 at step {saved['step']}")
        grid = decode_png((tmp / "out" / "samples" / "epoch_1.png")
                          .read_bytes())
        log(f"[cli] sample grid epoch_1.png {grid.shape}; checkpoints "
            f"{sorted(p.name for p in ck.iterdir())}; launches {launches}")
        cfg_path.write_text(yaml.safe_dump(train_config(
            str(tmp), **dict(overrides, num_epochs=3))))
        out = run_cli("train", base + ["--resume", "latest"],
                      "resume from latest for epoch 3")
        want = (f"Resumed from epoch 2 at step {2 * steps_per_epoch} "
                f"(params sha256 {params_digest(saved['params'].values())})")
        check(want in out, f"resume line missing: {want}")
        final = read_state(str(ck / "final_model"))
        check(final["step"] == 3 * steps_per_epoch,
              f"final_model at step {final['step']}")
        losses = [json.loads(line)["train/loss"] for line in
                  (tmp / "out" / "metrics.jsonl").read_text().splitlines()
                  if "train/loss" in line]
        check(len(losses) > 0 and all(math.isfinite(v) for v in losses),
              f"logged losses {losses}")
        log(f"[cli] resumed at epoch 2, step {2 * steps_per_epoch}, params "
            f"bit-equal to checkpoint_epoch_1; final_model at step "
            f"{final['step']}; {len(losses)} logged losses, all finite, "
            f"first {losses[0]:.4f} last {losses[-1]:.4f}")
        gen_dir = tmp / "gen"
        run_cli("generate", ["--config", str(cfg_path), "--model_type",
                             "ddpm", "--checkpoint", str(ck / "final_model"),
                             "--ema", "--num_samples", "4", "--output_dir",
                             str(gen_dir)], "generate --ema, 4 samples")
        grid = decode_png((gen_dir / "samples_grid.png").read_bytes())
        check(grid.shape == (2 * 34 + 2, 2 * 34 + 2, 3), f"grid {grid.shape}")
        check(all(np.isfinite(decode_png((gen_dir / f"sample_000{i}.png")
                                         .read_bytes())).all()
                  for i in range(4)), "sample PNGs")
        log(f"[cli] generate --ema: samples_grid.png {grid.shape} decodes")
        check(all(launches.get(s, 0) > 0 for s in (
            "dmu_group_norm_silu_fwd", "dmu_group_norm_silu_bwd",
            "dmu_mha_fwd")), f"a kernel never launched in training: "
                             f"{launches}")
        return {"launches": launches, "losses": [losses[0], losses[-1]]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_gn_bwd(bwd_calls, dtype_name="bfloat16"):
    """K2 per training shape: kernel, plain, library (autograd backward of
    F.group_norm + F.silu on the same inputs) and bound ms."""
    import torch
    import torch.nn.functional as F
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    dtype = getattr(torch, dtype_name)
    isz = torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    rows = []
    for key in sorted(bwd_calls):
        b, s, c, groups, has_tb, silu = key
        x, scale, bias, tb = gn_inputs(key, dtype, gen)
        dy = torch.randn(x.shape, generator=gen, device=DEVICE).to(dtype)
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wl = scale.to(dtype).requires_grad_()
        bl = bias.to(dtype).requires_grad_()
        ins = [xl, wl, bl]
        v = xl
        if has_tb:
            tbl = tb.to(dtype).requires_grad_()
            ins.append(tbl)
            v = xl + tbl[:, :, None, None]
        y = F.group_norm(v, groups, wl, bl, 1e-5)
        y = F.silu(y) if silu else y
        dyl = dy.permute(0, 3, 1, 2)
        args = (x, scale, bias, tb, dy, groups)
        ms = cuda_ms(lambda: gn_ops.group_norm_silu_bwd_cuda(
            *args, apply_silu=silu))
        plain = cuda_ms(lambda: gn_ops.group_norm_silu_bwd_plain(
            *args, apply_silu=silu))
        lib = cuda_ms(lambda: torch.autograd.grad(y, ins, dyl,
                                                  retain_graph=True))
        n = b * s * c
        # x and dy read, dx written; γ, β, tb read; dγ, dβ, dtb written.
        nbytes = 3 * n * isz + 4 * c * 4 + (2 * b * c * 4 if has_tb else 0)
        ops = n * (30 if silu else 20)
        bms, by = bound(nbytes, ops, dtype_name)
        rows.append({"shape": gn_label(key), "per_forward": bwd_calls[key],
                     "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": bms, "bound_by": by})
        log(f"[time] K2 {dtype_name} {gn_label(key)} ×{bwd_calls[key]}: "
            f"kernel {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, library "
            f"{lib * 1e3:.2f} us, bound {bms * 1e3:.2f} us ({by})")
    return rows


def time_training(trainer, batch, steps: int = 20, warmup: int = 5):
    """Phase 9: ms per training step at B=128 bf16 (host clock around
    ``steps`` steps that end in a synchronize), and the launches of those
    steps against LAUNCHES_PER_STEP."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    kernels = {"gn": gn_ops.GN_KERNEL, "gn_bwd": gn_ops.GN_BWD_KERNEL,
               "mha": attn_ops.MHA_KERNEL}
    for _ in range(warmup):
        trainer.step(batch)
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = trainer.step(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kernels.items()}
    want = {n: steps * c for n, c in LAUNCHES_PER_STEP.items()}
    check(launches == want, f"training launches {launches} != {steps} × "
                            f"per step {LAUNCHES_PER_STEP}")
    check(bool(metrics["loss"].isfinite()), "training loss not finite")
    b = batch.shape[0]
    out = {"steps": steps, "batch": b, "ms_per_step": secs / steps * 1e3,
           "images_per_s": b * steps / secs, "launches": launches,
           "last_loss": float(metrics["loss"])}
    log(f"[train] {steps} steps at B={b} bf16: {out['ms_per_step']:.2f} "
        f"ms/step, {out['images_per_s']:.1f} img/s; launches {launches} "
        f"= {steps} × {LAUNCHES_PER_STEP}")
    return out


# -- experiment kernels (phase 10) ------------------------------------------

#: The stride-1 3×3 conv shapes of bench.py:402-411, (H, Cin, Cout); the
#: first is the experiment CLIs' default bench shape.
EXP_CONV_SHAPES = [(32, 128, 128), (16, 128, 128), (8, 256, 256),
                   (16, 256, 128), (4, 256, 256), (2, 512, 512)]
#: The batch-packed edge shapes of tests/test_pallas_kernels.py:177, B=32.
EXP_EDGE_SHAPES = [(2, 32, 32), (4, 24, 16), (8, 16, 16)]
EXP_BATCH = 2048            # the experiment CLIs' bench batch
EXP_F32_BATCH = 16          # f32 holds: the arithmetic, at a short phase
EXP_HEAD = (32, 128)        # out-head / in-conv: 32², C=128
EXP_REPLACES = {
    "conv3x3": "scripts/exp_conv_kernel.py:72 (_kernel, tap9) and :156 "
               "(_kernel_k3, k3)",
    "gn_silu_conv3x3": "scripts/exp_conv_kernel.py:90",
    "out_head": "scripts/exp_boundary_kernel.py:54",
    "in_conv": "scripts/exp_boundary_kernel.py:114",
}
#: The kernels (launch-count names) each experiment CLI run must launch:
#: the conv CLI's bf16 shapes take K5's and K4's sm90 routes; the boundary
#: CLI's f32 --check takes K6's and K7's CUDA-core paths, its bf16 --bench
#: K6's sm90 route and K7's tensor-core path.
EXP_SYMBOLS = {
    ("exp_conv_kernel", "--check"): ("dmu_conv3x3_sm90_tap9",
                                     "dmu_conv3x3_sm90_k3",
                                     "dmu_gn_silu_conv3x3_sm90"),
    ("exp_conv_kernel", "--bench"): ("dmu_conv3x3_sm90_tap9",
                                     "dmu_conv3x3_sm90_k3",
                                     "dmu_gn_silu_conv3x3_sm90"),
    ("exp_boundary_kernel", "--check"): ("dmu_out_head[f32]", "dmu_in_conv"),
    ("exp_boundary_kernel", "--bench"): ("dmu_out_head_sm90",
                                         "dmu_in_conv_mma"),
}
#: K7's launch-count name by path.
IN_CONV_PATHS = {"bfloat16": "dmu_in_conv_mma", "float32": "dmu_in_conv"}


def conv_label(shape, batch) -> str:
    h, cin, cout = shape
    return f"B{batch} {h}² {cin}→{cout}"


def exp_conv_inputs(shape, batch, dtype, gen):
    """x [B, H, H, Cin] ~ N(0, 1) and w [3, 3, Cin, Cout] scaled so that
    the conv's outputs are ~ N(0, 1)."""
    import torch
    h, cin, cout = shape
    x = torch.randn((batch, h, h, cin), generator=gen, device=DEVICE)
    w = torch.randn((3, 3, cin, cout), generator=gen, device=DEVICE) * (
        1.0 / (9 * cin)) ** 0.5
    return x.to(dtype), w.to(dtype)


def exp_affine(batch, cin, dtype, gen):
    """K4's per-sample a, b [B, Cin]."""
    import torch
    a = torch.randn((batch, cin), generator=gen, device=DEVICE) * 0.3 + 1.0
    b = torch.randn((batch, cin), generator=gen, device=DEVICE) * 0.5
    return a.to(dtype), b.to(dtype)


def exp_in_conv_inputs(batch, dtype, gen):
    """K7's x3 [B, 32, 32, 3] and w3 [3, 3, 3, 128]."""
    import torch
    h, c = EXP_HEAD
    x3 = torch.randn((batch, h, h, 3), generator=gen, device=DEVICE)
    w3 = torch.randn((3, 3, 3, c), generator=gen, device=DEVICE) * (
        1.0 / 27) ** 0.5
    return x3.to(dtype), w3.to(dtype)


#: K6's calls held in phase 10a, (B, H, C, G, Cout, dtype, route) on
#: square images: the bench shape, MNIST's head (W=28 fills no m16 tile
#: evenly), heads with learn_sigma (Cout 2 and 6), a 1 MB sample, wide C,
#: G=16, B=1, bf16 shapes the sm90 route does not take, and every template
#: instance of both kernels (the sm90 kernel's n-tiles × m16 tiles a warp,
#: the CUDA-core kernel's Cout 1–7 in both dtypes).
#: tests/test_torch_out_head_plan.py checks the same routes and that every
#: instance is held, on the CPU.
K6_HOLDS = [
    (EXP_BATCH, 32, 128, 32, 3, "bfloat16", "sm90"),
    (EXP_F32_BATCH, 32, 128, 32, 3, "float32", "f32"),
    (256, 28, 64, 32, 1, "bfloat16", "sm90"),
    (EXP_F32_BATCH, 28, 64, 32, 1, "float32", "f32"),
    (16, 28, 64, 32, 2, "bfloat16", "sm90"),
    (256, 64, 128, 32, 3, "bfloat16", "sm90"),
    (64, 8, 512, 32, 3, "bfloat16", "sm90"),
    (4, 2, 2048, 32, 3, "bfloat16", "sm90"),
    (64, 32, 128, 16, 3, "bfloat16", "sm90"),
    (1, 32, 128, 32, 3, "bfloat16", "sm90"),
    (8, 32, 128, 32, 6, "bfloat16", "sm90"),
    (4, 16, 64, 32, 1, "bfloat16", "sm90"),    # Cout 1, one m16 tile a warp
    (8, 16, 96, 32, 3, "bfloat16", "simt"),    # C not a multiple of 64
    (4, 64, 256, 32, 3, "bfloat16", "simt"),   # no 8-block cluster holds it
    *[(2, 8, 96, 32, cout, dname, route) for cout in range(1, 8)
      for dname, route in (("bfloat16", "simt"), ("float32", "f32"))],
    # Heads wider than 7 outputs, in passes of at most 7.
    (64, 32, 128, 32, 8, "bfloat16", "sm90"),
    (64, 32, 128, 32, 16, "bfloat16", "sm90"),
    (16, 32, 128, 32, 12, "float32", "f32"),
    (2, 8, 96, 32, 9, "bfloat16", "simt"),
    # The f32 C whose weight the CUDA-core block cannot hold: two chunks
    # of C on group boundaries, summed in f32.
    (2, 4, 2048, 32, 3, "float32", "f32"),
    (2, 4, 1760, 32, 3, "float32", "f32"),
    # bf16 C over 2048 (and not a multiple of 64): chunks summed in an f32
    # output, every Cout instance of that path.
    *[(2, 4, 2080, 32, cout, "bfloat16", "simt") for cout in range(1, 8)],
    # A row wider than the CUDA-core block's ring: column tiles.
    (1, 700, 64, 32, 3, "float32", "f32"),
    # C not whole 16-byte vectors: element loads.
    (2, 8, 12, 4, 3, "bfloat16", "simt"),
    (2, 8, 12, 4, 5, "float32", "f32"),
]
#: K6's timed shapes (B, H, C, Cout), bf16, G=32: the sm90 route and the
#: CUDA-core kernel in turns.
K6_TIMES = [(EXP_BATCH, 32, 128, 3), (256, 64, 128, 3),
            (EXP_BATCH, 28, 64, 1), (EXP_BATCH, 32, 128, 8),
            (EXP_BATCH, 32, 128, 16)]


def k6_inputs(batch, h, c, cout, dtype, gen):
    """K6's x [B, H, H, C], scale, bias [C] (f32) and w [3, 3, C, Cout]
    scaled so that the outputs are ~ N(0, 1)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    x = (randn(batch, h, h, c) * 0.5 + 0.3).to(dtype)
    scale = randn(c) * 0.2 + 1.0
    bias = randn(c) * 0.1
    w = (randn(3, 3, c, cout) * (1.0 / (9 * c)) ** 0.5).to(dtype)
    return x, scale, bias, w


def k6_label(batch, h, c, g, cout) -> str:
    return f"B{batch} {h}² {c}→{cout} G{g}"


def k6_route_launches():
    """K6's launches so far in this process, by route."""
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    return {r: bc.OUT_HEAD_KERNELS[r].launches for r in bc.OUT_HEAD_ROUTES}


def hold_k6(x, scale, bias, w, groups, route, what, force=""):
    """K6 on x against its plain version within TOL; checks that the call
    launched the kernel of ``route`` as often as its plan has launches
    (a pass of at most 7 outputs each, times the chunks of C on the
    CUDA-core kernel) and no other (``force`` asks the wrapper for a
    route), and logs the route's plan once per shape. Returns max abs
    error."""
    import torch
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    dname = str(x.dtype).removeprefix("torch.")
    b, h, wd, c = x.shape
    if route == "sm90":
        plan = bc.out_head_launch_plan(b, h, wd, c, groups, w.shape[-1])
        n = len(plan.passes)
    else:
        plan = bc.out_head_simt_plan(h, wd, c, groups, w.shape[-1])
        n = plan.launches
    if (x.shape, plan) not in LOGGED_PLANS:
        LOGGED_PLANS.add((x.shape, plan))
        log(f"  K6 {dname} {what} {route} plan: {plan.describe()}")
    before = k6_route_launches()
    got = bc.out_head_cuda(x, scale, bias, w, groups, route=force)
    want = bc.out_head_plain(x, scale, bias, w, groups)
    torch.cuda.synchronize()
    after = k6_route_launches()
    check(all(after[r] - before[r] == (n if r == route else 0)
              for r in after),
          f"K6 {what}: launches by route moved {before} -> {after}, "
          f"expected {n} {route} launch(es)")
    return hold(f"K6 {dname} {what} ({route})", got, want, TOL[dname])


def k5_route_launches():
    """K5's launches so far in this process, by route (both K orders)."""
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    return {r: sum(cv.CONV3X3_KERNELS[r, v].launches for v in cv.VARIANTS)
            for r in cv.ROUTES}


def hold_k5(x, w, variant, route, what):
    """K5 on x, w in one K order against its plain version within TOL;
    checks that the call launched the kernel of ``route`` once and no
    other. Returns max abs error."""
    import torch
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    before = k5_route_launches()
    got = cv.conv3x3_cuda(x, w, variant)
    want = cv.conv3x3_plain(x, w, variant)
    torch.cuda.synchronize()
    after = k5_route_launches()
    check(all(after[r] - before[r] == (r == route) for r in cv.ROUTES),
          f"K5 {what}: launches by route moved {before} -> {after}, "
          f"expected one {route} launch")
    dname = str(x.dtype).removeprefix("torch.")
    return hold(f"K5 {dname} {what} ({route})", got, want, TOL[dname])


def k4_route_launches():
    """K4's launches so far in this process, by route."""
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    return {r: cv.GN_SILU_CONV3X3_KERNELS[r].launches for r in cv.ROUTES}


def hold_k4(x, a, b, w, route, what):
    """K4 on x, a, b, w against its plain version within TOL; checks that
    the call launched the kernel of ``route`` once and no other. Returns
    max abs error."""
    import torch
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    before = k4_route_launches()
    got = cv.gn_silu_conv3x3_cuda(x, a, b, w)
    want = cv.gn_silu_conv3x3_plain(x, a, b, w)
    torch.cuda.synchronize()
    after = k4_route_launches()
    check(all(after[r] - before[r] == (r == route) for r in cv.ROUTES),
          f"K4 {what}: launches by route moved {before} -> {after}, "
          f"expected one {route} launch")
    dname = str(x.dtype).removeprefix("torch.")
    return hold(f"K4 {dname} {what} ({route})", got, want, TOL[dname])


#: A K4 shape that stays on the WMMA kernel (four images a 256-pixel
#: tile), held at this batch.
K4_WMMA_SHAPE, K4_WMMA_BATCH = (8, 256, 256), 256


def hold_exp_kernels():
    """Phase 10a: K5 in both K orders at the six bench.py shapes (bf16 at
    B=2048 on the sm90 route, f32 at B=16 on the CUDA cores) and the three
    edge shapes (B=32, both dtypes; bf16 on the WMMA route); K4 and K7 at
    32², C=128 in both dtypes; K6 at ``K6_HOLDS`` on each of its routes
    (and its CUDA-core kernel asked for at 64²·128→3); each kernel on the
    inputs the experiment CLIs' ``--check`` builds (K4, K5 at B=4, 16²,
    128→128 bf16; K6, K7 at B=4, 16², C=128 f32, K6 also in bf16); and K4
    at K4_WMMA_SHAPE. Each against its plain version within TOL, and each
    K4–K7 call checked to have launched the route or path its shapes and
    dtype call for. Returns max abs errors by kernel, keyed by (case,
    dtype), and the launches of this phase by name."""
    import torch
    from diffusion_model_universal_torch.ops import _build
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    from diffusion_model_universal_torch.scripts import exp_boundary_kernel
    from diffusion_model_universal_torch.scripts import exp_conv_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    errs = {name: {} for name in EXP_REPLACES}
    start = _build.launch_counts()
    cases = ([(s, EXP_BATCH, "bfloat16", "sm90") for s in EXP_CONV_SHAPES]
             + [(s, EXP_F32_BATCH, "float32", "f32") for s in EXP_CONV_SHAPES]
             + [(s, 32, d, r) for s in EXP_EDGE_SHAPES
                for d, r in (("float32", "f32"), ("bfloat16", "wmma"))])
    for shape, batch, dname, route in cases:
        x, w = exp_conv_inputs(shape, batch, getattr(torch, dname), gen)
        for variant in cv.VARIANTS:
            label = f"{variant} {conv_label(shape, batch)}"
            errs["conv3x3"][(label, dname)] = hold_k5(x, w, variant, route,
                                                      label)
        del x, w
    for dname, batch in (("bfloat16", EXP_BATCH), ("float32",
                                                    EXP_F32_BATCH)):
        dtype = getattr(torch, dname)
        shape = EXP_CONV_SHAPES[0]
        x, w = exp_conv_inputs(shape, batch, dtype, gen)
        a, b = exp_affine(batch, shape[1], dtype, gen)
        label = conv_label(shape, batch)
        errs["gn_silu_conv3x3"][(label, dname)] = hold_k4(
            x, a, b, w, "sm90" if dname == "bfloat16" else "f32", label)
        x3, w3 = exp_in_conv_inputs(batch, dtype, gen)
        path = _build.KERNELS[IN_CONV_PATHS[dname]]
        before = path.launches
        got, want = bc.in_conv_cuda(x3, w3), bc.in_conv_plain(x3, w3)
        torch.cuda.synchronize()
        check(path.launches == before + 1,
              f"K7 {dname} did not launch {path.name}")
        label = f"B{batch} 32² 3→128"
        errs["in_conv"][(label, dname)] = hold(
            f"K7 {dname} {label}", got, want, TOL[dname])
        del x, w, a, b, got, want, x3, w3
    for batch, h, c, g, cout, dname, route in K6_HOLDS:
        x, scale, bias, w = k6_inputs(batch, h, c, cout,
                                      getattr(torch, dname), gen)
        label = k6_label(batch, h, c, g, cout)
        errs["out_head"][(label, dname)] = hold_k6(x, scale, bias, w, g,
                                                   route, label)
        if (batch, h, c, cout) == (256, 64, 128, 3):
            label += " (the CUDA-core kernel, asked for)"
            errs["out_head"][(label, dname)] = hold_k6(
                x, scale, bias, w, g, "simt", label, force="simt")
        del x, w
    x, w, a, b = exp_conv_kernel.check_inputs(DEVICE)
    dname = str(x.dtype).removeprefix("torch.")
    label = (f"{conv_label(exp_conv_kernel.CHECK_SHAPE, x.shape[0])} "
             "(CLI check)")
    for variant in cv.VARIANTS:
        errs["conv3x3"][(f"{variant} {label}", dname)] = hold_k5(
            x, w, variant, "sm90", f"{variant} {label}")
    errs["gn_silu_conv3x3"][(label, dname)] = hold_k4(x, a, b, w, "sm90",
                                                      label)
    x, w = exp_conv_inputs(K4_WMMA_SHAPE, K4_WMMA_BATCH, torch.bfloat16, gen)
    a, b = exp_affine(K4_WMMA_BATCH, K4_WMMA_SHAPE[1], torch.bfloat16, gen)
    label = conv_label(K4_WMMA_SHAPE, K4_WMMA_BATCH)
    errs["gn_silu_conv3x3"][(label, "bfloat16")] = hold_k4(x, a, b, w, "wmma",
                                                           label)
    x, w, scale, bias, x3, w3 = exp_boundary_kernel.check_inputs(DEVICE)
    dname = str(x.dtype).removeprefix("torch.")
    b, h, _, c = x.shape
    label = f"{k6_label(b, h, c, 32, 3)} (CLI check)"
    errs["out_head"][(label, dname)] = hold_k6(x, scale, bias, w, 32, "f32",
                                               label)
    errs["out_head"][(label, "bfloat16")] = hold_k6(
        x.bfloat16(), scale, bias, w.bfloat16(), 32, "sm90", label)
    got, want = bc.in_conv_cuda(x3, w3), bc.in_conv_plain(x3, w3)
    torch.cuda.synchronize()
    label = f"B{b} {h}² 3→{c} (CLI check)"
    errs["in_conv"][(label, dname)] = hold(f"K7 {dname} {label}", got, want,
                                           TOL[dname])
    end = _build.launch_counts()
    moved = {k: end[k] - start.get(k, 0) for k in end
             if end[k] != start.get(k, 0)}
    log(f"  launches of phase 10a: {json.dumps(moved)}")
    return errs, moved


def exp_refusals():
    """Phase 10b: shapes the experiment kernels' wrappers must refuse."""
    import torch
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    z = dict(device=DEVICE, dtype=torch.bfloat16)
    x12, w12 = torch.zeros((2, 4, 4, 12), **z), torch.zeros((3, 3, 12, 16),
                                                            **z)
    a12 = torch.zeros((2, 12), **z)
    xh, s = torch.zeros((2, 4, 4, 64), **z), torch.ones(64, device=DEVICE)
    x3 = torch.zeros((2, 4, 4, 3), **z)
    x32, w32 = torch.zeros((2, 2, 2, 32), **z), torch.zeros((3, 3, 32, 32),
                                                            **z)
    a32 = torch.zeros((2, 32), **z)
    for what, call in [
            ("Cin=12 (K5)", lambda: cv.conv3x3_cuda(x12, w12)),
            ("the sm90 route for 2², 32→32 (K5)", lambda: cv.conv3x3_cuda(
                x32, w32, route="sm90")),
            ("Cin=12 (K4)", lambda: cv.gn_silu_conv3x3_cuda(x12, a12, a12,
                                                            w12)),
            ("the sm90 route for 2², 32→32 (K4)", lambda:
             cv.gn_silu_conv3x3_cuda(x32, a32, a32, w32, route="sm90")),
            ("Cout=0 out head (K6)", lambda: bc.out_head_cuda(
                xh, s, s, torch.zeros((3, 3, 64, 0), **z))),
            ("C not a multiple of num_groups (K6)", lambda:
             bc.out_head_cuda(xh, s, s, torch.zeros((3, 3, 64, 3), **z),
                              num_groups=24)),
            ("the sm90 route for f32 (K6)", lambda: bc.out_head_cuda(
                xh.float(), s, s, torch.zeros((3, 3, 64, 3), device=DEVICE),
                route="sm90")),
            ("Cout=12 (K7)", lambda: bc.in_conv_cuda(
                x3, torch.zeros((3, 3, 3, 12), **z)))]:
        try:
            call()
        except ValueError:
            log(f"  refuses {what}: ok")
        else:
            raise SmokeFailure(f"a wrapper accepted {what}")


def pullback_tol(n_terms: int, rms_factor: float) -> float:
    """Absolute tolerance of a value that sums ``n_terms`` products of a
    factor (root mean square ``rms_factor``) with a function of a conv's
    output y, when y is held within TOL of its reference: each term then
    moves by about TOL·factor (tanh and its derivatives change by at most
    1.0× and 0.77× the change in y), and n such moves of either sign add
    like sqrt(n)."""
    return TOL["float32"] * math.sqrt(n_terms) * rms_factor


def hold_conv_function():
    """Phase 10c: Conv3x3Function (forward K5, backward the F.conv2d
    twin's) against autograd through conv3x3_conv2d, f32 (TF32 off), on
    the reference test's loss, sum(tanh(conv(x, w))), so that K5's forward
    error reaches the gradients through tanh' as it does there. y within
    TOL; the loss, dx (9·Cout terms of w) and dw (B·H·W terms of x) within
    :func:`pullback_tol` abs + the f32 TOL rel."""
    import torch
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    x, w = exp_conv_inputs((16, 128, 128), EXP_F32_BATCH, torch.float32,
                           gen)
    before = cv.CONV3X3_KERNELS["f32", "tap9"].launches
    outs = []
    for fn in (cv.Conv3x3Function.apply, cv.conv3x3_conv2d):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xg, wg)
        loss = torch.tanh(y).sum()
        outs.append((y.detach(), loss.detach(),
                     *torch.autograd.grad(loss, (xg, wg))))
    torch.cuda.synchronize()
    check(cv.CONV3X3_KERNELS["f32", "tap9"].launches == before + 1,
          "Conv3x3Function's forward did not launch K5's f32 kernel once")
    b, h, _, _ = x.shape
    n_out, cout = outs[0][0].numel(), w.shape[3]
    rms = {"x": float(x.pow(2).mean().sqrt()),
           "w": float(w.pow(2).mean().sqrt())}
    tol = TOL["float32"]
    atol = {"y": tol, "loss": pullback_tol(n_out, 1.0),
            "dx": pullback_tol(9 * cout, rms["w"]),
            "dw": pullback_tol(b * h * h, rms["x"])}
    return {name: hold(f"Conv3x3Function {name}, B{b} {h}² 128→128 f32", a,
                       r, atol[name], tol)
            for name, a, r in zip(atol, *outs)}


def exp_clis():
    """Phase 10d: each experiment CLI's --check, then --bench at its default
    shape, as subprocesses; each run's own launch counters (they start at 0
    in the subprocess) must show every kernel of that CLI. Returns the
    launches summed over the four runs, by C symbol, and the bench lines."""
    launches, lines = {}, []
    for (module, mode), symbols in EXP_SYMBOLS.items():
        out = run_cli(module, [mode], f"{module} {mode}", timeout=600)
        got = json.loads(out.split("Kernel launches: ")[1].splitlines()[0])
        check(all(got.get(s, 0) > 0 for s in symbols),
              f"{module} {mode} launched {got}")
        if mode == "--check":
            check("parity OK" in out, f"{module} --check: no parity OK")
        for line in out.splitlines():
            if not line.startswith("Kernel launches"):
                lines.append(f"{module} {mode}: {line}")
                log(f"  {line}")
        log(f"  launches {json.dumps({k: n for k, n in got.items() if n})}")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    return launches, lines


def time_exp_kernels():
    """Phase 10e: each experiment kernel at its bench shape in bf16 (B=2048;
    K5 at all six bench.py shapes, both K orders; K6 also at the other
    ``K6_TIMES``): kernel, plain, library and bound ms. The library call is
    F.conv2d on channels-last views with the weight laid out once
    beforehand; for K4 the affine and SiLU first, for K6 F.group_norm and
    F.silu first. K5 and K4 are timed in turns with their earlier WMMA
    kernel on the same inputs, K6 with its CUDA-core kernel (earlier, new,
    new, earlier; each time the mean of its two runs), their ``ms``
    including the weight copy their wrapper makes; K4's row also carries
    K5's time on the same conv."""
    import torch
    import torch.nn.functional as F
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    b = EXP_BATCH

    def lay(w):   # HWIO -> OIHW with channels-last memory
        return w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

    def row(label, ms, plain, lib, nbytes, ops, **extra):
        bms, by = bound(nbytes, ops, "bfloat16")
        log(f"[time] {label}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.2f} us, library {lib * 1e3:.2f} us, bound "
            f"{bms * 1e3:.2f} us ({by})")
        return {"shape": label, "ms": ms, "plain_ms": plain,
                "library_ms": lib, "bound_ms": bms, "bound_by": by, **extra}

    rows = {name: [] for name in EXP_REPLACES}
    for shape in EXP_CONV_SHAPES:
        h, cin, cout = shape
        x, w = exp_conv_inputs(shape, b, bf16, gen)
        xl, wl = x.permute(0, 3, 1, 2), lay(w)
        lib = cuda_ms(lambda: F.conv2d(xl, wl, padding=1), iters=10, reps=3)
        nbytes = 2 * (b * h * h * (cin + cout) + 9 * cin * cout)
        ops = 2 * b * h * h * 9 * cin * cout
        for variant in cv.VARIANTS:
            turns = {"wmma": [], "sm90": []}
            for route in ("wmma", "sm90", "sm90", "wmma"):
                turns[route].append(cuda_ms(
                    lambda: cv.conv3x3_cuda(x, w, variant, route=route),
                    iters=10, reps=3))
            ms, earlier = (statistics.mean(turns[r]) for r in ("sm90",
                                                                "wmma"))
            plain = cuda_ms(lambda: cv.conv3x3_plain(x, w, variant), iters=3,
                            reps=3)
            rows["conv3x3"].append(row(
                f"K5 {variant} {conv_label(shape, b)}", ms, plain, lib,
                nbytes, ops, variant=variant, earlier_ms=earlier,
                earlier_runs_ms=turns["wmma"], runs_ms=turns["sm90"],
                tflops=ops / ms / 1e9, earlier_tflops=ops / earlier / 1e9,
                library_tflops=ops / lib / 1e9))
            log(f"  earlier (WMMA) {earlier * 1e3:.2f} us; "
                f"{ops / ms / 1e9:.1f} TFLOP/s against "
                f"{ops / earlier / 1e9:.1f} and F.conv2d "
                f"{ops / lib / 1e9:.1f}")
        if shape == EXP_CONV_SHAPES[0]:
            a, bb = exp_affine(b, cin, bf16, gen)

            def unit():
                return F.conv2d(cv._affine_silu(x, a, bb).permute(0, 3, 1, 2),
                                wl, padding=1)

            turns = {"wmma": [], "sm90": []}
            for route in ("wmma", "sm90", "sm90", "wmma"):
                turns[route].append(cuda_ms(
                    lambda: cv.gn_silu_conv3x3_cuda(x, a, bb, w,
                                                    route=route),
                    iters=10, reps=3))
            ms, earlier = (statistics.mean(turns[r]) for r in ("sm90",
                                                                "wmma"))
            k5 = next(r["ms"] for r in rows["conv3x3"]
                      if r["variant"] == "tap9")
            rows["gn_silu_conv3x3"].append(row(
                f"K4 {conv_label(shape, b)}", ms,
                cuda_ms(lambda: cv.gn_silu_conv3x3_plain(x, a, bb, w),
                        iters=3, reps=3),
                cuda_ms(unit, iters=10, reps=3),
                nbytes + 2 * 2 * b * cin, ops + 5 * b * h * h * cin,
                earlier_ms=earlier, earlier_runs_ms=turns["wmma"],
                runs_ms=turns["sm90"], k5_ms=k5, k4_over_k5=ms / k5,
                tflops=ops / ms / 1e9))
            log(f"  earlier (WMMA) {earlier * 1e3:.2f} us; K5 on the same "
                f"conv {k5 * 1e3:.2f} us ({ms / k5:.3f}×); "
                f"{ops / ms / 1e9:.1f} TFLOP/s")
        del x, w, xl, wl
    for batch, h, c, cout in K6_TIMES:
        x, scale, bias, w = k6_inputs(batch, h, c, cout, bf16, gen)
        xl, wl, sl, bl = x.permute(0, 3, 1, 2), lay(w), scale.to(bf16), \
            bias.to(bf16)

        def head_unit():
            return F.conv2d(F.silu(F.group_norm(xl, 32, sl, bl, 1e-5)), wl,
                            padding=1)

        turns = {"simt": [], "sm90": []}
        for route in ("simt", "sm90", "sm90", "simt"):
            turns[route].append(cuda_ms(
                lambda: bc.out_head_cuda(x, scale, bias, w, route=route),
                iters=20, reps=3))
        ms, earlier = (statistics.mean(turns[r]) for r in ("sm90", "simt"))
        rows["out_head"].append(row(
            f"K6 {k6_label(batch, h, c, 32, cout)}", ms,
            cuda_ms(lambda: bc.out_head_plain(x, scale, bias, w), iters=3,
                    reps=3),
            cuda_ms(head_unit, iters=20, reps=3),
            2 * batch * h * h * (c + cout) + 2 * 9 * c * cout + 8 * c,
            2 * batch * h * h * 9 * c * cout + 10 * batch * h * h * c,
            earlier_ms=earlier, earlier_runs_ms=turns["simt"],
            runs_ms=turns["sm90"]))
        log(f"  earlier (CUDA-core kernel) {earlier * 1e3:.2f} us "
            f"({earlier / ms:.2f}× the sm90 route)")
        del x, w, xl, wl
    x3, w3 = exp_in_conv_inputs(b, bf16, gen)
    h, c = EXP_HEAD
    x3l, w3l = x3.permute(0, 3, 1, 2), lay(w3)
    in_bytes = 2 * (b * h * h * (3 + c) + 27 * c)
    ms = cuda_ms(lambda: bc.in_conv_cuda(x3, w3), iters=20, reps=3)
    rows["in_conv"].append(row(
        f"K7 B{b} 32² 3→128", ms,
        cuda_ms(lambda: bc.in_conv_plain(x3, w3), iters=3, reps=3),
        cuda_ms(lambda: F.conv2d(x3l, w3l, padding=1), iters=20, reps=3),
        in_bytes, 2 * b * h * h * 27 * c, gbps=in_bytes / ms / 1e6))
    log(f"  K7 moves {in_bytes / ms / 1e6:.1f} GB/s")
    return rows


def exp_entry(name, kernel, rows, launches, errs, work, **extra):
    """One kernels-line entry of phase 10: the numbers of ``rows[0]``, the
    kernel at the experiment CLI's default bench shape."""
    main = rows[0]
    return {
        "name": name, "route": "cuda",
        "source": f"diffusion_model_universal_torch/csrc/{kernel.source}.cu",
        "replaces": EXP_REPLACES[name], "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": max(v for (_, d), v in errs.items()
                               if d == "float32"),
        "max_abs_err_bf16": max(v for (_, d), v in errs.items()
                                if d == "bfloat16"),
        "tol": TOL, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "work": work, "shapes": rows,
        **extra,
    }


def experiment_kernels():
    """Phase 10: K4–K7 against their plain versions, refusals, the
    differentiable conv, both experiment CLIs, and timings. Returns the
    four kernels-line entries and a summary."""
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    from diffusion_model_universal_torch.ops import conv3x3 as cv
    t0 = time.perf_counter()
    log("[hold] K4–K7 against their plain versions:")
    errs, hold_launches = hold_exp_kernels()
    exp_refusals()
    grad_errs = hold_conv_function()
    log("[cli] experiment CLIs:")
    launches, lines = exp_clis()
    rows = time_exp_kernels()
    conv_work = (f"one conv at B={EXP_BATCH}, 32², 128→128, bf16 (the "
                 "experiment CLI's bench shape)")
    by_route = {r: sum(launches.get(cv.CONV3X3_KERNELS[r, v].name, 0)
                       for v in cv.VARIANTS) for r in cv.ROUTES}
    by_variant = {v: launches[cv.CONV3X3_KERNELS["sm90", v].name]
                  for v in cv.VARIANTS}
    hold_by_route = {r: sum(hold_launches.get(cv.CONV3X3_KERNELS[r, v].name,
                                              0) for v in cv.VARIANTS)
                     for r in cv.ROUTES}
    k3_main = next(r for r in rows["conv3x3"] if r["variant"] == "k3")
    k4_by_route = {r: launches.get(cv.GN_SILU_CONV3X3_KERNELS[r].name, 0)
                   for r in cv.ROUTES}
    in_paths = {d: launches.get(k, 0) for d, k in IN_CONV_PATHS.items()}
    k6_by_route = {r: launches.get(bc.OUT_HEAD_KERNELS[r].name, 0)
                   for r in bc.OUT_HEAD_ROUTES}
    entries = [
        exp_entry("conv3x3", cv.CONV3X3_KERNELS["sm90", "tap9"],
                  rows["conv3x3"], sum(by_route.values()), errs["conv3x3"],
                  conv_work + "; ms etc. of the tap9 order on the sm90 "
                  "route, with its K-major weight copy",
                  conv_route="sm90 (TMA + wgmma), "
                             "csrc/conv3x3_sm90.cu",
                  earlier_ms=rows["conv3x3"][0]["earlier_ms"],
                  earlier="the WMMA kernel of csrc/conv3x3.cu, timed in "
                          "turns in this run; still the route for other "
                          "bf16 shapes",
                  launches_by_route=by_route,
                  launches_by_variant=by_variant,
                  hold_launches_by_route=hold_by_route,
                  k3={k: k3_main[k] for k in ("ms", "earlier_ms", "plain_ms",
                                              "library_ms", "bound_ms",
                                              "bound_by")},
                  library="F.conv2d", grad_max_abs_err_f32=grad_errs),
        exp_entry("gn_silu_conv3x3", cv.GN_SILU_CONV3X3_KERNELS["sm90"],
                  rows["gn_silu_conv3x3"], sum(k4_by_route.values()),
                  errs["gn_silu_conv3x3"], conv_work + "; ms etc. on the sm90 "
                  "route, with its K-major weight copy",
                  conv_route="sm90 (TMA + wgmma, x activated once into a "
                             "haloed tile), csrc/conv3x3_sm90.cu",
                  earlier_ms=rows["gn_silu_conv3x3"][0]["earlier_ms"],
                  earlier="the WMMA kernel of csrc/conv3x3.cu, timed in "
                          "turns in this run; still the route for other "
                          "bf16 shapes",
                  k5_ms=rows["gn_silu_conv3x3"][0]["k5_ms"],
                  launches_by_route=k4_by_route,
                  hold_launches_by_route={
                      r: hold_launches.get(
                          cv.GN_SILU_CONV3X3_KERNELS[r].name, 0)
                      for r in cv.ROUTES},
                  library="affine + SiLU, then F.conv2d"),
        exp_entry("out_head", bc.OUT_HEAD_KERNELS["sm90"], rows["out_head"],
                  sum(k6_by_route.values()), errs["out_head"],
                  f"the out-head unit at B={EXP_BATCH}, 32², C=128 → 3, "
                  "bf16; ms etc. on the sm90 route, with its packed weight "
                  "copy",
                  conv_route="sm90 (a cluster reads x once; the 9 taps × "
                             "Cout as the columns of an mma.sync product), "
                             "csrc/out_head_sm90.cu; simt and f32 (the "
                             "CUDA-core kernel), csrc/boundary_conv.cu",
                  earlier_ms=rows["out_head"][0]["earlier_ms"],
                  earlier="the CUDA-core kernel of csrc/boundary_conv.cu, "
                          "timed in turns in this run; still the route for "
                          "f32 and other bf16 shapes",
                  launches_by_route=k6_by_route,
                  hold_launches_by_route={
                      r: hold_launches.get(bc.OUT_HEAD_KERNELS[r].name, 0)
                      for r in bc.OUT_HEAD_ROUTES},
                  library="F.group_norm + F.silu + F.conv2d"),
        exp_entry("in_conv", bc.IN_CONV_MMA_KERNEL, rows["in_conv"],
                  sum(in_paths.values()), errs["in_conv"],
                  f"the in-conv at B={EXP_BATCH}, 32², 3 → 128, bf16, on "
                  "the tensor-core path",
                  conv_route="bf16: mma.sync m16n8k16 on the tensor cores; "
                             "f32: the CUDA cores",
                  earlier_ms=None,
                  earlier="the CUDA-core bf16 kernel this path replaced is "
                          "gone from the source; PERF.md keeps its time",
                  launches_by_path=in_paths,
                  hold_launches_by_path={d: hold_launches.get(k, 0) for d, k
                                         in IN_CONV_PATHS.items()},
                  library="F.conv2d"),
    ]
    secs = time.perf_counter() - t0
    log(f"[phase 10] experiment kernels: {secs:.1f} s")
    return entries, {"seconds": secs, "cli_launches": launches,
                     "cli_lines": lines}


# -- the samplers (phase 11) ------------------------------------------------

DDIM_CONFIG = (REPO / "diffusion_model_universal_torch" / "configs"
               / "ddim_config.yaml")
#: Phase 11b's requests: (model, request fields, UNet forwards a request).
#: A request launches K1 and K3 53× and 5× its forwards (CFG's two a step
#: are counted): DDIM-50 50, DPM++-20 19, Heun-18 2·17, strided-100 100.
SERVE_CASES = [
    ("ddim", {}, 50),
    ("ddim", {"sampler": "dpm++", "sampler_steps": 20}, 19),
    ("ddim", {"sampler": "heun", "sampler_steps": 18}, 34),
    ("ddim", {"sampler": "strided", "sampler_steps": 100}, 100),
    ("conditional", {"class_id": 3, "guidance_scale": 3.0}, 100),
    ("conditional", {"class_id": 3, "guidance_scale": 3.0,
                     "sampler": "dpm++", "sampler_steps": 20}, 38),
    ("learned", {"sampler": "strided", "sampler_steps": 100}, 100),
]
#: Each model's config and --model_type: ddim_config.yaml, the same with
#: num_classes: 10, and ddpm_config.yaml with learn_sigma: true.
SAMPLER_MODELS = {"ddim": (DDIM_CONFIG, "ddim", {}),
                  "conditional": (DDIM_CONFIG, "ddim", {"num_classes": 10}),
                  "learned": (CONFIG, "ddpm", {"learn_sigma": True})}


def sampler_config(variant: str, **extra):
    from diffusion_model_universal_torch.utils.config import (
        canonicalize_model_config, load_config, resolve_interpolations)
    path, _, keys = SAMPLER_MODELS[variant]
    cfg = canonicalize_model_config(
        resolve_interpolations(load_config(str(path)))["model_config"])
    return dict(cfg, **keys, **extra)


def seeded_model(variant: str, device, state=None, trainable=False,
                 **extra):
    """The variant's model on ``device`` from seeded weights (the
    zero-initialized leaves given small seeded values), or holding
    ``state``; ``extra`` overrides config keys."""
    import torch
    from diffusion_model_universal_torch.models import MODEL_REGISTRY
    cls = MODEL_REGISTRY[SAMPLER_MODELS[variant][1]]
    model = cls(sampler_config(variant, **extra), device=device, seed=SEED,
                trainable=trainable)
    with torch.no_grad():
        if state is not None:
            model.net.load_state_dict(state)
        else:
            gen = torch.Generator().manual_seed(SEED + 1)
            for p in model.net.parameters():
                if not p.any():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def card_and_cpu(variant: str, **extra):
    """The variant in f32 on the card and the same weights on the CPU."""
    card = seeded_model(variant, DEVICE, compute_dtype="float32", **extra)
    state = {k: v.cpu() for k, v in card.net.state_dict().items()}
    return card, seeded_model(variant, "cpu", state,
                              compute_dtype="float32", **extra)


def hold_samplers():
    """Phase 11a: each new sampler on the card against the same sampler on
    the CPU (the plain versions there), f32, B=2, full width, the same x_T
    and injected draws: each network call at the card's input, then the
    samples on the same network outputs; within UNET_TOL."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    gen = torch.Generator().manual_seed(SEED + 21)
    shape = (2, 32, 32, 3)

    def draws(n):
        return [torch.randn(shape, generator=gen) for _ in range(n)]

    def on(device, tensors):
        return [t.to(device) for t in tensors]

    errs = {}

    def pair(name, run, card, cpu, noise, **kw):
        """run(model, noise=..., **kw) on the card (kw tensors moved),
        then on the CPU with each network call evaluated at the card's
        input, held against the card's output within UNET_TOL, and the
        card's output passed on; then the two samples within UNET_TOL.

        Two independent trajectories are not compared: a 3- or 4-step
        sampler from t = 999 divides ε̂ by √ᾱ ≈ 0.006 in x̂₀, which lifts
        the network's f32 rounding, card against CPU, to the order of the
        bound (CFG 3.0 through DPM++ S=4 read 1.17e-3 to 1.58e-3 over four
        runs of the same code)."""
        calls = []
        net_card, net_cpu = card.apply, cpu.apply

        def recorded(x, t, y=None, train=False):
            out = net_card(x, t, y, train)
            calls.append((x.cpu(), t.cpu(), None if y is None else y.cpu(),
                          out.cpu()))
            return out

        replay, worst = iter(calls), []

        def replayed(x, t, y=None, train=False):
            xc, tc, yc, out = next(replay)
            check(torch.equal(t, tc) and (y is None) == (yc is None),
                  f"{name}: the CPU run called the network at another step")
            worst.append(hold_quiet(out, net_cpu(xc, tc, yc, train)))
            return out

        card.apply, cpu.apply = recorded, replayed
        try:
            with torch.inference_mode():
                got = run(card, noise=on(DEVICE, noise),
                          **{k: v.to(DEVICE) if torch.is_tensor(v) else v
                             for k, v in kw.items()})
                torch.cuda.synchronize()
                want = run(cpu, noise=noise, **kw)
        finally:
            del card.apply, cpu.apply
        check(calls and next(replay, None) is None,
              f"{name}: the two runs called the network unequally")
        log(f"  {name}: {len(calls)} network calls at the card's inputs, "
            f"card vs CPU: max abs err {max(worst):.3e} ok")
        errs[name] = {"network": max(worst), "samples": hold(
            f"{name}, card vs CPU on the card's network outputs", got.cpu(),
            want, UNET_TOL)}

    for eta in (0.0, 0.5):
        card, cpu = card_and_cpu("ddim", ddim_sampling_steps=4, eta=eta)
        pair(f"DDIM S=4 eta={eta}",
             lambda m, **k: m.generate_samples(2, **k), card, cpu,
             draws(5 if eta else 1))
    pair("DPM++ S=4", lambda m, **k: m.generate_samples_dpm(2, 4, **k),
         card, cpu, draws(1))
    pair("Heun S=3", lambda m, **k: m.generate_samples_heun(2, 3, **k),
         card, cpu, draws(1))
    pair("strided S=4",
         lambda m, **k: m.generate_samples_strided(2, 4, **k), card, cpu,
         draws(5))
    del card, cpu
    card, cpu = card_and_cpu("conditional", ddim_sampling_steps=4)
    y = torch.tensor([3, 7])
    pair("CFG 3.0 DDIM S=4",
         lambda m, y, **k: m.generate_samples_cfg(2, y, 3.0, **k), card,
         cpu, draws(1), y=y)
    pair("CFG 3.0 DPM++ S=4",
         lambda m, y, **k: m.generate_samples_dpm(
             2, 4, labels=y, guidance_scale=3.0, **k), card, cpu, draws(1),
         y=y)
    del card, cpu
    # Inpainting at num_timesteps: 10 (a cut: ten steps of the same net).
    card, cpu = card_and_cpu("ddim", num_timesteps=10)
    image = (torch.rand(shape, generator=gen) * 2 - 1)
    mask = torch.zeros((1, 32, 32, 1))
    mask[:, :, :16] = 1.0
    pair("inpainting T=10",
         lambda m, image, mask, **k: m.generate_samples_inpaint(
             image, mask, **k), card, cpu, draws(21), image=image, mask=mask)
    del card, cpu
    card, cpu = card_and_cpu("learned")
    check(card.net.output_conv.weight.shape[0] == 6,
          "learn_sigma: the head is not 6 channels")
    pair("learned variance, 3 ancestral steps t=2..0",
         lambda m, noise: m._denoise_range(
             noise[0], 3, 0, m._drawer(shape, None, noise[1:])), card, cpu,
         draws(4))
    pair("learned variance, strided S=4",
         lambda m, **k: m.generate_samples_strided(2, 4, **k), card, cpu,
         draws(5))
    del card, cpu
    card, cpu = card_and_cpu("learned", num_timesteps=10)
    x = (torch.rand(shape, generator=gen) * 2 - 1)
    pair("nll_bits_per_dim T=10",
         lambda m, x, **k: m.nll_bits_per_dim(x, **k), card, cpu, draws(10),
         x=x)
    del card, cpu
    f32 = dict(compute_dtype="float32", dropout=0.0)
    card = seeded_model("learned", DEVICE, trainable=True, **f32)
    state = {k: v.cpu() for k, v in card.net.state_dict().items()}
    cpu = seeded_model("learned", "cpu", state, trainable=True, **f32)
    check(isinstance(card, DDPM) and card.learn_sigma, "learned model")
    t = torch.tensor([17, 803]) % card.num_timesteps
    noise = draws(1)[0]
    want_loss, want = grads_of_step(cpu, x, t, noise)
    got_loss, got = grads_of_step(card, x.to(DEVICE), t.to(DEVICE),
                                  noise.to(DEVICE))
    errs["hybrid loss"] = hold("hybrid loss, card vs CPU", got_loss,
                               want_loss, UNET_TOL)
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, hold_quiet(g, w))
    log(f"  hybrid loss gradients, card vs CPU: {len(want)} tensors, max "
        f"abs err {worst:.3e} ok")
    errs["hybrid loss gradients"] = worst
    return errs


def hold_quiet(got, want) -> float:
    """``hold`` within UNET_TOL without a log line."""
    d = (got.float() - want.float()).abs()
    check(bool((d <= UNET_TOL + UNET_TOL * want.float().abs()).all()),
          "a gradient disagrees with the CPU")
    return float(d.max())


def serve_samplers(per_forward):
    """Phase 11b: serve the three models over HTTP in bf16 at the serve
    batch; each case of SERVE_CASES gets a warm-up request and three timed
    ones, each of which must launch K1 and K3 exactly 53× and 5× its UNet
    forwards."""
    import numpy as np
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    from diffusion_model_universal_torch.scripts.serve import (
        build_argparser, make_server)
    kernels = {"gn": gn_ops.GN_KERNEL, "mha": attn_ops.MHA_KERNEL}
    tmp = Path(tempfile.mkdtemp(prefix="dmu_samplers_"))
    rows, profile = [], None
    try:
        for variant in SAMPLER_MODELS:
            model = seeded_model(variant, DEVICE)
            ckpt = str(tmp / f"{variant}.ckpt")
            model.save(ckpt)
            del model
            path, model_type, _ = SAMPLER_MODELS[variant]
            srv = make_server(build_argparser().parse_args([
                "--config", str(path), "--model_type", model_type,
                "--checkpoint", ckpt, "--port", "0", "--serve_batch",
                str(SERVE_BATCH), "--device", DEVICE]))
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            host, port = srv.server_address[:2]
            try:
                for name, fields, forwards in SERVE_CASES:
                    if name != variant:
                        continue
                    body = dict(fields, num_samples=SERVE_BATCH,
                                format="npy")
                    want = {n: forwards * per_forward[n] for n in kernels}
                    times = []
                    for seed in range(4):      # a warm-up, then three
                        for k in kernels.values():
                            k.launches = 0
                        req = urllib.request.Request(
                            f"http://{host}:{port}/generate",
                            data=json.dumps(dict(body, seed=seed)).encode(),
                            headers={"Content-Type": "application/json"})
                        t0 = time.perf_counter()
                        with urllib.request.urlopen(req, timeout=600) as r:
                            arr = np.load(io.BytesIO(r.read()))
                        secs = time.perf_counter() - t0
                        got = {n: k.launches for n, k in kernels.items()}
                        check(got == want, f"{variant} {fields}: launches "
                              f"{got} != {want}")
                        check(arr.shape == (SERVE_BATCH, 32, 32, 3)
                              and bool(np.isfinite(arr).all()),
                              f"{variant} {fields}: samples {arr.shape}")
                        if seed:
                            times.append(secs)
                    rows.append({
                        "model": variant, "request": fields,
                        "unet_forwards": forwards, "launches": want,
                        "seconds": times,
                        "images_per_s": [SERVE_BATCH / s for s in times]})
                    log(f"[serve] {variant} {fields or 'default (DDIM-50)'}"
                        f": {', '.join(f'{s:.3f}' for s in times)} s a "
                        f"request ({SERVE_BATCH / statistics.mean(times):.1f}"
                        f" img/s); launches {want} each")
                if variant == "ddim":   # where a DDIM-50 request goes
                    model = srv.service.model
                    gen = torch.Generator(device=DEVICE)
                    profile = profile_run(
                        lambda: model.generate_samples(
                            SERVE_BATCH, generator=gen.manual_seed(9)), 1,
                        f"DDIM-50 request B={SERVE_BATCH}")
                    del model
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=60)
            check(not thread.is_alive(), "server thread did not stop")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows, profile


def sampler_clis():
    """Phase 11c: ``train --model_type ddim`` for a few steps at full width,
    then ``generate --ema --sampler dpm++`` from its checkpoint;
    ``generate --class_id 3`` on a saved conditional model;
    ``generate --inpaint_image/--inpaint_mask`` on .npy files; and
    ``train`` with ``learn_sigma: true``."""
    import numpy as np
    import yaml
    from diffusion_model_universal_torch.utils.config import load_config
    from diffusion_model_universal_torch.utils.images import decode_png
    tmp = Path(tempfile.mkdtemp(prefix="dmu_sampler_cli_"))
    out = {}
    try:
        def run_config(path, name, sample_interval, **model):
            """``path`` for one epoch of 3 steps on 512 synthetic images,
            saving only ``final_model``."""
            cfg = load_config(str(path))
            cfg["model_config"] = dict(cfg["model_config"], **model)
            cfg["data"] = dict(cfg["data"], dataset="synthetic",
                               num_samples=512)
            cfg["training"] = dict(cfg["training"], num_epochs=1,
                                   sample_interval=sample_interval,
                                   val_interval=1000,
                                   checkpoint_interval=10)
            cfg["output"] = dict(cfg["output"],
                                 output_dir=str(tmp / name))
            p = tmp / f"{name}.yaml"
            p.write_text(yaml.safe_dump(cfg))
            return str(p)

        def trained(name, model_type, cfg_path):
            stdout = run_cli("train", ["--config", cfg_path, "--model_type",
                                       model_type, "--seed", str(SEED)],
                             f"train --model_type {model_type} ({name})")
            launches = json.loads(stdout.split("Kernel launches: ")[1]
                                  .splitlines()[0])
            check(all(launches.get(s, 0) > 0 for s in (
                "dmu_group_norm_silu_fwd", "dmu_group_norm_silu_bwd",
                "dmu_mha_fwd")), f"{name}: a kernel never launched")
            losses = [json.loads(line)["train/loss"] for line in
                      (tmp / name / "metrics.jsonl").read_text()
                      .splitlines() if "train/loss" in line]
            check(losses and all(math.isfinite(v) for v in losses),
                  f"{name}: losses {losses}")
            return launches, losses

        ddim_cfg = run_config(DDIM_CONFIG, "ddim", 1)   # a DDIM grid
        launches, losses = trained("ddim", "ddim", ddim_cfg)
        logged = [json.loads(line) for line in
                  (tmp / "ddim" / "metrics.jsonl").read_text().splitlines()]
        check(any(d.get("ddim/sampling_steps") == 50 and "ddim/eta" in d
                  for d in logged),
              "DDIMTrainer did not log ddim/sampling_steps and ddim/eta")
        grid = decode_png((tmp / "ddim" / "samples" / "epoch_0.png")
                          .read_bytes())
        # 4 samples, x_T and the 25 saved DDIM positions a row.
        check(grid.shape == (4 * 34 + 2, 26 * 34 + 2, 3),
              f"DDIM sample grid {grid.shape}")
        out["train_ddim"] = {"launches": launches, "steps": len(losses),
                             "losses": [losses[0], losses[-1]]}
        gen_dir = tmp / "gen_dpm"
        run_cli("generate", ["--config", ddim_cfg, "--model_type", "ddim",
                             "--checkpoint", str(tmp / "ddim" / "checkpoints"
                                                 / "final_model"),
                             "--ema", "--sampler", "dpm++", "--num_samples",
                             "4", "--output_dir", str(gen_dir)],
                "generate --ema --sampler dpm++")
        check((gen_dir / "samples_grid.png").is_file(), "dpm++ grid")
        cond = seeded_model("conditional", DEVICE)
        cond_ckpt = str(tmp / "conditional.ckpt")
        cond.save(cond_ckpt)
        del cond
        run_cli("generate", ["--config", str(DDIM_CONFIG), "--model_type",
                             "ddim", "--checkpoint", cond_ckpt,
                             "--class_id", "3", "--num_samples", "4",
                             "--output_dir", str(tmp / "gen_cfg")],
                "generate --class_id 3 (CFG 3.0, DDIM-50)")
        image = np.clip(np.random.default_rng(SEED).standard_normal(
            (32, 32, 3)), -1, 1).astype(np.float32)
        mask = np.zeros((32, 32), np.float32)
        mask[:, :16] = 1.0
        np.save(tmp / "image.npy", image)
        np.save(tmp / "mask.npy", mask)
        run_cli("generate", ["--config", str(DDIM_CONFIG), "--model_type",
                             "ddim", "--checkpoint", cond_ckpt,
                             "--inpaint_image", str(tmp / "image.npy"),
                             "--inpaint_mask", str(tmp / "mask.npy"),
                             "--num_samples", "4", "--output_dir",
                             str(tmp / "gen_inpaint")],
                "generate --inpaint_image/--inpaint_mask, 4 samples, "
                "1000 ancestral steps")
        left = decode_png((tmp / "gen_inpaint" / "sample_0000.png")
                          .read_bytes())[:, :16]
        want = np.round((image[:, :16] + 1) * 127.5).clip(0, 255)
        check(np.abs(left.astype(np.float32) - want).max() <= 1.0,
              "inpainting did not keep the known pixels")
        launches, losses = trained(
            "learned", "ddpm", run_config(CONFIG, "learned", 0,
                                          learn_sigma=True))
        out["train_learn_sigma"] = {"launches": launches,
                                    "steps": len(losses),
                                    "losses": [losses[0], losses[-1]]}
        log(f"[cli] DDIM and learn_sigma training, dpm++, CFG and "
            f"inpainting generation: {json.dumps(out)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def samplers(per_forward):
    """Phase 11: DDIM, the fast samplers, CFG, inpainting and learned
    variance through their entry points."""
    t0 = time.perf_counter()
    log("[hold] phase 11a: the samplers on the card against the CPU:")
    errs = hold_samplers()
    t1 = time.perf_counter()
    log("[serve] phase 11b: the samplers over HTTP, bf16, batch "
        f"{SERVE_BATCH}:")
    rows, profile = serve_samplers(per_forward)
    t2 = time.perf_counter()
    cli = sampler_clis()
    t3 = time.perf_counter()
    secs = {"11a": t1 - t0, "11b": t2 - t1, "11c": t3 - t2,
            "total": t3 - t0}
    log(f"[phase 11] samplers: {secs['total']:.1f} s (11a {secs['11a']:.1f}"
        f", 11b {secs['11b']:.1f}, 11c {secs['11c']:.1f})")
    return {"card_vs_cpu_max_abs_err": errs, "serve": rows,
            "profile_ddim50": profile, "cli": cli, "seconds": secs}


# -- the score-based and energy-based families (phase 12) -------------------

SCORE_CONFIG = (REPO / "diffusion_model_universal_torch" / "configs"
                / "score_based_config.yaml")
ENERGY_CONFIG = (REPO / "diffusion_model_universal_torch" / "configs"
                 / "energy_based_config.yaml")
#: Each family's config, the cut of its request in phase 12b (the only
#: change to the published config), and the network evaluations of a
#: request at that cut and on the published ladder: the score family's
#: UNet forwards (num_scales × langevin_steps), the energy family's ∇ₓE
#: (levels × langevin_steps).
FAMILIES = {
    "score_based": (SCORE_CONFIG, {"num_scales": 50, "langevin_steps": 10},
                    500, 1000 * 10),
    "energy_based": (ENERGY_CONFIG,
                     {"num_timesteps": 50, "langevin_steps": 10}, 500,
                     1000 * 10),
}
#: Phase 12c's cut of the CLIs' YAML copies: the sample grid and
#: ``generate`` draw 5 levels, not the published 1000.
FAMILY_CLI_CUTS = {"score_based": {"num_scales": 5},
                   "energy_based": {"num_timesteps": 5}}
FAMILY_TRAIN_BATCH = 64     # both configs' training.batch_size


def family_config(family: str, **extra):
    from diffusion_model_universal_torch.utils.config import (
        canonicalize_model_config, load_config, resolve_interpolations)
    cfg = canonicalize_model_config(resolve_interpolations(load_config(
        str(FAMILIES[family][0])))["model_config"])
    return dict(cfg, **extra)


def family_model(family: str, device, state=None, trainable=False,
                 **extra):
    """The family's model at its published width on ``device`` from seeded
    weights (the zero-initialized leaves given small seeded values), or
    holding ``state``; ``extra`` overrides config keys."""
    import torch
    from diffusion_model_universal_torch.models import MODEL_REGISTRY
    model = MODEL_REGISTRY[family](family_config(family, **extra),
                                   device=device, seed=SEED,
                                   trainable=trainable)
    with torch.no_grad():
        if state is not None:
            model.net.load_state_dict(state)
        else:
            gen = torch.Generator().manual_seed(SEED + 1)
            for p in model.net.parameters():
                if not p.any():
                    p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def family_pair(family: str, trainable=False, **extra):
    """The family in f32 (dropout off) on the card and the same weights
    on the CPU."""
    extra = dict(compute_dtype="float32", dropout=0.0, **extra)
    card = family_model(family, DEVICE, trainable=trainable, **extra)
    state = {k: v.cpu() for k, v in card.net.state_dict().items()}
    return card, family_model(family, "cpu", state, trainable=trainable,
                              **extra)


def loss_and_grads(model, x, **draws):
    """Loss and every parameter gradient of ``model.loss_function``
    (zeros for a parameter the loss does not reach)."""
    import torch
    loss = model.loss_function(x, **draws)
    grads = torch.autograd.grad(loss, list(model.net.parameters()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach().cpu(), [g.cpu() for g in grads]


def hold_loss_and_grads(name, card, cpu, x, **draws):
    """``loss_and_grads`` on the card against the CPU within UNET_TOL."""
    want_loss, want = loss_and_grads(cpu, x, **draws)
    got_loss, got = loss_and_grads(
        card, x.to(DEVICE), **{k: [t.to(DEVICE) for t in v]
                               if isinstance(v, list) else v.to(DEVICE)
                               for k, v in draws.items()})
    err = hold(f"{name}, card vs CPU", got_loss, want_loss, UNET_TOL)
    worst = max(hold_quiet(g, w) for g, w in zip(got, want))
    log(f"  {name} gradients, card vs CPU: {len(want)} tensors, max abs "
        f"err {worst:.3e} ok")
    return {"loss": err, "gradients": worst}


def hold_families():
    """Phase 12a: both families on the card against the CPU (the plain
    versions there), f32, B=2, published widths, the same weights and
    injected draws, within UNET_TOL: the σ-UNet at σ 0.01, 1 and 50,
    2 levels × 2 Langevin steps (each score, then the iterate relative to
    its size: the top of the ladder multiplies a score's error by
    (σβ)²·2 = 5000), the DSM loss and its gradients, the EnergyNet's E and
    ∇ₓE, CD + GP and the energy DSM with their (second-order) gradients,
    and 2 levels of each energy sampler."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 31)
    shape = (2, 32, 32, 3)

    def draws(n):
        return [torch.randn(shape, generator=gen) for _ in range(n)]

    def on(tensors):
        return [t.to(DEVICE) for t in tensors]

    errs = {}
    x = torch.rand(shape, generator=gen) * 2 - 1
    card, cpu = family_pair("score_based", trainable=True)
    log(f"[model] score_based_config.yaml: C={card.config['model_channels']}"
        f", {card.num_scales} levels x {card.langevin_steps} steps, "
        f"{sum(p.numel() for p in card.net.parameters())} parameters")
    for sigma in (0.01, 1.0, 50.0):
        s = torch.full((2,), sigma)
        with torch.no_grad():
            want = cpu.apply(x, s)
            got = card.apply(x.to(DEVICE), s.to(DEVICE))
        torch.cuda.synchronize()
        errs[f"score UNet sigma={sigma}"] = hold(
            f"score UNet at sigma {sigma}, card vs CPU", got.cpu(), want,
            UNET_TOL)
    sigma = torch.tensor([0.05, 20.0])
    errs["DSM loss"] = hold_loss_and_grads(
        "DSM loss (sigma 0.05, 20)", card, cpu, x, sigma=sigma,
        noise=draws(1)[0])
    del card, cpu
    # The same seeded weights (a family's weights depend on its seed and
    # widths only).
    card, cpu = family_pair("score_based", num_scales=2, langevin_steps=2)
    noise = draws(5)
    scores = {"card": [], "cpu": []}

    def recorded(model, out):
        def score_fn(z, s):
            value = model.apply(z, s)
            out.append(value.cpu())
            return value
        return score_fn

    want = cpu.generate_samples(2, noise=noise,
                                score_fn=recorded(cpu, scores["cpu"]))
    got = card.generate_samples(2, noise=on(noise),
                                score_fn=recorded(card, scores["card"]))
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(scores["card"], scores["cpu"])):
        errs[f"Langevin score {i}"] = hold(
            f"Langevin step {i} (sigma {card.sigmas[i // 2]:.3g}) score, "
            "card vs CPU", g, w, UNET_TOL)
    scale = float(want.abs().max())
    errs["Langevin 2x2 iterate"] = hold(
        f"annealed Langevin 2 levels x 2 steps, card vs CPU (abs tol "
        f"{UNET_TOL:g} x max|x| = {UNET_TOL * scale:.3g})", got.cpu(), want,
        UNET_TOL * scale, UNET_TOL)
    del card, cpu

    card, cpu = family_pair("energy_based", trainable=True)
    log(f"[model] energy_based_config.yaml: C={card.net.model_channels}, "
        f"T={card.num_timesteps}, {card.langevin_steps} Langevin steps, "
        f"{sum(p.numel() for p in card.net.parameters())} parameters")
    c = card.net.model_channels
    check(card.net.conv1.weight.shape[1] == 3 + c,
          f"EnergyNet's input is not 3 + {c} channels")
    t = torch.tensor([17, 803])
    with torch.no_grad():
        want, got = cpu.apply(x, t), card.apply(x.to(DEVICE), t.to(DEVICE))
    want_g = cpu.energy_grad(x, t)
    got_g = card.energy_grad(x.to(DEVICE), t.to(DEVICE))
    torch.cuda.synchronize()
    errs["energy"] = hold("EnergyNet E(x, t), card vs CPU", got.cpu(), want,
                          UNET_TOL)
    errs["energy grad"] = hold("EnergyNet grad_x E, card vs CPU",
                               got_g.cpu(), want_g, UNET_TOL)
    steps = card.langevin_steps
    errs["CD+GP loss"] = hold_loss_and_grads(
        f"CD + GP loss ({steps} Langevin steps, second order)", card, cpu,
        x, t=t, noise=draws(1)[0], langevin_noise=draws(steps),
        alpha=torch.rand((2, 1, 1, 1), generator=gen))
    del card, cpu
    card, cpu = family_pair("energy_based", trainable=True,
                            training_objective="dsm")
    errs["energy DSM loss"] = hold_loss_and_grads(
        "energy DSM loss (second order)", card, cpu, x, t=t,
        noise=draws(1)[0])
    del card, cpu
    for objective, per_level in (("cd", steps + 1), ("dsm", 1)):
        card, cpu = family_pair("energy_based", num_timesteps=2,
                                training_objective=objective)
        noise = draws(1 + 2 * per_level)
        want = cpu.generate_samples(2, noise=noise)
        got = card.generate_samples(2, noise=on(noise))
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        errs[f"energy sampler {objective}"] = hold(
            f"energy sampler ({objective}) 2 levels, card vs CPU (abs tol "
            f"{UNET_TOL:g} x max|x|)", got.cpu(), want, UNET_TOL * scale,
            UNET_TOL)
        del card, cpu
    return errs


#: Levels of a served model's sampler that phase 12b traces: 50 network
#: evaluations, as the traced DDIM-50 request. Tracing a whole request
#: of 500 (130,000 kernels) costs minutes of the profiler's own
#: processing; a request's levels all do the same work.
PROFILE_LEVELS = 5


def profile_levels(model, levels: int):
    """``profile_run`` over the first ``levels`` levels of ``model``'s
    sampler at the serve batch (the score family's σ ladder, the energy
    family's sweep), with the request's own draws and grad modes."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    shape = model.sample_shape(SERVE_BATCH)
    x = torch.randn(shape, generator=gen, device=DEVICE)
    draw = model._drawer(shape, gen, None)
    if hasattr(model, "sigmas"):          # the score family
        levels = min(levels, model.num_scales)

        def run():
            with torch.inference_mode():
                model._run_levels(x, 0, levels, draw, model.apply)
        n = levels * model.langevin_steps
    else:
        levels = min(levels, model.num_timesteps)

        def run():
            with torch.no_grad():
                t = model.num_timesteps
                model._sweep(x, t, t - levels, draw)
        n = levels * (model.langevin_steps
                      if model.training_objective == "cd" else 1)
    return profile_run(run, 1, f"{type(model).__name__} {levels} levels "
                       f"of a request, B={SERVE_BATCH} ({n} evaluations)",
                       warmup=0)


def serve_families(per_forward):
    """Phase 12b: serve each family over HTTP in bf16 at the serve batch,
    at its published width with one cut (FAMILIES): a warm-up request and
    three timed ones; the score request must launch K1 and K3 exactly 53×
    and 5× its UNet forwards, the energy request no K1, K2 or K3. Then
    PROFILE_LEVELS levels of the served model's sampler traced with
    torch.profiler."""
    import numpy as np
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    from diffusion_model_universal_torch.scripts.serve import (
        build_argparser, make_server)
    kernels = {"gn": gn_ops.GN_KERNEL, "gn_bwd": gn_ops.GN_BWD_KERNEL,
               "mha": attn_ops.MHA_KERNEL}
    tmp = Path(tempfile.mkdtemp(prefix="dmu_families_"))
    rows = []
    try:
        for family, (path, cut, evals, full) in FAMILIES.items():
            model = family_model(family, DEVICE, **cut)
            ckpt = str(tmp / f"{family}.ckpt")
            model.save(ckpt)
            del model
            srv = make_server(build_argparser().parse_args([
                "--config", str(path), "--model_type", family,
                "--checkpoint", ckpt, "--port", "0", "--serve_batch",
                str(SERVE_BATCH), "--device", DEVICE]))
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            host, port = srv.server_address[:2]
            per = per_forward if family == "score_based" else {}
            want = {n: evals * per.get(n, 0) for n in kernels}
            times = []
            try:
                for seed in range(4):      # a warm-up, then three
                    for k in kernels.values():
                        k.launches = 0
                    req = urllib.request.Request(
                        f"http://{host}:{port}/generate",
                        data=json.dumps({"num_samples": SERVE_BATCH,
                                         "seed": seed,
                                         "format": "npy"}).encode(),
                        headers={"Content-Type": "application/json"})
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=900) as r:
                        arr = np.load(io.BytesIO(r.read()))
                    secs = time.perf_counter() - t0
                    got = {n: k.launches for n, k in kernels.items()}
                    check(got == want, f"{family}: launches {got} != {want}")
                    check(arr.shape == (SERVE_BATCH, 32, 32, 3)
                          and bool(np.isfinite(arr).all()),
                          f"{family}: samples {arr.shape}")
                    if seed:
                        times.append(secs)
                profile = profile_levels(srv.service.model,
                                         PROFILE_LEVELS)

            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=60)
            check(not thread.is_alive(), "server thread did not stop")
            mean = statistics.mean(times)
            ms_per_eval = mean / evals * 1e3
            row = {"family": family, "cut": cut, "evaluations": evals,
                   "launches": want, "seconds": times,
                   "images_per_s": [SERVE_BATCH / t for t in times],
                   "host_ms_per_evaluation": ms_per_eval,
                   "full_ladder_evaluations": full,
                   "full_ladder_forecast_s": full * ms_per_eval / 1e3,
                   "device_busy_share": (profile or {}).get(
                       "device_busy_share"),
                   "profile": profile}
            rows.append(row)
            log(f"[serve] {family} {cut}: {', '.join(f'{t:.3f}' for t in times)}"
                f" s a request ({SERVE_BATCH / mean:.2f} img/s), "
                f"{ms_per_eval:.3f} ms a network evaluation, full ladder "
                f"({full} evaluations) forecast {row['full_ladder_forecast_s']:.1f}"
                f" s a request; device busy "
                f"{row['device_busy_share'] if profile else 'not measured'}; "
                f"launches {want} each")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def family_clis():
    """Phase 12c: ``train`` for 3 steps at the config's batch of 64 on the
    synthetic set, then ``generate --ema`` from its checkpoint, for each
    family; the YAML copies cut the ladder (FAMILY_CLI_CUTS). The score
    training must launch K1, K2 and K3; the energy training none of
    them."""
    import yaml
    from diffusion_model_universal_torch.utils.config import load_config
    tmp = Path(tempfile.mkdtemp(prefix="dmu_family_cli_"))
    out = {}
    try:
        for family, cut in FAMILY_CLI_CUTS.items():
            cfg = load_config(str(FAMILIES[family][0]))
            cfg["model_config"] = dict(cfg["model_config"], **cut)
            cfg["data"] = dict(cfg["data"], dataset="synthetic",
                               num_samples=256)   # 204 train: 3 steps
            cfg["training"] = dict(cfg["training"], num_epochs=1,
                                   sample_interval=1, val_interval=1000,
                                   checkpoint_interval=10)
            cfg["output"] = dict(cfg["output"], output_dir=str(tmp / family))
            check(cfg["training"]["batch_size"] == FAMILY_TRAIN_BATCH,
                  f"{family}: training.batch_size")
            path = tmp / f"{family}.yaml"
            path.write_text(yaml.safe_dump(cfg))
            stdout = run_cli("train", ["--config", str(path), "--model_type",
                                       family, "--seed", str(SEED)],
                             f"train --model_type {family} (3 steps, B=64, "
                             f"cut {cut})")
            launches = json.loads(stdout.split("Kernel launches: ")[1]
                                  .splitlines()[0])
            ours = {s: launches.get(s, 0) for s in (
                "dmu_group_norm_silu_fwd", "dmu_group_norm_silu_bwd",
                "dmu_mha_fwd")}
            if family == "score_based":
                check(all(v > 0 for v in ours.values()),
                      f"score training launched {ours}")
            else:
                check(not any(ours.values()),
                      f"energy training launched {ours}")
            logged = [json.loads(line) for line in
                      (tmp / family / "metrics.jsonl").read_text()
                      .splitlines()]
            losses = [d["train/loss"] for d in logged if "train/loss" in d]
            check(len(losses) == 1 and all(math.isfinite(v) for v in losses),
                  f"{family}: losses {losses}")
            prefix = "score/" if family == "score_based" else "energy/"
            check(any(any(k.startswith(prefix) for k in d) for d in logged),
                  f"{family}: no step-0 {prefix} log")
            check((tmp / family / "samples" / "epoch_0.png").is_file(),
                  f"{family}: no sample grid")
            gen_dir = tmp / f"gen_{family}"
            run_cli("generate", ["--config", str(path), "--model_type",
                                 family, "--checkpoint",
                                 str(tmp / family / "checkpoints"
                                     / "final_model"), "--ema",
                                 "--num_samples", "4", "--output_dir",
                                 str(gen_dir)],
                    f"generate --model_type {family} --ema")
            check((gen_dir / "samples_grid.png").is_file(),
                  f"{family}: no generated grid")
            out[family] = {"launches": ours, "loss": losses[0], "cut": cut}
        log(f"[cli] score-based and energy-based train and generate: "
            f"{json.dumps(out)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def families(per_forward):
    """Phase 12: the score-based and energy-based families through their
    entry points."""
    t0 = time.perf_counter()
    log("[hold] phase 12a: the score and energy families on the card "
        "against the CPU:")
    errs = hold_families()
    t1 = time.perf_counter()
    log("[serve] phase 12b: the score and energy families over HTTP, "
        f"bf16, batch {SERVE_BATCH}:")
    rows = serve_families(per_forward)
    t2 = time.perf_counter()
    cli = family_clis()
    t3 = time.perf_counter()
    secs = {"12a": t1 - t0, "12b": t2 - t1, "12c": t3 - t2,
            "total": t3 - t0}
    log(f"[phase 12] families: {secs['total']:.1f} s (12a {secs['12a']:.1f}"
        f", 12b {secs['12b']:.1f}, 12c {secs['12c']:.1f})")
    return {"card_vs_cpu_max_abs_err": errs, "serve": rows, "cli": cli,
            "seconds": secs}


# -- phase 13: the sample-quality harness --------------------------------

#: Phase 13b's cut of ddpm_config.yaml's benchmark section: 64 of its
#: 10,000 samples, in batches of 16, by DPM++-20 (19 UNet forwards a
#: batch) for the family's own 1000-step sampler.
HARNESS_BENCH = {"n_samples": 64, "batch_size": 16, "sampler": "dpm++",
                 "sampler_steps": 20}
HARNESS_FORWARDS = 4 * 19           # batches × UNet forwards a batch
INCEPTION_TIME_BATCHES = (64, 128)


def harness_inputs(b, size, gen):
    import torch
    return torch.rand((b, size, size, 3), generator=gen) * 2.0 - 1.0


def hold_harness(inception_state):
    """Phase 13a: the harness's networks on the card against the CPU in
    f32 within UNET_TOL: the seeded extractor at B=4, 32² and 128²,
    InceptionV3 (from a 32² input, so through the 299² resize) at B=2,
    the VGG16 taps at B=2, 32², and one DDPM training loss with
    ``perceptual_weight: 0.1`` and its gradients at B=2."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.utils.benchmarks import (
        FeatureExtractor)
    from diffusion_model_universal_torch.utils.inception import (
        InceptionExtractor, imagenet_normalize)
    from diffusion_model_universal_torch.utils.vgg import (VGG16Features,
                                                           init_vgg16_)
    gen = torch.Generator().manual_seed(SEED + 13)
    errs = {}
    card, cpu = (FeatureExtractor(seed=SEED, device=d)
                 for d in (DEVICE, "cpu"))
    for size in (32, 128):
        x = harness_inputs(4, size, gen)
        got, want = card(x.to(DEVICE)), cpu(x)
        errs[f"extractor {size}²"] = max(
            hold(f"seeded extractor B=4 {size}² {name}, card vs CPU",
                 g.cpu(), w, UNET_TOL)
            for name, g, w in zip(("features", "logits"), got, want))
    card, cpu = (InceptionExtractor(state_dict=inception_state, device=d)
                 for d in (DEVICE, "cpu"))
    x = harness_inputs(2, 32, gen)
    got, want = card(x.to(DEVICE)), cpu(x)
    errs["inception 299²"] = max(
        hold(f"InceptionV3 B=2 299² {name}, card vs CPU", g.cpu(), w,
             UNET_TOL)
        for name, g, w in zip(("features", "logits"), got, want))
    errs.update(hold_tf32(card, x, want))
    cpu = init_vgg16_(VGG16Features(), torch.Generator().manual_seed(SEED))
    card = VGG16Features().to(DEVICE)
    card.load_state_dict(cpu.state_dict())
    x = imagenet_normalize(
        (harness_inputs(2, 32, gen).permute(0, 3, 1, 2) + 1.0) / 2.0)
    with torch.no_grad():
        got, want = card(x.to(DEVICE)), cpu(x)
    errs["vgg taps"] = max(
        hold(f"VGG16 tap {i} B=2 32², card vs CPU", g.cpu(), w, UNET_TOL)
        for i, (g, w) in enumerate(zip(got, want)))
    cfg = model_config()
    f32_cfg = dict(cfg, compute_dtype="float32", dropout=0.0,
                   loss_config=dict(cfg.get("loss_config", {}),
                                    perceptual_weight=0.1))
    card = DDPM(f32_cfg, device=DEVICE, seed=SEED, trainable=True)
    cpu = DDPM(f32_cfg, device="cpu", seed=SEED, trainable=True)
    cpu.net.load_state_dict(card.net.state_dict())
    check(card.loss_fn.perceptual_weight == 0.1
          and not card.loss_fn._perceptual.pretrained,
          "perceptual term missing from the DDPM loss")
    x = harness_inputs(2, 32, gen)
    t = torch.tensor([17, 803])
    noise = torch.randn(x.shape, generator=gen)
    errs["perceptual training loss"] = hold_loss_and_grads(
        "DDPM loss + 0.1·perceptual (B=2)", card, cpu, x, t=t, noise=noise)
    with torch.no_grad():
        term = float(card.loss_fn._perceptual(x.to(DEVICE),
                                              noise.to(DEVICE)))
    check(math.isfinite(term) and term > 0.0, f"perceptual term {term}")
    log(f"  VGG distance of x and the noise on the card: {term:.6f}")
    return errs


def hold_tf32(card, x, want):
    """Phase 13a: InceptionV3 (B=2, 299²) under PyTorch's default TF32
    setting, which the ``train`` CLI keeps (cuDNN convs in TF32, cuBLAS
    matmuls not), against the CPU's f32: the network as it is, and
    through the harness's ``f32_extraction``, which must hold the
    harness's bound, 1e-4 of each output's largest magnitude."""
    import torch
    from diffusion_model_universal_torch.utils.benchmarks import (
        f32_extraction)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        raw = card(x.to(DEVICE))
        with f32_extraction():
            guarded = card(x.to(DEVICE))
        flags_back = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32) == (True, False)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    check(flags_back, "f32_extraction did not restore the TF32 flags")

    def rel(outs):
        return max(float((g.cpu() - w).abs().max()) / float(w.abs().max())
                   for g, w in zip(outs, want))

    out = {"inception tf32 default rel": rel(raw),
           "inception tf32 default, f32_extraction rel": rel(guarded)}
    log(f"  InceptionV3 B=2 299² under the default TF32 setting, card vs CPU "
        f"f32: {out['inception tf32 default rel']:.3e} of the largest "
        f"output as it is ({'over' if rel(raw) > 1e-4 else 'within'} the "
        f"harness's 1e-4), {out['inception tf32 default, f32_extraction rel']:.3e}"
        f" through f32_extraction")
    check(rel(guarded) <= 1e-4, "f32_extraction misses the harness's bound")
    return out


def time_inception(inception_state):
    """Phase 13c: InceptionV3 images/s in f32 (TF32 off) at 299², by CUDA
    events: the network alone, and the extractor from 32² images (resize
    and normalization included)."""
    import torch
    from diffusion_model_universal_torch.utils.inception import (
        InceptionExtractor)
    ext = InceptionExtractor(state_dict=inception_state, device=DEVICE)
    gen = torch.Generator().manual_seed(SEED + 14)
    rows = []
    for b in INCEPTION_TIME_BATCHES:
        x299 = torch.randn((b, 3, 299, 299), generator=gen).to(DEVICE)
        x32 = harness_inputs(b, 32, gen).to(DEVICE)
        with torch.no_grad():
            net_ms = cuda_ms(lambda: ext.net(x299), iters=3, reps=3)
            ext_ms = cuda_ms(lambda: ext(x32), iters=3, reps=3)
        rows.append({"batch": b, "net_ms": net_ms,
                     "net_images_per_s": b / net_ms * 1e3,
                     "extractor_from_32_ms": ext_ms,
                     "extractor_images_per_s": b / ext_ms * 1e3})
        log(f"[time] InceptionV3 f32 B={b}: network at 299² {net_ms:.2f} ms "
            f"({b / net_ms * 1e3:.0f} img/s); extractor from 32² "
            f"{ext_ms:.2f} ms ({b / ext_ms * 1e3:.0f} img/s)")
    return rows


def time_benchmark_batch():
    """Phase 13c: one in-process ``--benchmark`` run as the CLI makes it
    (the config's trainable model, bf16 autocast, the synthetic test set,
    InceptionV3 from ``$DMU_INCEPTION_WEIGHTS``), two batches of 16, each
    sampling call and each extractor call timed on the host clock between
    synchronizes."""
    import torch
    from diffusion_model_universal_torch.datasets import get_dataset
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.utils.benchmarks import (
        DiffusionBenchmark)
    cfg = train_config(tempfile.gettempdir())
    model = DDPM(cfg["model_config"], device=DEVICE, seed=SEED,
                 trainable=True)
    test_loader = get_dataset(cfg, device=model.device)[2]
    bench = DiffusionBenchmark(
        n_samples=2 * HARNESS_BENCH["batch_size"],
        batch_size=HARNESS_BENCH["batch_size"], use_inception=True,
        sampler=HARNESS_BENCH["sampler"],
        sampler_steps=HARNESS_BENCH["sampler_steps"], device=DEVICE)
    spans = {"sampling": [], "extraction": []}

    def timed(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[kind].append(time.perf_counter() - t0)
            return out
        return run

    model.generate_samples_dpm = timed("sampling", model.generate_samples_dpm)
    bench.extractor = timed("extraction", bench.extractor)
    with torch.no_grad():   # a warm-up batch: cuDNN picks its algorithms
        model.generate_samples_dpm(2, num_steps=3)
        bench.extractor(torch.zeros((16, 32, 32, 3), device=DEVICE))
    spans = {"sampling": [], "extraction": []}
    t0 = time.perf_counter()
    results = bench.evaluate(model, test_loader)
    total = time.perf_counter() - t0
    n_real = len(test_loader)
    real_s = sum(spans["extraction"][:n_real])
    fake_s = spans["extraction"][n_real:]
    sample_s = spans["sampling"]
    extract_share = (real_s + sum(fake_s)) / total
    check(all(math.isfinite(results[k]) for k in
              ("fid", "is_mean", "is_std", "ssim", "psnr")),
          f"in-process benchmark results {results}")
    log(f"[time] --benchmark batch of {HARNESS_BENCH['batch_size']} "
        f"(DPM++-20, bf16 autocast): sampling "
        f"{', '.join(f'{v:.3f}' for v in sample_s)} s, extraction "
        f"{', '.join(f'{v:.3f}' for v in fake_s)} s; the real set's "
        f"{n_real} batches {real_s:.3f} s; the run {total:.3f} s, "
        f"extraction {extract_share:.3f} of it")
    return {"sampling_s": sample_s, "fake_extraction_s": fake_s,
            "real_extraction_s": real_s, "real_batches": n_real,
            "total_s": total, "extraction_share": extract_share,
            "results": results}


def benchmark_cli(weights: str):
    """Phase 13b: ``train --eval_only --benchmark`` on ddpm_config.yaml at
    full width (the synthetic set, HARNESS_BENCH, InceptionV3 from the
    seeded ``.npz``): finite metrics in the results file, no fallback,
    and exactly HARNESS_FORWARDS × 53 K1 and × 5 K3 launches in the
    benchmark."""
    import yaml
    tmp = Path(tempfile.mkdtemp(prefix="dmu_benchmark_cli_"))
    try:
        cfg = train_config(str(tmp))
        cfg["benchmark"] = dict(cfg["benchmark"], **HARNESS_BENCH)
        path = tmp / "bench.yaml"
        path.write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        out = run_cli("train", ["--config", str(path), "--model_type",
                                "ddpm", "--seed", str(SEED), "--eval_only",
                                "--benchmark"],
                      f"train --eval_only --benchmark {HARNESS_BENCH}",
                      env={**os.environ, "DMU_INCEPTION_WEIGHTS": weights})
        secs = time.perf_counter() - t0
        check("Falling back" not in out, "the benchmark fell back to the "
              "seeded extractor")
        out_dir = Path(cfg["output"]["output_dir"])
        results = json.loads((out_dir / cfg["benchmark"]["results_file"])
                             .read_text())
        check(all(math.isfinite(results.get(k, math.nan)) for k in
                  ("fid", "is_mean", "is_std", "ssim", "psnr")),
              f"benchmark results {results}")
        grids = sorted(p.name for p in
                       (out_dir / cfg["benchmark"]["sample_dir"]).iterdir())
        check(len(grids) == 4, f"sample grids {grids}")
        launches = json.loads(out.split("Benchmark kernel launches: ")[1]
                              .splitlines()[0])
        want = {"dmu_group_norm_silu_fwd": 53 * HARNESS_FORWARDS,
                "dmu_group_norm_silu_bwd": 0,
                "dmu_mha_fwd": 5 * HARNESS_FORWARDS}
        got = {k: launches.get(k, 0) for k in want}
        check(got == want, f"benchmark launches {got} != {want}")
        log(f"[cli] --benchmark results {json.dumps(results)}; launches "
            f"{got}")
        return {"results": results, "launches": launches, "seconds": secs}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def harness():
    """Phase 13: the sample-quality harness."""
    import torch
    from diffusion_model_universal_torch.utils.inception import (
        InceptionV3, init_inception_, save_inception_npz)
    t0 = time.perf_counter()
    net = init_inception_(InceptionV3(), torch.Generator().manual_seed(SEED))
    tmp = Path(tempfile.mkdtemp(prefix="dmu_inception_"))
    try:
        weights = str(tmp / "inception_seeded.npz")
        save_inception_npz(net, weights)
        log("[hold] phase 13a: the harness's networks on the card against "
            "the CPU, f32:")
        errs = hold_harness(net.state_dict())
        t1 = time.perf_counter()
        cli = benchmark_cli(weights)
        t2 = time.perf_counter()
        os.environ["DMU_INCEPTION_WEIGHTS"] = weights
        try:
            batch = time_benchmark_batch()
        finally:
            del os.environ["DMU_INCEPTION_WEIGHTS"]
        inception = time_inception(net.state_dict())
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = {"13a": t1 - t0, "13b": t2 - t1, "13c": t3 - t2,
            "total": t3 - t0}
    log(f"[phase 13] harness: {secs['total']:.1f} s (13a {secs['13a']:.1f}, "
        f"13b {secs['13b']:.1f}, 13c {secs['13c']:.1f})")
    return {"card_vs_cpu_max_abs_err": errs, "cli": cli,
            "benchmark_batch": batch, "inception": inception,
            "seconds": secs}


# -- phase 14: MNIST and CelebA, the transforms, the trainer's options ----

#: MNIST as the smoke writes it: train and test images (28², gzipped IDX).
MNIST_SIZES = (2048, 512)
#: The trainer options phase 14 turns on, beside remat_policy: save_convout
#: and logging.track_histograms.
OPTION_TRAINING = {"grad_accum_steps": 2, "ema_dtype": "bfloat16",
                   "adam_mu_dtype": "bfloat16"}
MNIST_HISTOGRAM_FREQ = 4    # logging.gradient_logging_freq of the CLI run
MNIST_PROFILE_STEPS = 3
#: CelebA as the smoke writes it: a celeba_128.npz of this many images
#: with splits, shrunk to 64² on load; data_config.yaml's batch of 64.
CELEBA_IMAGES = 1024
CELEBA_BATCH = 64
CELEBA_STEPS = 8            # timed steps; the train split has 12 batches
#: data_config.yaml's CelebA transforms with rotation, crop and jitter.
CELEBA_TRANSFORMS = [
    {"name": "center_crop", "size": 178}, {"name": "resize", "size": 64},
    {"name": "random_rotation", "degrees": 10},
    {"name": "random_crop", "size": 64, "padding": 4},
    {"name": "color_jitter", "brightness": 0.2, "contrast": 0.2,
     "saturation": 0.2, "hue": 0.05},
    {"name": "random_horizontal_flip"}, {"name": "normalize"}]
LOADER_TIME_BATCH = 128


def hold_transforms():
    """Phase 14a: the resize's arithmetic (``resize_bilinear``, which
    ``host_resize`` runs: 28→32 and 128→64), rotation (nearest and
    bilinear), crop and colour jitter on the card against the CPU in f32,
    on the same inputs and draws."""
    import torch
    from diffusion_model_universal_torch.datasets import pipeline as tp
    from diffusion_model_universal_torch.utils.inception import (
        resize_bilinear)
    gen = torch.Generator().manual_seed(SEED + 20)
    errs = {}
    for b, size, c, out in ((16, 28, 1, 32), (8, 128, 3, 64)):
        x = torch.rand((b, c, size, size), generator=gen) * 255.0
        errs[f"resize {size}->{out}"] = hold(
            f"resize {size}²→{out}² B={b} (uint8 scale), card vs CPU",
            resize_bilinear(x.to(DEVICE), out).cpu(),
            resize_bilinear(x, out), 1e-3, 0.0)
    b = 8
    x = torch.rand((b, 64, 64, 3), generator=gen)
    angles = torch.rand(b, generator=gen) * 60.0 - 30.0
    got = tp.rotate_batch(x.to(DEVICE), angles.to(DEVICE), "bilinear")
    errs["rotation bilinear"] = hold(
        "rotation bilinear B=8 64², card vs CPU", got.cpu(),
        tp.rotate_batch(x, angles, "bilinear"), 1e-5, 0.0)
    got = tp.rotate_batch(x.to(DEVICE), angles.to(DEVICE), "nearest").cpu()
    off = int((got != tp.rotate_batch(x, angles, "nearest")).any(-1).sum())
    log(f"  rotation nearest B=8 64², card vs CPU: {off} of {b * 64 * 64} "
        f"pixels differ (a source coordinate at a rounding tie) "
        f"{'ok' if off <= b * 64 * 64 // 1000 else 'FAIL'}")
    check(off <= b * 64 * 64 // 1000, "nearest rotation differs")
    errs["rotation nearest pixels differing"] = off
    offs = torch.randint(0, 9, (b, 2), generator=gen)
    got = tp.random_crop_batch(x.to(DEVICE), offs.to(DEVICE), 64, 4).cpu()
    check(torch.equal(got, tp.random_crop_batch(x, offs, 64, 4)),
          "random crop differs between the card and the CPU")
    log("  random crop (padding 4) B=8 64², card vs CPU: equal")
    factors = torch.stack([torch.rand(b, generator=gen) * 0.4 + 0.8
                           for _ in range(3)]
                          + [torch.rand(b, generator=gen) * 0.1 - 0.05], -1)
    stages = list(tp.JITTER_STAGES)
    perms = torch.argsort(torch.rand((b, 4), generator=gen), dim=1)
    got = tp.color_jitter_batch(x.to(DEVICE), factors.to(DEVICE),
                                perms.to(DEVICE), stages)
    errs["color jitter"] = hold(
        "colour jitter (4 stages, per-image order) B=8 64², card vs CPU",
        got.cpu(), tp.color_jitter_batch(x, factors, perms, stages), 1e-5,
        0.0)
    return errs


def celeba_model(cfg, dtype: str, device):
    """The config's UNet at image_size 64 for training (dropout off and
    the zero leaves given small seeded values in f32, for holds)."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    model = DDPM(dict(cfg, image_size=64, compute_dtype=dtype, dropout=0.0),
                 device=device, seed=SEED, trainable=True)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.net.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def step_inputs(b: int, size: int, seed: int, num_timesteps: int):
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, size, size, 3), generator=gen).clamp(-1, 1)
    t = torch.randint(0, num_timesteps, (b,), generator=gen)
    return x, t, torch.randn(x.shape, generator=gen)


def hold_celeba_kernels(cfg):
    """Phase 14a: K1, K2 and K3 at every call shape of one 64² training
    step, B=2 in f32 and B=64 in bf16 autocast (the CelebA batch), each
    in bf16 and f32 against its plain version; the step's dispatches must
    be LAUNCHES_PER_STEP. Returns the B=64 step's calls, which phase 14d
    times."""
    import torch
    steps = {}
    for b, dtype in ((2, "float32"), (CELEBA_BATCH, "bfloat16")):
        model = celeba_model(cfg, dtype, DEVICE)
        x, t, noise = (v.to(DEVICE) for v in step_inputs(
            b, 64, SEED + 21, model.num_timesteps))
        calls = record_train_step(lambda: grads_of_step(model, x, t, noise))
        per_step = {k: sum(calls[k].values()) for k in LAUNCHES_PER_STEP}
        log(f"[shapes] one 64² training step at B={b} {dtype}: {per_step} "
            f"dispatches over {len(calls['gn'])} K1, {len(calls['gn_bwd'])} "
            f"K2 and {len(calls['mha'])} K3 shapes; attention at "
            f"{sorted({s[2] for s in calls['mha']})}")
        check(per_step == LAUNCHES_PER_STEP,
              f"64² dispatches per step {per_step} != {LAUNCHES_PER_STEP}")
        steps[b] = calls
        del model
    gn = {**steps[2]["gn"], **steps[CELEBA_BATCH]["gn"]}
    mha = {**steps[2]["mha"], **steps[CELEBA_BATCH]["mha"]}
    log("[hold] K1 and K3 at the 64² training shapes (B=2 and 64):")
    errs = hold_kernels(gn, mha)
    log("[hold] K2 at the 64² training shapes (B=2 and 64):")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22)
    errs["gn_bwd"] = {}
    for dname in ("bfloat16", "float32"):
        for key in sorted({**steps[2]["gn_bwd"],
                           **steps[CELEBA_BATCH]["gn_bwd"]}):
            errs["gn_bwd"][(key, dname)] = hold_gn_bwd_one(key, dname, gen)
    return steps[CELEBA_BATCH], errs


def hold_grads(name, got_loss, want_loss, got, want, names) -> float:
    """Loss and every gradient within UNET_TOL abs + rel; returns the
    largest gradient error."""
    hold(f"{name} loss, card vs CPU", got_loss, want_loss, UNET_TOL)
    worst, bad = 0.0, []
    for n, g, w in zip(names, got, want):
        d = (g.cpu() - w).abs()
        worst = max(worst, float(d.max()))
        if not bool((d <= UNET_TOL + UNET_TOL * w.abs()).all()):
            bad.append(n)
    log(f"  {name} gradients, card vs CPU: {len(names)} tensors, max abs "
        f"err {worst:.3e} (tol {UNET_TOL:g} abs + {UNET_TOL:g} rel) "
        f"{'ok' if not bad else 'FAIL ' + ', '.join(bad[:5])}")
    check(not bad, f"{name}: gradients disagree with the CPU: {bad[:5]}")
    return worst


def option_pair(cfg, tmp: Path, training=None, **model_extra):
    """The same f32 full-width model (32², dropout off, seeded zero
    leaves) in a DDPMTrainer on the card and on the CPU."""
    import torch
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.trainers import DDPMTrainer
    mcfg = dict(cfg, compute_dtype="float32", dropout=0.0, **model_extra)
    card = DDPM(mcfg, device=DEVICE, seed=SEED, trainable=True)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in card.net.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    cpu = DDPM(mcfg, device="cpu", seed=SEED, trainable=True)
    cpu.net.load_state_dict(card.net.state_dict())
    out = []
    for model, where in ((card, "card"), (cpu, "cpu")):
        run_cfg = train_config(str(tmp / where), **(training or {}))
        out.append(DDPMTrainer(model, [None] * 5, None, None, run_cfg,
                               seed=SEED))
    return out


def bf16_close(name, got, want, slack) -> float:
    """Each bf16 tensor of ``got`` within one bf16 ulp of
    max(|got|, |want|) + its ``slack`` tensor of ``want``'s: the f32 values
    they round from differ by the step's own error, which can flip a
    rounding. Returns the largest distance in ulps beyond the slack."""
    import torch
    worst = 0.0
    for g, w, sl in zip(got, want, slack):
        g, w = g.detach().float().cpu(), w.detach().float()
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        d = ((g - w).abs() - sl).clamp_min(0.0) / ulp
        worst = max(worst, float(d.max()))
    log(f"  {name}: at most {worst:.2f} bf16 ulp apart beyond the slack "
        f"{'ok' if worst <= 1 else 'FAIL'}")
    check(all(g.dtype == w.dtype for g, w in zip(got, want))
          and worst <= 1, f"{name} differs by more than a bf16 ulp")
    return worst


def hold_option_steps(cfg):
    """Phase 14a: one f32 training step card vs CPU at B=2 with
    ``remat_policy: save_convout``; one accumulated update of two
    micro-batches of 2 (``grad_accum_steps: 2``); then three steps with
    ``ema_dtype`` and ``adam_mu_dtype: bfloat16``, each from the CPU's
    state (weights, μ, ν, EMA copied to the card first: Adam's ±lr step
    on a near-zero gradient sends two trajectories apart), after each of
    which the bf16 μ and EMA must be within one bf16 ulp of the CPU's,
    beyond a slack for the f32 step's own error: for μ 1e-3·|μ| +
    (1 − b1)·1e-6 (the step's gradients agree within 1e-6 abs: measured
    ≤ 8.2e-8); for the EMA 1e-6, or 2·lr where the CPU's |μ| < 1e-6."""
    import torch
    tmp = Path(tempfile.mkdtemp(prefix="dmu_options_"))
    out = {}
    try:
        card, cpu = option_pair(cfg, tmp, remat_policy="save_convout")
        x, t, noise = step_inputs(2, 32, SEED + 23, card.model.num_timesteps)
        want_loss, want = grads_of_step(cpu.model, x, t, noise)
        got_loss, got = grads_of_step(card.model, x.to(DEVICE), t.to(DEVICE),
                                      noise.to(DEVICE))
        out["save_convout_grad_err"] = hold_grads(
            "save_convout f32 step", got_loss, want_loss, got, want,
            card.param_names)
        card.cleanup()
        cpu.cleanup()
        card, cpu = option_pair(cfg, tmp, {"grad_accum_steps": 2},
                                remat=False)
        mbs = [step_inputs(2, 32, SEED + 24 + i, card.model.num_timesteps)
               for i in range(2)]
        results = []
        for tr, dev in ((cpu, "cpu"), (card, DEVICE)):
            loss, grads = tr._loss_and_grads(
                [x.to(dev) for x, _, _ in mbs], 0,
                [{"t": t.to(dev), "noise": n.to(dev)} for _, t, n in mbs])
            results.append((loss.detach().cpu(), [g.cpu() for g in grads]))
        out["accum_grad_err"] = hold_grads(
            "grad_accum_steps 2 (2 × B=2) f32 update", results[1][0],
            results[0][0], results[1][1], results[0][1], card.param_names)
        card.cleanup()
        cpu.cleanup()
        card, cpu = option_pair(cfg, tmp, {"ema_dtype": "bfloat16",
                                           "adam_mu_dtype": "bfloat16"},
                                remat=False)
        lr = float(card.training_cfg["learning_rate"])
        check(all(v.dtype == torch.bfloat16
                  for v in card.ema + card.optimizer.mu),
              "the EMA or μ is not bf16")
        out["mu_ulps"], out["ema_ulps"] = [], []
        for k in range(1, 4):
            x, t, noise = step_inputs(2, 32, SEED + 25 + k,
                                      card.model.num_timesteps)
            with torch.no_grad():
                for dst, src in zip(
                        card.params + card.optimizer.mu + card.optimizer.nu
                        + card.ema, cpu.params + cpu.optimizer.mu
                        + cpu.optimizer.nu + cpu.ema):
                    dst.copy_(src)
            cpu.step(x, t=t, noise=noise)
            card.step(x.to(DEVICE), t=t.to(DEVICE), noise=noise.to(DEVICE))
            mu = [m.float() for m in cpu.optimizer.mu]
            out["mu_ulps"].append(bf16_close(
                f"bf16 μ after step {k}, card vs CPU", card.optimizer.mu,
                cpu.optimizer.mu,
                [1e-3 * m.abs() + (1 - card.optimizer.b1) * 1e-6
                 for m in mu]))
            out["ema_ulps"].append(bf16_close(
                f"bf16 EMA after step {k}, card vs CPU", card.ema, cpu.ema,
                [torch.where(m.abs() < 1e-6, 2 * lr, 1e-6) for m in mu]))
        card.cleanup()
        cpu.cleanup()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def write_mnist(root: Path, n_train: int, n_test: int) -> None:
    """MNIST's four gzipped IDX files, images and labels from the seed."""
    import gzip
    import struct
    import numpy as np
    rng = np.random.default_rng(SEED + 30)
    root.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:28, 0:28]
    for split, n in (("train", n_train), ("t10k", n_test)):
        cy, cx = rng.uniform(8, 20, (2, n, 1, 1))
        r = rng.uniform(3, 8, (n, 1, 1))
        ring = np.abs(np.hypot(yy - cy, xx - cx) - r) < 1.5
        images = (ring * rng.integers(128, 256, (n, 1, 1))).astype(np.uint8)
        for kind, head, data in (
                ("images-idx3", struct.pack(">IIII", 2051, n, 28, 28),
                 images),
                ("labels-idx1", struct.pack(">II", 2049, n),
                 rng.integers(0, 10, n).astype(np.uint8))):
            with gzip.open(root / f"{split}-{kind}-ubyte.gz", "wb") as f:
                f.write(head + data.tobytes())


def mnist_cli():
    """Phase 14b: ``train`` at full width on MNIST IDX files written from
    the seed, with grad_accum_steps 2, bf16 EMA and μ, remat_policy
    save_convout, track_histograms and ``--profile`` (3 updates): the
    trace names K1, K2 and K3, histograms are logged, the checkpoint keeps
    bf16 state, and K1–K3 launch exactly as counted."""
    import torch
    import yaml
    from diffusion_model_universal_torch.utils.checkpoint import read_state
    tmp = Path(tempfile.mkdtemp(prefix="dmu_mnist_"))
    n_train, n_test = MNIST_SIZES
    pool = n_train * 9 // 10              # data_config: train 0.9, val 0.1
    micro = pool // TRAIN_BATCH            # micro-batches an epoch
    a = OPTION_TRAINING["grad_accum_steps"]
    updates = -(-micro // a)
    warm = 1 + MNIST_PROFILE_STEPS         # updates --profile takes
    val_interval = warm + updates          # once, at the epoch's end
    hist_steps = [s for s in range(warm, warm + updates)
                  if s % MNIST_HISTOGRAM_FREQ == 0]
    evals = (-(-(n_train - pool) // TRAIN_BATCH)
             + -(-n_test // TRAIN_BATCH))  # val and test forwards
    train_micro = warm * a + micro + len(hist_steps) * a
    want = {"dmu_group_norm_silu_fwd": LAUNCHES_PER_STEP["gn"] * train_micro
            + 53 * evals,
            "dmu_group_norm_silu_bwd": LAUNCHES_PER_STEP["gn_bwd"]
            * train_micro,
            "dmu_mha_fwd": LAUNCHES_PER_STEP["mha"] * train_micro + 5 * evals}
    try:
        write_mnist(tmp / "mnist", n_train, n_test)
        cfg = train_config(str(tmp), **OPTION_TRAINING, num_epochs=1,
                           val_interval=val_interval, sample_interval=0,
                           checkpoint_interval=1)
        cfg["data"] = dict(cfg["data"], dataset="MNIST",
                           data_dir=str(tmp / "mnist"))
        cfg["model_config"] = dict(cfg["model_config"],
                                   remat_policy="save_convout")
        cfg["logging"] = dict(cfg["logging"], track_histograms=True,
                              log_interval=1,
                              gradient_logging_freq=MNIST_HISTOGRAM_FREQ)
        path = tmp / "mnist.yaml"
        path.write_text(yaml.safe_dump(cfg))
        log(f"[cli] MNIST {n_train}+{n_test} images: {micro} micro-batches of "
            f"{TRAIN_BATCH} an epoch, {updates} updates of A={a}; --profile "
            f"{MNIST_PROFILE_STEPS} (+1 warm-up); histograms at steps "
            f"{hist_steps}; {evals} eval forwards")
        t0 = time.perf_counter()
        out = run_cli("train", ["--config", str(path), "--model_type", "ddpm",
                                "--seed", str(SEED), "--profile",
                                str(tmp / "trace"), "--profile_steps",
                                str(MNIST_PROFILE_STEPS)],
                      "train MNIST with every option, --profile")
        secs = time.perf_counter() - t0
        launches = json.loads(out.split("Kernel launches: ")[1]
                              .splitlines()[0])
        got = {k: launches.get(k, 0) for k in want}
        log(f"[cli] MNIST launches {got}, counted {want}")
        check(got == want, f"MNIST launches {got} != {want}")
        traces = list((tmp / "trace").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"profiler traces {traces}")
        text = traces[0].read_text()
        named = {tag: text.count(tag) for tag in
                 ("gn_fwd_kernel", "gn_bwd_kernel", "mha_fwd")}
        check(all(named.values()), f"the trace misses a kernel: {named}")
        rows = [json.loads(line) for line in
                (tmp / "out" / "metrics.jsonl").read_text().splitlines()]
        hist = sorted(r["step"] for r in rows
                      if any(k.endswith("_hist/mean") for k in r))
        check(hist == hist_steps, f"histograms at steps {hist}")
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        check(len(losses) == updates
              and all(math.isfinite(v) for v in losses),
              f"logged losses {losses}")
        final = read_state(str(tmp / "out" / "checkpoints" / "final_model"))
        check(final["step"] == warm + updates
              and {v.dtype for v in final["ema_params"].values()}
              == {m.dtype for m in final["opt_state"]["mu"]}
              == {torch.bfloat16},
              f"final_model step {final['step']} or its state's dtypes")
        log(f"[cli] MNIST trace {traces[0].stat().st_size / 1e6:.1f} MB names "
            f"{named}; histograms at {hist}; {len(losses)} losses, first "
            f"{losses[0]:.4f} last {losses[-1]:.4f}; final_model at step "
            f"{final['step']} with bf16 EMA and μ")
        return {"launches": launches, "counted": want, "seconds": secs,
                "trace_names": named, "histogram_steps": hist,
                "losses": [losses[0], losses[-1]]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def write_celeba(root: Path, n: int) -> None:
    """A celeba_128.npz of ``n`` smooth seeded 128² images with the
    official split ids (80/10/10)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 31)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32) / 128.0
    f = rng.uniform(2.0, 9.0, (n, 1, 1, 3)).astype(np.float32)
    ph = rng.uniform(0.0, 6.3, (n, 1, 1, 3)).astype(np.float32)
    images = (127.5 + 100.0 * np.sin(f * (xx[..., None] + yy[..., None])
                                     + ph)).astype(np.uint8)
    splits = np.repeat(np.array([0, 1, 2], np.int32),
                       [n * 8 // 10, n // 10, n - n * 8 // 10 - n // 10])
    np.savez(root / "celeba_128.npz", images=images, splits=splits)


def celeba_training(cfg):
    """Phase 14c: CelebA at 64² in-process (the CLI reads the packaged
    data config, which has no rotation, crop or jitter): a celeba_128.npz
    written from the seed, shrunk to 64² on load, CELEBA_TRANSFORMS in the
    loader on the card, the config's UNet at image_size 64, B=64, bf16
    autocast, remat on: CELEBA_STEPS timed steps with exact K1–K3
    launches, a profiled window (device busy share), and the loader's
    device ms for rotation + crop + jitter at B=LOADER_TIME_BATCH."""
    import torch
    import yaml
    from diffusion_model_universal_torch.datasets import get_dataset
    from diffusion_model_universal_torch.datasets import pipeline as tp
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    from diffusion_model_universal_torch.trainers import DDPMTrainer
    from diffusion_model_universal_torch.utils.config import (
        default_data_config_path, load_data_config)
    tmp = Path(tempfile.mkdtemp(prefix="dmu_celeba_"))
    try:
        write_celeba(tmp, CELEBA_IMAGES)
        block = dict(load_data_config(default_data_config_path(), "celeba"),
                     data_dir=str(tmp), transforms=CELEBA_TRANSFORMS)
        data_cfg = tmp / "data.yaml"
        data_cfg.write_text(yaml.safe_dump({"datasets": {"celeba": block}}))
        run_cfg = train_config(str(tmp), batch_size=CELEBA_BATCH)
        run_cfg["data"] = dict(run_cfg["data"], dataset="celeba",
                               data_dir=str(tmp))
        t0 = time.perf_counter()
        model = DDPM(dict(cfg, image_size=64), device=DEVICE, seed=SEED,
                     trainable=True)
        loaders = get_dataset(run_cfg, data_config_path=str(data_cfg),
                              device=model.device)
        load_s = time.perf_counter() - t0
        trainer = DDPMTrainer(model, *loaders, run_cfg, seed=SEED)
        sizes = [len(getattr(ld, "loader", ld).images) for ld in loaders]
        kernels = {"gn": gn_ops.GN_KERNEL, "gn_bwd": gn_ops.GN_BWD_KERNEL,
                   "mha": attn_ops.MHA_KERNEL}
        batches = []
        it = iter(loaders[0])
        for _ in range(3 + CELEBA_STEPS):
            batches.append(next(it))
        del it
        x = batches[0]
        check(tuple(x.shape) == (CELEBA_BATCH, 64, 64, 3)
              and bool(x.isfinite().all())
              and float(x.abs().max()) <= 1.0 + 1e-6,
              f"CelebA batch {tuple(x.shape)}")
        for b in batches[:3]:
            trainer.step(b)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        for b in batches[3:]:
            metrics = trainer.step(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: k.launches for n, k in kernels.items()}
        want = {n: CELEBA_STEPS * c for n, c in LAUNCHES_PER_STEP.items()}
        check(launches == want, f"CelebA launches {launches} != {want}")
        check(bool(metrics["loss"].isfinite()), "CelebA loss not finite")
        step = {"steps": CELEBA_STEPS, "batch": CELEBA_BATCH,
                "ms_per_step": secs / CELEBA_STEPS * 1e3,
                "images_per_s": CELEBA_BATCH * CELEBA_STEPS / secs,
                "launches": launches,
                "last_loss": float(metrics["loss"])}
        log(f"[train] CelebA 64² ({sizes} train/val/test images, loaded and "
            f"shrunk in {load_s:.1f} s): {CELEBA_STEPS} steps at "
            f"B={CELEBA_BATCH} bf16: {step['ms_per_step']:.2f} ms/step, "
            f"{step['images_per_s']:.1f} img/s; launches {launches}")
        prof = profile_run(lambda: trainer.step(x), 3,
                           f"CelebA 64² training step B={CELEBA_BATCH}")
        trainer.cleanup()
        del trainer, model
        aug = tp.make_augment_fn(CELEBA_TRANSFORMS[2:5], [0.5] * 3,
                                 [0.5] * 3, train=True)
        raw = torch.randint(0, 256, (LOADER_TIME_BATCH, 64, 64, 3),
                            dtype=torch.uint8, device=DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 32)
        loader_ms = cuda_ms(lambda: aug(raw, gen), iters=20, reps=5)
        log(f"[time] loader rotation + crop + jitter at B={LOADER_TIME_BATCH} "
            f"64²: {loader_ms:.3f} ms a batch (device)")
        return {"images": sizes, "load_s": load_s, "step": step,
                "profile": prof, "loader_ms": loader_ms}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def time_options(cfg):
    """Phase 14d: ms per update and images/s at B=128 (32², bf16
    autocast, remat on) for A=1 and A=2, in turns; then, for no remat,
    full remat and save_convout: ms per step, the peak
    ``max_memory_allocated`` of a whole step and of one forward +
    backward alone (above the resident weights and Adam state), what the
    forward leaves held for the backward, and the convolutions one forward + backward computes (``aten::_convolution``
    in a CPU-side profile: full remat recomputes the stages' convs,
    save_convout keeps their outputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from diffusion_model_universal_torch.datasets import get_dataset
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.trainers import DDPMTrainer
    from diffusion_model_universal_torch.utils.profiling import (
        device_memory_stats)
    tmp = tempfile.mkdtemp(prefix="dmu_options_time_")
    out = {"accum": {}, "remat": {}}
    try:
        run_cfg = train_config(tmp)

        def trainer_for(**model_extra):
            model = DDPM(dict(cfg, **model_extra), device=DEVICE, seed=SEED,
                         trainable=True)
            loaders = get_dataset(run_cfg, device=model.device)
            return DDPMTrainer(model, *loaders, run_cfg, seed=SEED)

        trainer = trainer_for()
        batch = next(iter(trainer.train_loader))

        def timed(chunk, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.accum_step(chunk)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3

        for a in (1, 2):
            timed([batch] * a, 3)
        runs = {1: [], 2: []}
        for order in ((1, 2), (2, 1)):
            for a in order:
                runs[a].append(timed([batch] * a, 10))
        for a, ms in runs.items():
            out["accum"][f"A={a}"] = {
                "ms_per_update": ms, "images_per_s": [
                    a * TRAIN_BATCH / v * 1e3 for v in ms]}
            log(f"[train] A={a} at B={TRAIN_BATCH}: {ms} ms an update "
                f"(two runs of 10), "
                f"{[round(a * TRAIN_BATCH / v * 1e3, 1) for v in ms]} img/s")
        trainer.cleanup()
        del trainer
        for name, extra in (("none", {"remat": False}),
                            ("full", {"remat": True}),
                            ("save_convout", {"remat_policy":
                                              "save_convout"})):
            torch.cuda.empty_cache()
            trainer = trainer_for(**extra)
            timed([batch], 2)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss = trainer.model.loss_function(
                    batch, generator=trainer._generator(trainer.step_count))
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated() - base
                torch.autograd.grad(loss, trainer.params)
                torch.cuda.synchronize()
                del loss
            fwd_bwd = device_memory_stats()["peak_bytes_in_use"] - base
            convs = sum(e.count for e in prof.key_averages()
                        if e.key == "aten::_convolution")
            torch.cuda.reset_peak_memory_stats()
            ms = timed([batch], 5)
            peak = device_memory_stats()["peak_bytes_in_use"]
            out["remat"][name] = {"ms_per_step": ms, "peak_bytes": peak,
                                  "resident_bytes": base,
                                  "fwd_bwd_peak_above_resident": fwd_bwd,
                                  "held_after_forward": held,
                                  "convolutions_fwd_bwd": convs}
            log(f"[train] remat {name} at B={TRAIN_BATCH}: {ms:.2f} ms a "
                f"step, step peak {peak / 2 ** 30:.3f} GiB "
                f"({base / 2 ** 30:.3f} GiB resident), one forward + "
                f"backward {fwd_bwd / 2 ** 30:.3f} GiB above resident, "
                f"{held / 2 ** 30:.3f} GiB held for the backward after the "
                f"forward, {convs} convolutions computed")
            trainer.cleanup()
            del trainer
        convs = {k: v["convolutions_fwd_bwd"] for k, v in out["remat"].items()}
        check(convs["save_convout"] == convs["none"] < convs["full"],
              f"save_convout recomputed convolutions: {convs}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def data_and_options(cfg):
    """Phase 14: MNIST and CelebA, the transforms and the trainer's
    options."""
    t0 = time.perf_counter()
    log("[hold] phase 14a: transforms, 64² kernels and the options' steps "
        "on the card against the CPU:")
    errs = {"transforms": hold_transforms()}
    calls64, kernel_errs = hold_celeba_kernels(cfg)
    errs["steps"] = hold_option_steps(cfg)
    t1 = time.perf_counter()
    cli = mnist_cli()
    t2 = time.perf_counter()
    celeba = celeba_training(cfg)
    t3 = time.perf_counter()
    times = time_options(cfg)
    k1, k3 = time_kernels(calls64["gn"], calls64["mha"])
    k2 = time_gn_bwd(calls64["gn_bwd"])
    t4 = time.perf_counter()
    secs = {"14a": t1 - t0, "14b": t2 - t1, "14c": t3 - t2, "14d": t4 - t3,
            "total": t4 - t0}
    log(f"[phase 14] data and options: {secs['total']:.1f} s (14a "
        f"{secs['14a']:.1f}, 14b {secs['14b']:.1f}, 14c {secs['14c']:.1f}, "
        f"14d {secs['14d']:.1f})")
    return {"card_vs_cpu": errs, "kernel_errs": kernel_errs, "cli": cli,
            "celeba": celeba, "times": times,
            "celeba64_rows": {"gn": k1, "gn_bwd": k2, "mha": k3},
            "celeba64_calls": {k: sum(calls64[k].values())
                               for k in LAUNCHES_PER_STEP},
            "seconds": secs}


# -- data parallelism (phase 15) --------------------------------------------

DP_RANKS = 2                # gloo ranks sharing the card in 15b
#: The synthetic set of phase 15: 1,024 train images (8 updates of 128),
#: 128 validation and 128 test images.
DP_SAMPLES = 1280
DP_UPDATES = 3              # bf16 updates whose replicas must be bit-equal
DP_TIME_UPDATES = 5         # timed updates (15c), after DP_UPDATES
DP_PREEMPT_AFTER = 2        # train() updates before rank 1's SIGTERM
DP_SYMBOLS = {"gn": "dmu_group_norm_silu_fwd",
              "gn_bwd": "dmu_group_norm_silu_bwd", "mha": "dmu_mha_fwd"}


def dp_config(out_dir: str, **model_extra):
    """ddpm_config.yaml at full width for phase 15: the synthetic set of
    ``DP_SAMPLES``, one epoch, no validation, grids or periodic
    checkpoints, and ``model_extra`` over its model section."""
    cfg = train_config(out_dir, num_epochs=1, val_interval=0,
                       sample_interval=0, checkpoint_interval=0)
    cfg["data"]["num_samples"] = DP_SAMPLES
    cfg["model_config"] = dict(cfg["model_config"], **model_extra)
    return cfg


def dp_trainer(run_cfg, device, split=None):
    """A DDPMTrainer of ``run_cfg`` on ``device`` (a rank's rows of each
    batch with ``split``)."""
    from diffusion_model_universal_torch.datasets import get_dataset
    from diffusion_model_universal_torch.models import DDPM
    from diffusion_model_universal_torch.trainers import DDPMTrainer
    model = DDPM(run_cfg["model_config"], device=device, seed=SEED,
                 trainable=True)
    loaders = get_dataset(run_cfg, device=model.device, split=split)
    return DDPMTrainer(model, *loaders, run_cfg, seed=SEED)


def replica_digest(trainer) -> str:
    from diffusion_model_universal_torch.scripts.train import params_digest
    return params_digest([*trainer.params, *trainer.ema,
                          *trainer.optimizer.mu])


def timed_updates(trainer, updates, n: int) -> float:
    """ms an update over ``n`` updates from ``updates``, host clock
    between synchronizes."""
    import torch
    cuda = trainer.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.accum_step(next(updates))
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def dp_rank(device, out_dir: str, f32_cfg, bf16_cfg) -> int:
    """Phase 15b on one rank: one f32 update of ``f32_cfg``; then, of
    ``bf16_cfg``, ``validate()``, ``DP_UPDATES`` updates with
    the replica's digest after each and the kernels' launches over them,
    ``DP_TIME_UPDATES`` timed updates, and ``train()`` with a SIGTERM to
    rank 1 alone after ``DP_PREEMPT_AFTER`` of its updates. Writes
    ``out_dir/rank{r}.pt``; returns 143 when preempted."""
    import signal
    import torch
    from diffusion_model_universal_torch.ops._build import (KERNELS,
                                                            launch_counts)
    from diffusion_model_universal_torch.parallel import mesh
    from diffusion_model_universal_torch.scripts.train import params_digest
    # A spawned process starts from PyTorch's defaults: TF32 off as in
    # main(), so that its f32 convolutions are f32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r, n = mesh.rank(), mesh.world_size()
    out = {}
    tr = dp_trainer(f32_cfg, device, (r, n))
    m = tr.accum_step(next(tr._updates(tr.train_loader)))
    out["f32"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                  "layer_grad_norms": [float(v) for v in
                                       m["layer_grad_norms"].values()],
                  "mu": [v.cpu() for v in tr.optimizer.mu] if r == 0 else None,
                  "digest": replica_digest(tr)}
    tr.cleanup()
    del tr, m
    if device.type == "cuda":
        torch.cuda.empty_cache()

    tr = dp_trainer(bf16_cfg, device, (r, n))
    out["val"] = tr.validate()
    updates = tr._updates(tr.train_loader)
    for k in KERNELS.values():
        k.launches = 0
    digests = []
    for _ in range(DP_UPDATES):
        tr.accum_step(next(updates))
        digests.append(replica_digest(tr))
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["digests"] = digests
    counts = launch_counts()
    out["launches"] = {k: counts.get(s, 0) for k, s in DP_SYMBOLS.items()}
    mesh.barrier()
    out["ms_per_update"] = timed_updates(tr, updates, DP_TIME_UPDATES)
    updates.close()
    # The update's all-reduce alone: the f32 gradients' bytes.
    grads = [p.detach().clone() for p in tr.params]
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(DP_TIME_UPDATES):
        mesh.all_reduce_sum_(grads)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) / DP_TIME_UPDATES * 1e3
    del grads

    if r == 1:
        step, seen = tr.accum_step, []

        def accum_step(chunk, draws=None):
            result = step(chunk, draws)
            seen.append(1)
            if len(seen) == DP_PREEMPT_AFTER:
                os.kill(os.getpid(), signal.SIGTERM)
            return result
        tr.accum_step = accum_step
    saves, save = [], tr.ckpt.save

    def counting_save(name, state):
        saves.append(name)
        return save(name, state)
    tr.ckpt.save = counting_save
    tr.train(1)
    tr.cleanup()
    out.update(preempted=tr.preempted, step=tr.step_count, saves=saves,
               digest_at_preemption=params_digest(tr.params))
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    return 143 if tr.preempted else 0


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_resume(run_dir: Path, step: int, digest: str):
    """15a and the end of 15b: ``train --multihost --resume latest`` under
    a torchrun environment of world 1, one process on NCCL, from the
    checkpoint 15b's ranks saved at ``step``: it must print the ranks'
    parameter digest, then train an epoch at full width (B=128, bf16,
    remat) and the test batch, launching K1–K3 exactly as counted."""
    import yaml
    cfg = dp_config(str(run_dir), dropout=0.0)
    cfg["training"]["num_epochs"] = 2
    cfg_path = run_dir / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    out = run_cli("train", ["--config", str(cfg_path), "--model_type",
                            "ddpm", "--seed", str(SEED), "--multihost",
                            "--resume", "latest"],
                  "train --multihost --resume latest (torchrun environment, "
                  "world 1)", env=env)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    check(f"Data parallel: 1 ranks over {backend}, global batch "
          f"{TRAIN_BATCH} ({TRAIN_BATCH} a rank)" in out,
          f"train --multihost did not report {backend}")
    want_line = (f"Resumed from epoch 1 at step {step} (params sha256 "
                 f"{digest})")
    check(want_line in out, f"resume line missing: {want_line}")
    launches = json.loads(out.split("Kernel launches (rank 0 of 1): ")[1]
                          .splitlines()[0])
    updates = DP_SAMPLES * 8 // 10 // TRAIN_BATCH
    want = {s_: updates * LAUNCHES_PER_STEP[k] + {"gn": 53, "gn_bwd": 0,
                                                  "mha": 5}[k]
            for k, s_ in DP_SYMBOLS.items()}
    got = {s_: launches[s_] for s_ in want}
    check(got == want, f"train --multihost launches {got} != {want} "
                       f"({updates} updates, one test forward)")
    log(f"[dp] one process on {backend} resumed the ranks' checkpoint at "
        f"step {step} with their params sha256, then {updates} updates "
        f"and the test batch launched {got}, as counted")
    return {"launches": launches}


def nccl_exact_update():
    """15a: one f32 update (dropout 0.1) of the plain trainer, then of the
    data-parallel trainer in a NCCL group of world 1, on the same batch,
    draws and dropout state: the loss, the norms and every parameter and
    moment must be bit-equal (cuDNN deterministic)."""
    import torch
    from diffusion_model_universal_torch.parallel import mesh
    tmp = tempfile.mkdtemp(prefix="dmu_nccl_")
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    results = []
    try:
        run_cfg = dp_config(tmp, compute_dtype="float32")
        for joined in (False, True):
            if joined:
                mesh.init_process_group(0, 1, torch.device(DEVICE, 0)
                                        if DEVICE == "cuda"
                                        else torch.device("cpu"),
                                        f"tcp://localhost:{free_port()}")
            tr = dp_trainer(run_cfg, DEVICE)
            check(tr.data_parallel == joined, "data_parallel flag")
            m = tr.accum_step(next(tr._updates(tr.train_loader)))
            results.append({"loss": m["loss"].cpu(),
                            "grad_norm": m["grad_norm"].cpu(),
                            "state": [v.detach().cpu() for v in (
                                *tr.params, *tr.ema, *tr.optimizer.mu,
                                *tr.optimizer.nu)],
                            "backend": mesh.backend()})
            tr.cleanup()
            del tr, m
    finally:
        mesh.shutdown()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev
        shutil.rmtree(tmp, ignore_errors=True)
    plain, dp = results
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        [plain["loss"], plain["grad_norm"], *plain["state"]],
        [dp["loss"], dp["grad_norm"], *dp["state"]])]
    exact = max(diffs) == 0.0
    log(f"[dp] 15a: one f32 update, plain trainer vs data-parallel over "
        f"{dp['backend']} at world 1: loss {float(plain['loss']):.8f} vs "
        f"{float(dp['loss']):.8f}; max |diff| over loss, norm, params, EMA, "
        f"μ, ν: {max(diffs):.3e} "
        f"({'bit-equal' if exact else 'NOT bit-equal'})")
    if DEVICE == "cuda":
        check(dp["backend"] == "nccl", f"backend {dp['backend']}")
    check(max(diffs) <= UNET_TOL, "the data-parallel update at world 1 "
                                  "strays from the plain one")
    return {"bit_equal": exact, "max_abs_diff": max(diffs),
            "backend": dp["backend"]}


def dp_references():
    """One process on the same data as 15b's ranks: the f32 update, the
    bf16 ``validate()`` and ms an update (after ``DP_UPDATES``)."""
    import torch
    tmp = tempfile.mkdtemp(prefix="dmu_dp_ref_")
    try:
        tr = dp_trainer(dp_config(tmp, compute_dtype="float32", dropout=0.0),
                        DEVICE)
        m = tr.accum_step(next(tr._updates(tr.train_loader)))
        ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "layer_grad_norms": [float(v) for v in
                                    m["layer_grad_norms"].values()],
               "mu": [v.cpu() for v in tr.optimizer.mu]}
        tr.cleanup()
        del tr, m
        tr = dp_trainer(dp_config(tmp, dropout=0.0), DEVICE)
        ref["val"] = tr.validate()
        updates = tr._updates(tr.train_loader)
        for _ in range(DP_UPDATES):
            tr.accum_step(next(updates))
        ref["ms_per_update"] = timed_updates(tr, updates, DP_TIME_UPDATES)
        updates.close()
        tr.cleanup()
        del tr
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        return ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def two_ranks(ref):
    """15b and 15c: ``DP_RANKS`` gloo ranks spawned by the port's
    launcher on the card, held against one process (``ref``); the
    preemption agreement; ``train --multihost --resume`` of the
    checkpoint the ranks saved (:func:`multihost_resume`)."""
    import torch
    from diffusion_model_universal_torch.parallel import mesh
    tmp = Path(tempfile.mkdtemp(prefix="dmu_ranks_"))
    try:
        t0 = time.perf_counter()
        rc = mesh.spawn(dp_rank, DP_RANKS, args=(
            str(tmp), dp_config(str(tmp), compute_dtype="float32",
                                dropout=0.0),
            dp_config(str(tmp), dropout=0.0)), device_type=DEVICE,
            backend="gloo", rendezvous_dir=str(tmp))
        secs = time.perf_counter() - t0
        log(f"[dp] 15b: {DP_RANKS} gloo ranks on {DEVICE} returned {rc} in "
            f"{secs:.1f} s")
        check(rc == 143, f"the launcher returned {rc}, not 143, after rank "
                         f"1's SIGTERM")
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
        f32 = ranks[0]["f32"]
        errs = {"loss": hold("f32 update loss, 2 ranks vs 1 process",
                             torch.tensor(f32["loss"]),
                             torch.tensor(ref["loss"]), 0.0, 1e-5),
                "grad_norm": hold("f32 global gradient norm",
                                  torch.tensor(f32["grad_norm"]),
                                  torch.tensor(ref["grad_norm"]), 0.0, 1e-4),
                "layer_grad_norms": hold(
                    "f32 per-layer gradient norms",
                    torch.tensor(f32["layer_grad_norms"]),
                    torch.tensor(ref["layer_grad_norms"]), 1e-8, 1e-4),
                "mu": max(float((a - b).abs().max())
                          for a, b in zip(f32["mu"], ref["mu"]))}
        mu_ok = all(bool(((a - b).abs() <= 1e-7 + 1e-3 * b.abs()).all())
                    for a, b in zip(f32["mu"], ref["mu"]))
        log(f"  f32 Adam μ, all {len(ref['mu'])} tensors: max_abs_err="
            f"{errs['mu']:.3e} (tol 1e-07 abs + 0.001 rel) "
            f"{'ok' if mu_ok else 'FAIL'}")
        check(mu_ok, "f32 Adam μ of 2 ranks vs 1 process beyond rtol 1e-3")
        check(ranks[0]["f32"]["digest"] == ranks[1]["f32"]["digest"],
              "the f32 replicas differ after one update")
        for r_, r in enumerate(ranks):
            errs.setdefault("val", []).append(hold(
                f"validate() bf16, rank {r_} of {DP_RANKS} vs one process",
                torch.tensor(r["val"], dtype=torch.float64),
                torch.tensor(ref["val"], dtype=torch.float64), 0.0, 1e-6))
        check(ranks[0]["digests"] == ranks[1]["digests"]
              and len(set(ranks[0]["digests"])) == DP_UPDATES,
              "the bf16 replicas are not bit-equal after each update")
        want = {k: DP_UPDATES * c for k, c in LAUNCHES_PER_STEP.items()}
        for r, got in enumerate(x["launches"] for x in ranks):
            if DEVICE == "cuda":
                check(got == want, f"rank {r} launched {got} in "
                                   f"{DP_UPDATES} updates, not {want}")
        log(f"[dp] 15b: bf16 replicas bit-equal after each of {DP_UPDATES} "
            f"updates (params, EMA, μ); launches on each rank "
            f"{[x['launches'] for x in ranks]} = {DP_UPDATES} × "
            f"{LAUNCHES_PER_STEP}")
        steps = {x["step"] for x in ranks}
        check(all(x["preempted"] for x in ranks) and len(steps) == 1,
              f"preemption: {[(x['preempted'], x['step']) for x in ranks]}")
        check(ranks[0]["saves"] == ["checkpoint_epoch_0"]
              and not ranks[1]["saves"],
              f"checkpoint writes by rank: {[x['saves'] for x in ranks]}")
        check(ranks[0]["digest_at_preemption"]
              == ranks[1]["digest_at_preemption"],
              "the replicas differ at the preemption")
        step = steps.pop()
        log(f"[dp] 15b: SIGTERM to rank 1 alone: both ranks saved at step "
            f"{step}, rank 0 alone wrote checkpoint_epoch_0, the launcher "
            f"returned 143")
        cli = multihost_resume(tmp, step, ranks[0]["digest_at_preemption"])
        ms = ranks[0]["ms_per_update"]
        log(f"[dp] 15c: {DP_RANKS} gloo ranks sharing one card: "
            f"{ms:.2f} ms an update of B={TRAIN_BATCH} "
            f"({TRAIN_BATCH // DP_RANKS} a rank; rank 1 "
            f"{ranks[1]['ms_per_update']:.2f}); one process "
            f"{ref['ms_per_update']:.2f} ms; the all-reduce of the f32 "
            f"gradients alone {ranks[0]['all_reduce_ms']:.2f} ms; "
            f"{card_line() if DEVICE == 'cuda' else 'cpu'}. This measures "
            f"{DP_RANKS} processes sharing one card through gloo, not "
            f"scaling.")
        return {"cli": cli, "errs": errs,
                "launches_per_rank": [x["launches"] for x in ranks],
                "step_at_preemption": step, "spawn_s": secs,
                "ms_per_update": {"ranks": [x["ms_per_update"]
                                            for x in ranks],
                                  "one_process": ref["ms_per_update"]},
                "all_reduce_ms": [x["all_reduce_ms"] for x in ranks]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_parallel():
    """Phase 15: data parallelism over torch.distributed."""
    t0 = time.perf_counter()
    log("[dp] phase 15a: NCCL at world size 1, in-process")
    exact = nccl_exact_update()
    t1 = time.perf_counter()
    log(f"[dp] phase 15b/c: {DP_RANKS} gloo ranks sharing the card against "
        f"one process; then train --multihost on NCCL resumes them")
    ranks = two_ranks(dp_references())
    t2 = time.perf_counter()
    secs = {"15a": t1 - t0, "15b": t2 - t1, "total": t2 - t0}
    log(f"[phase 15] data parallelism: {secs['total']:.1f} s (15a "
        f"{secs['15a']:.1f}, 15b/c with the --multihost resume "
        f"{secs['15b']:.1f})")
    return {"cli": ranks.pop("cli"), "nccl_world1": exact, "ranks": ranks,
            "seconds": secs}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")
    t_start = time.perf_counter()

    build_kernels()
    cfg = model_config()
    model = make_f32_model(cfg)
    log(f"[model] ddpm_config.yaml: C={cfg['model_channels']}, "
        f"T={cfg['num_timesteps']}, {cfg['image_size']}², "
        f"{sum(p.numel() for p in model.net.parameters())} parameters")
    gn_calls, mha_calls = record_shapes(model)
    per_forward = {"gn": sum(gn_calls.values()),
                   "mha": sum(mha_calls.values())}
    log(f"[shapes] one forward at B={SERVE_BATCH}: {per_forward['gn']} "
        f"GroupNorm calls over {len(gn_calls)} shapes, "
        f"{per_forward['mha']} attention calls over {len(mha_calls)} shapes")
    log("[hold] kernels against their plain versions at every shape:")
    errs = hold_kernels(gn_calls, mha_calls)
    hold_edges()
    unet_err = hold_unet(model)
    unet128 = hold_unet_128(cfg)

    serve_model, requests, launches = serve(model, cfg, per_forward)
    del model
    gn_rows, mha_rows = time_kernels(gn_calls, mha_calls)
    profile = profile_steps(serve_model)
    dispatch = time_dispatch(serve_model)
    del serve_model

    train_dir = tempfile.mkdtemp(prefix="dmu_trainer_")
    try:
        trainer, train_loader = make_trainer(cfg, train_dir)
        batch = next(iter(train_loader))
        check(tuple(batch.shape) == (TRAIN_BATCH, 32, 32, 3),
              f"training batch {tuple(batch.shape)}")
        calls = record_train_step(lambda: trainer.step(batch))
        per_step = {k: sum(calls[k].values()) for k in LAUNCHES_PER_STEP}
        log(f"[shapes] one training step at B={TRAIN_BATCH}: {per_step} "
            f"dispatches over {len(calls['gn'])} K1, {len(calls['gn_bwd'])}"
            f" K2 and {len(calls['mha'])} K3 shapes; K2 got a "
            f"non-contiguous dy {calls['dy_copies']} times")
        check(per_step == LAUNCHES_PER_STEP,
              f"dispatches per step {per_step} != {LAUNCHES_PER_STEP}")
        log("[hold] K2 against its plain version at every training shape:")
        bwd_errs = hold_gn_bwd(calls["gn_bwd"])
        log("[hold] K1 and K3 against their plain versions at every "
            "training shape:")
        train_errs = hold_kernels(calls["gn"], calls["mha"])
        step_check = hold_train_step(cfg)
        log("[hold] second derivatives on the card:")
        step_check["double_backward"] = hold_double_backward()
        cli = train_cli(len(train_loader))
        train_time = time_training(trainer, batch)
        train_profile = profile_run(lambda: trainer.step(batch), 5,
                                    f"training step B={TRAIN_BATCH}")
        k2_rows = time_gn_bwd(calls["gn_bwd"])
        k1_train, k3_train = time_kernels(calls["gn"], calls["mha"])
        trainer.cleanup()
        del trainer
    finally:
        shutil.rmtree(train_dir, ignore_errors=True)

    exp_entries, exp_summary = experiment_kernels()
    sampler_summary = samplers(per_forward)
    family_summary = families(per_forward)
    harness_summary = harness()
    options_summary = data_and_options(cfg)
    dp_summary = data_parallel()

    symbols = {"gn": "dmu_group_norm_silu_fwd",
               "gn_bwd": "dmu_group_norm_silu_bwd", "mha": "dmu_mha_fwd"}

    def by_sampler(kind):
        return {**{f"{r['model']} {json.dumps(r['request'])}":
                   r["launches"].get(kind, 0)
                   for r in sampler_summary["serve"]},
                **{f"{r['family']} {json.dumps(r['cut'])}":
                   r["launches"][kind] for r in family_summary["serve"]}}

    def by_path(kind):
        fam = {r["family"]: r["launches"][kind]
               for r in family_summary["serve"]}
        return {"serve": launches.get(kind),
                "train_cli": cli["launches"][symbols[kind]],
                "train_steps_in_process": train_time["launches"][kind],
                "score_serve_request": fam["score_based"],
                "score_train_cli": family_summary["cli"]["score_based"][
                    "launches"][symbols[kind]],
                "energy_serve_request": fam["energy_based"],
                "energy_train_cli": family_summary["cli"]["energy_based"][
                    "launches"][symbols[kind]],
                "benchmark_cli": harness_summary["cli"]["launches"][
                    symbols[kind]],
                "mnist_options_train_cli": options_summary["cli"][
                    "launches"][symbols[kind]],
                "celeba64_train_steps_in_process": options_summary["celeba"][
                    "step"]["launches"][kind],
                "dp_multihost_nccl_train_cli": dp_summary["cli"]["launches"][
                    symbols[kind]],
                **{f"dp_gloo_rank{r}_{DP_UPDATES}_updates": n[kind]
                   for r, n in enumerate(
                       dp_summary["ranks"]["launches_per_rank"])}}

    def celeba64(kind, errs):
        rows = options_summary["celeba64_rows"][kind]
        return {**totals(rows), "shapes": rows,
                "launches_per_train_step":
                    options_summary["celeba64_calls"][kind],
                "work": f"one 64² training step at B={CELEBA_BATCH}, bf16 "
                        "autocast, remat on: every shape times its calls "
                        "per step",
                "max_abs_err": max(errs.values())}

    kerrs = options_summary["kernel_errs"]

    train_work = (f"one training step at B={TRAIN_BATCH}, bf16 autocast, "
                  "remat on: every shape times its calls per step")
    serve_work = (f"one UNet forward at B={SERVE_BATCH}, bf16: every "
                  "main-path shape times its calls per forward")
    entries = [
        kernel_entry("group_norm_silu_fwd",
                     "diffusion_model_universal_torch/csrc/group_norm.cu",
                     GN_REPLACES, gn_rows, cli["launches"][symbols["gn"]],
                     {**errs["gn"], **train_errs["gn"]}, serve_work,
                     launches_per_forward=per_forward["gn"],
                     launches_per_train_step=per_step["gn"],
                     launches_by_path=by_path("gn"),
                     launches_per_request_by_sampler=by_sampler("gn"),
                     train={**totals(k1_train), "work": train_work,
                            "max_abs_err": max(train_errs["gn"].values()),
                            "shapes": k1_train},
                     celeba64_train=celeba64("gn", kerrs["gn"])),
        kernel_entry("group_norm_silu_bwd",
                     "diffusion_model_universal_torch/csrc/group_norm.cu",
                     GN_BWD_REPLACES, k2_rows,
                     cli["launches"][symbols["gn_bwd"]], bwd_errs,
                     train_work, launches_per_train_step=per_step["gn_bwd"],
                     launches_by_path=by_path("gn_bwd"),
                     launches_per_request_by_sampler=by_sampler("gn_bwd"),
                     tol_reductions="dγ, dβ, dtb: red_tol(n) = 1e-4·max(1, "
                                    "sqrt(n/1024)) abs + 1e-4 rel",
                     celeba64_train=celeba64("gn_bwd", kerrs["gn_bwd"])),
        kernel_entry("mha_fwd",
                     "diffusion_model_universal_torch/csrc/attention.cu",
                     MHA_REPLACES, mha_rows, cli["launches"][symbols["mha"]],
                     {**errs["mha"], **train_errs["mha"]}, serve_work,
                     launches_per_forward=per_forward["mha"],
                     launches_per_train_step=per_step["mha"],
                     launches_by_path=by_path("mha"),
                     launches_per_request_by_sampler=by_sampler("mha"),
                     train={**totals(k3_train), "work": train_work,
                            "max_abs_err": max(train_errs["mha"].values()),
                            "shapes": k3_train},
                     celeba64_train=celeba64("mha", kerrs["mha"])),
        *exp_entries,
    ]
    summary = {"requests": requests, "unet_max_abs_err": unet_err,
               "unet128": unet128,
               "profile": profile, "dispatch": dispatch,
               "train_step_check": step_check,
               "train_cli": cli, "train_time": train_time,
               "train_profile": train_profile,
               "experiment_kernels": exp_summary,
               "samplers": sampler_summary,
               "families": family_summary,
               "harness": harness_summary,
               "data_and_options": {k: v for k, v in options_summary.items()
                                    if k not in ("celeba64_rows",
                                                 "kernel_errs")},
               "data_parallel": dp_summary,
               "seconds": time.perf_counter() - t_start}
    log(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
