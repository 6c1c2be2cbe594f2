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
    2048, G=16, B=1, Cout 2 and 6; bf16 on the cluster + tensor-core
    route, bf16 shapes it does not take on the CUDA-core kernel, f32 on
    that kernel; every template instance of both kernels), checking each
    call's route; and K7 (in-conv; bf16 on the
    tensor cores, f32 on the CUDA cores) at 32², C=128, each against its
    plain version; checks refusals and ``Conv3x3Function``'s gradients;
    runs both CLIs' ``--check`` and ``--bench`` as subprocesses, each of
    which must launch every kernel it covers; and times the four kernels
    at their bench shapes beside their plain versions, ``F.conv2d`` and
    their bounds, K5 and K4 in turns with their earlier WMMA kernel, K6 in
    turns with its CUDA-core kernel (also at 64²·128→3, B=256, and
    28²·64→1, B=2048).

The last three lines of standard output are the ``kernels`` JSON line
(all seven kernels),
the card's name and power limit from ``nvidia-smi``, and the result
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before the result line. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import copy
import io
import json
import math
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


def profile_run(run_step, steps: int, what: str):
    """Device busy share, kernel launches, our kernels' device ms and the
    top kernels per call of ``run_step`` over ``steps`` calls
    (torch.profiler, after 3 warm-up calls); 'not measured' when it
    records no device time. Only device-side events (the kernels and
    copies themselves) are summed: a CPU op's entry repeats the device
    time of the kernels it launched. The top CPU ops by the device time
    they launched, and the count of a few host ops, are listed apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
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


def run_cli(module: str, args, what: str, timeout: int = 900) -> str:
    """Run one of the port's CLIs as a subprocess; fails on a non-zero
    exit. Returns its standard output."""
    cmd = [sys.executable, "-m", f"diffusion_model_universal_torch.scripts."
           f"{module}", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=timeout)
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
]
#: K6's timed shapes (B, H, C, Cout), bf16, G=32: the sm90 route and the
#: CUDA-core kernel in turns.
K6_TIMES = [(EXP_BATCH, 32, 128, 3), (256, 64, 128, 3),
            (EXP_BATCH, 28, 64, 1)]


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
    launched the kernel of ``route`` once and no other (``force`` asks the
    wrapper for a route), and logs the sm90 route's launch plan once per
    shape. Returns max abs error."""
    import torch
    from diffusion_model_universal_torch.ops import boundary_conv as bc
    dname = str(x.dtype).removeprefix("torch.")
    if route == "sm90":
        plan = bc.out_head_launch_plan(*x.shape, groups, w.shape[-1])
        if (x.shape, plan) not in LOGGED_PLANS:
            LOGGED_PLANS.add((x.shape, plan))
            log(f"  K6 {dname} {what} plan: {plan.describe()}")
    before = k6_route_launches()
    got = bc.out_head_cuda(x, scale, bias, w, groups, route=force)
    want = bc.out_head_plain(x, scale, bias, w, groups)
    torch.cuda.synchronize()
    after = k6_route_launches()
    check(all(after[r] - before[r] == (r == route) for r in after),
          f"K6 {what}: launches by route moved {before} -> {after}, "
          f"expected one {route} launch")
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
            ("Cout=8 out head (K6)", lambda: bc.out_head_cuda(
                xh, s, s, torch.zeros((3, 3, 64, 8), **z))),
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

    symbols = {"gn": "dmu_group_norm_silu_fwd",
               "gn_bwd": "dmu_group_norm_silu_bwd", "mha": "dmu_mha_fwd"}

    def by_path(kind):
        return {"serve": launches.get(kind),
                "train_cli": cli["launches"][symbols[kind]],
                "train_steps_in_process": train_time["launches"][kind]}

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
                     train={**totals(k1_train), "work": train_work,
                            "max_abs_err": max(train_errs["gn"].values()),
                            "shapes": k1_train}),
        kernel_entry("group_norm_silu_bwd",
                     "diffusion_model_universal_torch/csrc/group_norm.cu",
                     GN_BWD_REPLACES, k2_rows,
                     cli["launches"][symbols["gn_bwd"]], bwd_errs,
                     train_work, launches_per_train_step=per_step["gn_bwd"],
                     launches_by_path=by_path("gn_bwd"),
                     tol_reductions="dγ, dβ, dtb: red_tol(n) = 1e-4·max(1, "
                                    "sqrt(n/1024)) abs + 1e-4 rel"),
        kernel_entry("mha_fwd",
                     "diffusion_model_universal_torch/csrc/attention.cu",
                     MHA_REPLACES, mha_rows, cli["launches"][symbols["mha"]],
                     {**errs["mha"], **train_errs["mha"]}, serve_work,
                     launches_per_forward=per_forward["mha"],
                     launches_per_train_step=per_step["mha"],
                     launches_by_path=by_path("mha"),
                     train={**totals(k3_train), "work": train_work,
                            "max_abs_err": max(train_errs["mha"].values()),
                            "shapes": k3_train}),
        *exp_entries,
    ]
    summary = {"requests": requests, "unet_max_abs_err": unet_err,
               "unet128": unet128,
               "profile": profile, "dispatch": dispatch,
               "train_step_check": step_check,
               "train_cli": cli, "train_time": train_time,
               "train_profile": train_profile,
               "experiment_kernels": exp_summary,
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
