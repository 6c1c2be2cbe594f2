#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of
``diffusion_model_universal_tpu/configs/ddpm_config.yaml`` (C=128, 32²,
T=1000, 4 heads, serve batch 16) with random weights made from a seed:

1. builds the hand-written CUDA kernels from ``csrc/`` (one ``nvcc`` per
   source, all started together) and prints the build seconds;
2. records every GroupNorm and attention call shape of one full-width
   forward, and holds each kernel against its plain PyTorch version at
   each of those shapes, in bf16 and f32;
3. holds one f32 UNet forward (B=2) and a 3-step sampler run on the card
   against the same module on the CPU, where the plain versions run;
4. serves three ``POST /generate`` requests and one ``GET /healthz``
   through the port's HTTP server (bf16, 1000 ancestral steps each),
   checks the outputs, and checks that each request advanced the kernels'
   launch counters by exactly T × launches per forward;
5. times each kernel at its main-path shapes beside its plain version,
   one PyTorch library call computing the same function, and its bound;
   and traces a few sampler steps with ``torch.profiler``.

The last three lines of standard output are the ``kernels`` JSON line,
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

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "diffusion_model_universal_tpu" / "configs" / "ddpm_config.yaml"
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
MHA_REPLACES = "diffusion_model_universal_tpu/ops/attention.py:38"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def hold(name: str, got, want, tol: float) -> float:
    """Check |got − want| ≤ tol + tol·|want| elementwise (in f32) and that
    got is finite; returns max |got − want|."""
    d = (got.float() - want.float()).abs()
    err = float(d.max())
    ok = bool((d <= tol + tol * want.float().abs()).all()) and bool(
        got.float().isfinite().all())
    log(f"  {name}: max_abs_err={err:.3e} (tol {tol:g} abs + {tol:g} rel) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} disagrees with its plain version")
    return err


# -- timing ---------------------------------------------------------------

def cuda_ms(fn, iters: int = 40, reps: int = 5) -> float:
    """Median device ms per call of ``fn`` over ``reps`` runs of ``iters``
    back-to-back calls. Each run starts behind a spin kernel long enough
    for the host to enqueue all ``iters`` calls, so the events time the
    card's work and not the host's launch rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    spin_cycles = int(min(2.0 * host_s, 0.5) * 2.0e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases ---------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


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


def hold_kernels(gn_calls, mha_calls):
    """Each kernel against its plain version at ``gn_calls``/``mha_calls``
    shapes in bf16 and f32; returns the max abs errors by (shape, dtype)."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    errs = {"gn": {}, "mha": {}}
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        tol = TOL[dname]
        for key in sorted(gn_calls):
            x, scale, bias, tb = gn_inputs(key, dtype, gen)
            groups, silu = key[3], key[5]
            got = gn_ops.group_norm_silu_cuda(x, scale, bias, groups, tb,
                                              apply_silu=silu)
            want = gn_ops.group_norm_silu_plain(x, scale, bias, groups, tb,
                                                apply_silu=silu)
            torch.cuda.synchronize()
            errs["gn"][(key, dname)] = hold(
                f"K1 {dname} {gn_label(key)}", got, want, tol)
        for shape in sorted(mha_calls):
            q, k, v = mha_inputs(shape, dtype, gen)
            got = attn_ops.mha_cuda(q, k, v)
            want = attn_ops.mha_plain(q, k, v)
            torch.cuda.synchronize()
            errs["mha"][(shape, dname)] = hold(
                f"K3 {dname} {mha_label(shape)}", got, want, tol)
    return errs


def hold_edges():
    """Shapes off this config's path: the 64² config's (S=4096 GroupNorm;
    S=64 attention, past the default 48 KB of shared memory), K3's largest
    (S=64, D=128), and odd sizes; then inputs the wrappers must refuse."""
    import torch
    from diffusion_model_universal_torch.ops import attention as attn_ops
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    log("[hold] off-path shapes:")
    hold_kernels({(2, 4096, 128, 32, True, True): 1,
                  (3, 7, 24, 8, False, True): 1,
                  (1, 9, 48, 16, True, False): 1},
                 {(2, 4, 64, 64): 1, (2, 4, 64, 128): 1, (3, 1, 7, 32): 1})
    x = torch.zeros((2, 4, 4, 32), device=DEVICE)
    w = torch.ones(32, device=DEVICE)
    q = torch.zeros((1, 1, 128, 128), device=DEVICE)
    refusals = [
        ("float16 x", lambda: gn_ops.group_norm_silu_cuda(x.half(), w, w, 8)),
        ("non-contiguous x", lambda: gn_ops.group_norm_silu_cuda(
            x.transpose(1, 2), w, w, 8)),
        ("groups not dividing C", lambda: gn_ops.group_norm_silu_cuda(
            x, w, w, 5)),
        ("S=128 D=128 attention", lambda: attn_ops.mha_cuda(q, q, q)),
    ]
    for what, call in refusals:
        try:
            call()
        except ValueError:
            log(f"  refuses {what}: ok")
        else:
            raise SmokeFailure(f"a wrapper accepted {what}")


def gn_label(key) -> str:
    b, s, c, groups, has_tb, silu = key
    return (f"B{b} S{s} C{c} G{groups}{' +tb' if has_tb else ''}"
            f"{' +silu' if silu else ''}")


def mha_label(shape) -> str:
    b, n, s, d = shape
    return f"B{b} N{n} S{s} D{d}"


def hold_unet(model):
    """One f32 forward at B=2 and 3 sampler steps on the card, against
    the same module on the CPU (plain versions there)."""
    import torch
    cpu_model = copy.copy(model)
    cpu_model.net = copy.deepcopy(model.net).cpu()
    cpu_model.device = torch.device("cpu")
    cpu_model.schedule = type(model.schedule)(
        **{k: v.cpu() for k, v in vars(model.schedule).items()})
    gen = torch.Generator().manual_seed(SEED + 3)
    x = torch.randn(model.sample_shape(2), generator=gen)
    t = torch.tensor([0, 731])
    with torch.no_grad():
        want = cpu_model.apply(x, t)
        got = model.apply(x.to(DEVICE), t.to(DEVICE)).cpu()
    log(f"[unet] full-width f32 forward B=2, output |max| "
        f"{float(want.abs().max()):.3f}")
    errs = [hold("UNet forward, card vs CPU", got, want, UNET_TOL)]
    draws = [torch.randn(model.sample_shape(2), generator=gen)
             for _ in range(4)]
    it_c, it_g = iter(draws), iter([d.to(DEVICE) for d in draws])
    with torch.inference_mode():
        want = cpu_model._denoise_range(next(it_c), 3, 0,
                                        lambda: next(it_c))
        got = model._denoise_range(next(it_g), 3, 0,
                                   lambda: next(it_g)).cpu()
    errs.append(hold("3 sampler steps t=2..0, card vs CPU", got, want,
                     UNET_TOL))
    return max(errs)


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


def time_kernels(gn_calls, mha_calls, dtype_name="bfloat16"):
    """Per-shape kernel, plain, library and bound ms at the main path's
    serving dtype."""
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
    for shape in sorted(mha_calls):
        b, n, s, d = shape
        q, k, v = mha_inputs(shape, dtype, gen)
        ms = cuda_ms(lambda: attn_ops.mha_cuda(q, k, v))
        plain = cuda_ms(lambda: attn_ops.mha_plain(q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes = 4 * b * n * s * d * isz
        ops = b * n * (4 * s * s * d + 5 * s * s)
        bms, by = bound(nbytes, ops, dtype_name)
        mha_rows.append({"shape": mha_label(shape),
                         "per_forward": mha_calls[shape], "ms": ms,
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


def kernel_entry(name, source, replaces, rows, launches, per_forward, errs):
    """Sums over the main-path shapes, each weighted by its calls per
    forward: the numbers of one UNet forward's worth of this kernel."""
    tot = {k: sum(r[k] * r["per_forward"] for r in rows)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_bytes = sum(r["bound_ms"] * r["per_forward"] for r in rows
                  if r["bound_by"] == "bytes")
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "launches_per_forward": per_forward,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": max(v for (_, d), v in errs.items()
                               if d == "float32"),
        "max_abs_err_bf16": max(v for (_, d), v in errs.items()
                                if d == "bfloat16"),
        "tol": TOL,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if t_bytes * 2 >= tot["bound_ms"]
        else "operations",
        "library_ms": tot["library_ms"],
        "work": f"one UNet forward at B={SERVE_BATCH}, bf16: every "
                "main-path shape times its calls per forward",
        "shapes": rows,
    }


def profile_steps(model, steps: int = 5):
    """Device busy share and the kernels' share over a few sampler steps
    (torch.profiler); 'not measured' when it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step = model.posterior_step_fn()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    x = torch.randn(model.sample_shape(SERVE_BATCH), generator=gen,
                    device=DEVICE)
    t_b = torch.full((SERVE_BATCH,), 500, device=DEVICE, dtype=torch.long)
    with torch.inference_mode():
        for _ in range(3):
            step(x, t_b, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                x = step(x, t_b, torch.randn_like(x))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            dev[e.key] = (us / 1e3, e.count)
    if not dev:
        log("[profile] device time not measured (profiler saw no kernels)")
        return None
    busy = sum(v[0] for v in dev.values())
    kernels = sum(v[1] for v in dev.values())
    ours = {tag: sum(v[0] for k, v in dev.items() if tag in k)
            for tag in ("gn_fwd_kernel", "mha_fwd_kernel")}
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:6]
    summary = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
               "device_busy_ms_per_step": busy / steps,
               "device_busy_share": busy / wall_ms,
               "kernel_launches_per_step": kernels / steps,
               "gn_kernel_ms_per_step": ours["gn_fwd_kernel"] / steps,
               "mha_kernel_ms_per_step": ours["mha_fwd_kernel"] / steps}
    log(f"[profile] {json.dumps(summary)}")
    for k, (ms, cnt) in top:
        log(f"[profile]   {ms / steps:.3f} ms/step  x{cnt / steps:.0f}  "
            f"{k[:90]}")
    return summary


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
    smi = nvidia_smi_line()
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

    serve_model, requests, launches = serve(model, cfg, per_forward)
    del model
    gn_rows, mha_rows = time_kernels(gn_calls, mha_calls)
    profile = profile_steps(serve_model)

    entries = [
        kernel_entry("group_norm_silu_fwd",
                     "diffusion_model_universal_torch/csrc/group_norm.cu",
                     GN_REPLACES, gn_rows, launches["gn"],
                     per_forward["gn"], errs["gn"]),
        kernel_entry("mha_fwd",
                     "diffusion_model_universal_torch/csrc/attention.cu",
                     MHA_REPLACES, mha_rows, launches["mha"],
                     per_forward["mha"], errs["mha"]),
    ]
    log(f"[summary] {json.dumps({'requests': requests, 'unet_max_abs_err': unet_err, 'profile': profile, 'seconds': time.perf_counter() - t_start})}")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
