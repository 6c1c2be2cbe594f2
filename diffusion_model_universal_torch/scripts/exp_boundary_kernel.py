"""Experiment CLI: the hand-written boundary-conv kernels against their
unfused PyTorch units. Counterpart of the reference's
``scripts/exp_boundary_kernel.py``.

    python -m diffusion_model_universal_torch.scripts.exp_boundary_kernel \
        --check [--device cuda|cpu]
    EXP_BATCH=2048 python -m \
        diffusion_model_universal_torch.scripts.exp_boundary_kernel --bench

Units:
  1. out-head: GroupNorm(32) + SiLU → 3×3 conv C→3, kernel K6 (on the
     route ``ops/boundary_conv.py::out_head_route`` picks: ``--check``'s
     f32 on the CUDA-core kernel, ``--bench``'s bf16 on the sm90 route)
     against ``group_norm_silu_plain`` then ``F.conv2d``;
  2. in-conv: 3×3 conv 3→C, kernel K7 against ``F.conv2d``.

``--check`` holds the dispatchers (the kernels on the card) against the
unfused units in f32 at B=4, 16×16, C=128, to max |err| < 2e-2 · max
|ref|. With ``--device cpu`` both sides are plain PyTorch, so a CPU check
exercises the wiring only.
``--bench`` times both units on the card with CUDA events in bf16 at
B=``EXP_BATCH`` (default 2048), 32×32, C=128. On the card the run ends by
printing each kernel's launches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..models.base import resolve_device
from ..ops._build import launch_counts
from ..ops.boundary_conv import in_conv, out_head, out_head_conv2d
from ..ops.conv3x3 import conv3x3_conv2d
from ..utils.timing import card_line, cuda_ms
from .exp_conv_kernel import parity

CHECK_BATCH = 4
CHECK_SHAPE = (16, 128)
BENCH_SHAPE = (32, 128)


def inputs(device, dtype, b: int, h: int, c: int):
    """x [B,H,H,C], w [3,3,C,3], scale, bias [C] (f32), x3 [B,H,H,3] and
    w3 [3,3,3,C], made on ``device`` from seed 0."""
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = (randn(b, h, h, c) * 0.5).to(dtype)
    w = (randn(3, 3, c, 3) * 0.05).to(dtype)
    scale = randn(c) * 0.2 + 1.0
    bias = randn(c) * 0.1
    x3 = (randn(b, h, h, 3) * 0.5).to(dtype)
    w3 = (randn(3, 3, 3, c) * 0.1).to(dtype)
    return x, w, scale, bias, x3, w3


def check_inputs(device: torch.device):
    """``--check``'s inputs, f32, as :func:`inputs` makes them."""
    return inputs(device, torch.float32, CHECK_BATCH, *CHECK_SHAPE)


def check(device: torch.device) -> None:
    x, w, scale, bias, x3, w3 = check_inputs(device)
    parity("out-head", out_head(x, scale, bias, w),
           out_head_conv2d(x, scale, bias, w))
    parity("in-conv", in_conv(x3, w3), conv3x3_conv2d(x3, w3))
    print("parity OK", flush=True)


def bench(device: torch.device, batch: int) -> None:
    h, c = BENCH_SHAPE
    x, w, scale, bias, x3, w3 = inputs(device, torch.bfloat16, batch, h, c)
    print(f"card: {card_line()}", flush=True)

    def timed(fn, name: str) -> float:
        ms = cuda_ms(fn, iters=20, reps=3)
        print(f"  {name:<14}: {ms:8.4f} ms", flush=True)
        return ms

    print(f"== out-head unit: GN(32)+SiLU -> conv {c}->3  (B={batch}, "
          f"{h}x{h}, bf16) ==", flush=True)
    base = timed(lambda: out_head_conv2d(x, scale, bias, w), "unfused unit")
    ms = timed(lambda: out_head(x, scale, bias, w), "K6 out_head")
    print(f"  K6/unfused time = {ms / base:.3f}", flush=True)
    print(f"== in-conv unit: conv 3->{c}  (B={batch}, {h}x{h}, bf16) ==",
          flush=True)
    base = timed(lambda: conv3x3_conv2d(x3, w3), "F.conv2d")
    ms = timed(lambda: in_conv(x3, w3), "K7 in_conv")
    print(f"  K7/F.conv2d time = {ms / base:.3f}", flush=True)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Hand-written boundary-conv kernels (K6 out-head, K7 "
                    "in-conv) against their unfused PyTorch units.")
    p.add_argument("--check", action="store_true",
                   help="hold the kernels against the units in f32 at B=4")
    p.add_argument("--bench", action="store_true",
                   help="time them in bf16 at B=$EXP_BATCH (card only)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (--check only)")
    return p


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.bench and device.type != "cuda":
        parser.error("--bench times the card: it needs --device cuda")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.check:
        check(device)
    if args.bench:
        bench(device, int(os.environ.get("EXP_BATCH", 2048)))
    if device.type == "cuda":
        print(f"Kernel launches: {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
