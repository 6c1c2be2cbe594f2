"""Experiment CLI: the hand-written 3×3 conv kernels (K5 in its two K
orders, and K4, the fused ``silu(x·a + b)`` → conv unit) against
``F.conv2d``. Counterpart of the reference's ``scripts/exp_conv_kernel.py``.

    python -m diffusion_model_universal_torch.scripts.exp_conv_kernel \
        --check [--device cuda|cpu]
    python -m diffusion_model_universal_torch.scripts.exp_conv_kernel \
        --bench [--shape H CIN COUT]

``--check`` holds the dispatchers (the kernels on the card) against the
``F.conv2d`` twins for both K orders and for the fused unit, at B=4,
16×16, 128→128 in bf16, to the reference check's bound: max |err| <
2e-2 · max |ref|. With ``--device cpu`` both sides are plain PyTorch, so
a CPU check exercises the wiring only.

``--bench`` times each kernel against ``F.conv2d`` on the card with CUDA
events at B=2048 and ``--shape`` (default 32×32, 128→128), bf16: ms per
conv, TFLOP/s and the share of the H100's 989 TFLOP/s bf16 dense peak;
and, when Cin == Cout, K4 against the unfused unit. It needs the card.

On the card it ends by printing each kernel's launches in the run. The
reference's ``--block_b`` chose the batch rows a TPU grid step holds in
VMEM; it has no meaning for these kernels and is not taken.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models.base import resolve_device
from ..ops._build import launch_counts
from ..ops.conv3x3 import (VARIANTS, conv3x3, conv3x3_conv2d, gn_silu_conv3x3,
                           gn_silu_conv3x3_conv2d)
from ..utils.timing import card_line, cuda_ms

CHECK_BATCH = 4
CHECK_SHAPE = (16, 128, 128)
BENCH_BATCH = 2048
BENCH_SHAPE = (32, 128, 128)
PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense (NVIDIA data sheet)
REL_TOL = 2e-2


def parity(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Print and check max |got − want| / max |want| < REL_TOL."""
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-6)
    print(f"{name}: max abs err {err:.3e}  (rel {rel:.3e})", flush=True)
    if not rel < REL_TOL:
        raise RuntimeError(f"parity failed ({name}): rel {rel:.3e}")
    return rel


def check_inputs(device: torch.device):
    """``--check``'s x [B,H,H,Cin], w [3,3,Cin,Cout] and the fused unit's
    a, b [B,Cin], bf16, made on the CPU from seed 0 and moved to
    ``device``."""
    h, cin, cout = CHECK_SHAPE
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    x = (torch.randn((CHECK_BATCH, h, h, cin), generator=gen) * 0.1).to(bf16)
    w = (torch.randn((3, 3, cin, cout), generator=gen) * 0.05).to(bf16)
    a = (torch.randn((CHECK_BATCH, cin), generator=gen) * 0.3 + 1.0).to(bf16)
    b = (torch.randn((CHECK_BATCH, cin), generator=gen) * 0.1).to(bf16)
    return tuple(t.to(device) for t in (x, w, a, b))


def check(device: torch.device) -> None:
    x, w, a, b = check_inputs(device)
    want = conv3x3_conv2d(x, w)
    for variant in VARIANTS:
        parity(variant, conv3x3(x, w, variant), want)
    parity("fused-gn-silu", gn_silu_conv3x3(x, a, b, w),
           gn_silu_conv3x3_conv2d(x, a, b, w))
    print("parity OK", flush=True)


def bench(device: torch.device, shape=BENCH_SHAPE) -> None:
    h, cin, cout = shape
    b = BENCH_BATCH
    gen = torch.Generator(device=device).manual_seed(0)
    x = (torch.randn((b, h, h, cin), generator=gen, device=device)
         * 0.01).bfloat16()
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=device)
         * (1.0 / (9 * cin)) ** 0.5).bfloat16()
    flops = 2.0 * b * h * h * 9 * cin * cout
    # About 0.25 s of work per timed run at 300 TFLOP/s.
    iters = min(max(int(0.25 * 300e12 / flops), 5), 200)
    print(f"card: {card_line()}", flush=True)
    print(f"shape (B={b}, {h}x{h}, {cin}->{cout}), bf16, {iters} calls per "
          f"timed run", flush=True)

    def timed(fn, name: str) -> float:
        ms = cuda_ms(fn, iters=iters, reps=3)
        tflops = flops / (ms * 1e-3) / 1e12
        print(f"{name:>12}: {ms:8.4f} ms/conv   {tflops:6.1f} TFLOP/s   "
              f"eff {tflops * 1e12 / PEAK_BF16_FLOPS:.3f}", flush=True)
        return ms

    base = timed(lambda: conv3x3_conv2d(x, w), "F.conv2d")
    for variant in VARIANTS:
        ms = timed(lambda: conv3x3(x, w, variant), variant)
        print(f"  {variant}/F.conv2d time = {ms / base:.3f}", flush=True)
    if cin != cout:
        return
    print("fused unit: silu(x*a+b) -> conv", flush=True)
    av = (torch.randn((b, cin), generator=gen, device=device) * 0.05
          + 1.0).bfloat16()
    bv = (torch.randn((b, cin), generator=gen, device=device)
          * 0.05).bfloat16()
    base = timed(lambda: gn_silu_conv3x3_conv2d(x, av, bv, w), "conv2d-unit")
    ms = timed(lambda: gn_silu_conv3x3(x, av, bv, w), "fused")
    print(f"  fused/conv2d-unit time = {ms / base:.3f}", flush=True)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Hand-written 3x3 conv kernels (K5 tap9/k3, K4 fused "
                    "GN-apply+SiLU->conv) against F.conv2d. The reference's "
                    "--block_b (a TPU VMEM tiling knob) has no meaning on "
                    "Hopper and is not taken.")
    p.add_argument("--check", action="store_true",
                   help="hold the kernels against F.conv2d at B=4")
    p.add_argument("--bench", action="store_true",
                   help="time them against F.conv2d at B=2048 (card only)")
    p.add_argument("--shape", type=int, nargs=3, default=list(BENCH_SHAPE),
                   metavar=("H", "CIN", "COUT"),
                   help="--bench's conv shape (default %(default)s)")
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
        bench(device, tuple(args.shape))
    if device.type == "cuda":
        print(f"Kernel launches: {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
