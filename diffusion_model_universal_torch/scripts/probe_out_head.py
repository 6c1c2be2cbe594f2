"""Probe of K6's sm90 route on the card: where a call's time goes.

    python -m diffusion_model_universal_torch.scripts.probe_out_head

Builds ``csrc/out_head_sm90.cu`` twice beside the port's own build, each
time with a macro the port's build never defines:

* ``DMU_OUT_HEAD_PROBE``: thread 0 of each block adds the clock64 cycles
  of each phase of its samples (copy wait, statistics, cluster barrier,
  cluster sums, 3×3 sum, affine, product, then the block barrier with the
  next copy's issue and the halo stores) into a buffer. Its output must
  equal the port's kernel's bit for bit. Printed as the mean over the
  blocks and as shares of their sum.
* ``DMU_OUT_HEAD_NO_TANH``: SiLU without its ``tanh.approx`` (its results
  are wrong), timed in turns with the port's kernel: the difference is
  what the special-function unit costs a call.

At K6's timed shapes of ``chip_smoke.py`` (bf16, G=32). Prints the card's
name and power limit, a line per shape and one JSON object last. Needs
the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import boundary_conv as bc
from ..utils.timing import card_line, cuda_ms

#: (B, H, C, Cout): chip_smoke.py's K6_TIMES.
SHAPES = [(2048, 32, 128, 3), (256, 64, 128, 3), (2048, 28, 64, 1)]
GROUPS = 32
PHASES = ("copy wait", "statistics", "cluster barrier", "cluster sums",
          "3x3 sum", "affine", "product", "barrier, copy issue, halo")
VARIANTS = {"phases": "-DDMU_OUT_HEAD_PROBE",
            "no_tanh": "-DDMU_OUT_HEAD_NO_TANH"}
HBM_BYTES_PER_MS = 3.35e9


def build_variants() -> dict:
    """The probe builds of ``csrc/out_head_sm90.cu``, one ``nvcc`` each,
    started together; a library is named after the source and flags and
    reused while they are unchanged."""
    src = _build.CSRC / "out_head_sm90.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, flag in VARIANTS.items():
        flags = [*_build.NVCC_FLAGS, flag]
        digest = hashlib.sha1(src.read_bytes() +
                              " ".join(flags).encode()).hexdigest()[:12]
        target = _build.BUILD_DIR / f"out_head_sm90-{name}-{digest}.so"
        proc = None
        if not target.exists():
            proc = subprocess.Popen([nvcc, *flags, "-o", str(target),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        procs[name] = (target, proc)
    libs = {}
    for name, (target, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                target.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for the {name} probe:\n"
                                   f"{log}")
        lib = ctypes.CDLL(str(target))
        lib.dmu_out_head_sm90.argtypes = bc._SM90_ARGS
        lib.dmu_out_head_sm90.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, x, scale, bias, wt, out, plan) -> None:
    b, h, wd, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dmu_out_head_sm90(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), wt.data_ptr(),
        out.data_ptr(), b, h, wd, c, GROUPS, out.shape[-1], 1e-5,
        *plan.launch_args(), stream)
    if err:
        raise RuntimeError(f"the probe's dmu_out_head_sm90 failed: CUDA "
                           f"error {err}")


def probe_shape(libs, batch, h, c, cout, gen) -> dict:
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (randn(batch, h, h, c) * 0.5 + 0.3).bfloat16()
    scale = randn(c) * 0.2 + 1.0
    bias = randn(c) * 0.1
    w = (randn(3, 3, c, cout) * (1.0 / (9 * c)) ** 0.5).bfloat16()
    plan = bc.out_head_launch_plan(batch, h, h, c, GROUPS, cout)
    wt = bc.pack_out_head_weight(w)
    out = x.new_empty((batch, h, h, cout))
    cycles = torch.zeros((batch * plan.cluster, len(PHASES)),
                         dtype=torch.int64, device="cuda")
    libs["phases"].dmu_out_head_probe_buffer.argtypes = [ctypes.c_void_p]
    err = libs["phases"].dmu_out_head_probe_buffer(cycles.data_ptr())
    if err:
        raise RuntimeError(f"dmu_out_head_probe_buffer failed: {err}")
    want = bc.out_head_cuda(x, scale, bias, w, GROUPS)
    launch(libs["phases"], x, scale, bias, wt, out, plan)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise RuntimeError("the phase probe's output differs from the "
                           "port's kernel")
    cycles.zero_()
    launch(libs["phases"], x, scale, bias, wt, out, plan)
    torch.cuda.synchronize()
    used = cycles[cycles.sum(1) > 0].double()
    mean = used.mean(0).tolist()
    total = sum(mean)

    runs = {"port": [], "no_tanh": [], "phases": []}
    calls = {
        "port": lambda: bc.out_head_cuda(x, scale, bias, w, GROUPS),
        "no_tanh": lambda: launch(libs["no_tanh"], x, scale, bias, wt, out,
                                  plan),
        "phases": lambda: launch(libs["phases"], x, scale, bias, wt, out,
                                 plan),
    }
    for turn in (list(calls), list(calls)[::-1]):
        for name in turn:
            runs[name].append(cuda_ms(calls[name], iters=20, reps=3))
    bound = (x.numel() * 2 + batch * h * h * cout * 2) / HBM_BYTES_PER_MS
    return {
        "shape": f"B{batch} {h}² {c}→{cout} G{GROUPS}",
        "plan": plan.describe(),
        "blocks": int(used.shape[0]),
        "cycles": dict(zip(PHASES, mean)),
        "shares": {p: v / total for p, v in zip(PHASES, mean)},
        "ms": {k: sum(v) / len(v) for k, v in runs.items()},
        "runs_ms": runs,
        "bound_ms": bound,
    }


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("probe_out_head needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card: {card_line()}", flush=True)
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for batch, h, c, cout in SHAPES:
        row = probe_shape(libs, batch, h, c, cout, gen)
        ms = row["ms"]
        print(f"{row['shape']}: {row['plan']}; port {ms['port']:.4f} ms, "
              f"no tanh {ms['no_tanh']:.4f}, with clocks "
              f"{ms['phases']:.4f}, bound {row['bound_ms']:.4f}", flush=True)
        print("  cycles a block: " + ", ".join(
            f"{p} {v / 1e3:.1f}k ({row['shares'][p]:.0%})"
            for p, v in row["cycles"].items()), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"card": card_line(), "shapes": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
