"""Timing on the card: CUDA-event times of a callable, and the card's name
and power limit to print beside them."""

from __future__ import annotations

import statistics
import subprocess
import time


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


def card_line() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    gives them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()
