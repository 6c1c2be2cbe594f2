"""Profiling helpers (counterpart of the reference's
``utils/profiling.py``): a ``torch.profiler`` trace of a block, the
card's memory statistics, and a step timer."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

from ..models.base import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True,
          device=None) -> Iterator[None]:
    """Trace the enclosed block with ``torch.profiler`` (host ops, and the
    card's kernels and copies on ``cuda``, the default) into ``log_dir``
    as a Chrome trace (``*.pt.trace.json``) that TensorBoard's profiler
    plugin also reads."""
    if not enabled:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes allocated now and at peak on a card (``cuda`` by default),
    and its total memory."""
    dev = resolve_device(device)
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev)
                           .total_memory),
    }


class StepTimer:
    """Rolling-average step timer that skips the first ``skip_first``
    steps (the build and warm-up). Stop it after a synchronize: CUDA
    work is asynchronous."""

    def __init__(self, skip_first: int = 2, window: int = 50):
        self.skip_first = skip_first
        self.window = window
        self.times: list = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[float]:
        if self._t0 is None:
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._count += 1
        if self._count > self.skip_first:
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def throughput(self, batch_size: int) -> float:
        return batch_size / self.mean if self.mean else 0.0
