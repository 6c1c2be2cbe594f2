"""Device-memory preflight for the samplers (the port of the reference's
``utils/memory.py``).

A sampling request draws its whole batch at once. The reference found
that a large enough batch crashed its device instead of raising, so its
``generate`` estimates the sampler's device residency, splits the batch
into equal chunks that fit a budget, and refuses with a clear message
when even one sample cannot fit. The port keeps the same estimate and
plan, so one request is split the same way by either package; only the
budget comes from ``torch.cuda.mem_get_info`` here.

The estimate is the reference's, kept as it is: a calibrated multiple of
the full-resolution feature map (:func:`estimate_sampler_bytes`), plus
four f32 image-shaped tensors and the parameters. The port's eager
sampler frees each UNet call's activations as it goes, so on the card
the estimate is conservative; it is not re-calibrated here.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

# Peak live activations of one UNet forward as a multiple of the
# full-resolution base-width feature map (B·S²·C·dtype): the reference's
# calibration.
_ACT_MULTIPLE = 8.0

# Share of the card's memory the sampler may plan to use; the rest covers
# the allocator's caching and fragmentation and the estimate's error.
_BUDGET_FRACTION = 0.5


class SamplerMemoryError(RuntimeError):
    """A sampler request cannot fit device memory at any chunk size."""


def device_memory_budget(device=None) -> Optional[int]:
    """Usable bytes for a sampler on ``device``, or None for no limit.

    ``DMU_SAMPLER_HBM_BYTES`` (bytes of device memory) overrides what the
    card reports, on any device; that is also how tests pin the planner.
    Otherwise a CUDA device gives ``_BUDGET_FRACTION`` of its total memory
    (``torch.cuda.mem_get_info``), and the CPU has no budget: host memory
    is not what this guards, as in the reference.
    """
    env = os.environ.get("DMU_SAMPLER_HBM_BYTES")
    if env:
        return int(float(env) * _BUDGET_FRACTION)
    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return None
    _, total = torch.cuda.mem_get_info(device)
    return int(total * _BUDGET_FRACTION)


def estimate_sampler_bytes(batch: int, image_size: int, model_channels: int,
                           in_channels: int = 3, dtype_bytes: int = 2,
                           params_bytes: int = 0) -> int:
    """Estimated device residency of a sampler at ``batch``: activations
    ``batch · S² · C · dtype_bytes · 8``, four f32 image-shaped tensors
    (x, ε̂, the posterior mean, the noise), and the parameters once. The
    number of steps does not enter."""
    act = batch * image_size * image_size * model_channels * dtype_bytes
    act = int(act * _ACT_MULTIPLE)
    carry = batch * image_size * image_size * in_channels * 4 * 4
    return params_bytes + act + carry


def plan_sampler_chunks(num_samples: int, image_size: int,
                        model_channels: int, in_channels: int = 3,
                        dtype_bytes: int = 2, params_bytes: int = 0,
                        budget_bytes: Optional[int] = None,
                        ) -> Tuple[int, int]:
    """Split ``num_samples`` into equal chunks that fit the budget of one
    card.

    Returns ``(chunk_size, n_chunks)`` with ``chunk_size · n_chunks ≥
    num_samples`` (the last chunk holds the rest). With no budget the plan
    is one chunk. Raises :class:`SamplerMemoryError` when even one sample
    exceeds the budget. The reference's arithmetic on one device.
    """
    if budget_bytes is None or num_samples <= 0:
        return num_samples, 1

    def fits(b: int) -> bool:
        return estimate_sampler_bytes(
            b, image_size, model_channels, in_channels, dtype_bytes,
            params_bytes) <= budget_bytes

    if fits(num_samples):
        return num_samples, 1
    if not fits(1):
        need = estimate_sampler_bytes(1, image_size, model_channels,
                                      in_channels, dtype_bytes, params_bytes)
        raise SamplerMemoryError(
            f"sampler batch of even 1 sample/device needs ~{need / 1e9:.2f} "
            f"GB of the ~{budget_bytes / 1e9:.2f} GB device budget "
            f"(image_size={image_size}, model_channels={model_channels}); "
            f"reduce image_size/model_channels or raise "
            f"DMU_SAMPLER_HBM_BYTES if the device is larger than detected")
    n_chunks = 2
    while True:
        chunk = -(-num_samples // n_chunks)
        if fits(chunk):
            return chunk, -(-num_samples // chunk)
        n_chunks += 1
