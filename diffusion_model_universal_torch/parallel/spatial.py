"""Spatial parallelism: each image's rows split over the S ranks of a
spatial group (the reference's "spatial" mesh axis,
``parallel/mesh.py``, which shards activation height, and the halo
exchanges XLA inserts for the UNet's ``_shard_activation`` annotations
in ``models/unet.py``; the reference has no module of its own for them).

A :class:`RowGroup` is this rank's group of S ranks: rank s of the group
holds rows [s·H/S, (s+1)·H/S) of an activation of H rows. Its
collectives are what the split layers need:

* :meth:`RowGroup.halo`: k rows from the neighbours above and below,
  zero rows at the image's top and bottom;
* :meth:`RowGroup.gather`: the group's whole activation;
* :meth:`RowGroup.slice`: this rank's rows of a whole activation;
* :meth:`RowGroup.sum_`: partial statistics summed over the group.

Each exchange is one all-reduce of a zero-filled buffer with one slot a
rank (x + 0 is x, so the sum moves rows bit for bit): gloo runs only
broadcast and all-reduce on CUDA tensors, and the same code then runs
on NCCL.

:func:`split` marks the layers' inputs as row blocks of a group while a
split stage runs (:func:`active` reads it); outside it every layer runs
whole. Activations are NCHW (rows on dim 2).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

#: The reference shards height only from this many rows up ("at 4²/2²/1²
#: feature maps a spatial shard is all halo and no work").
MIN_ROWS = 8
#: What still refuses spatial parallelism: its backward.
NEXT_SLICE = ("the backward half of spatial parallelism (split GroupNorm "
              "gradients summed over the group, halo gradients, weight "
              "gradients summed over S) is the next slice of the port")

_ACTIVE: Optional["RowGroup"] = None


class RowGroup:
    """Rank ``index`` of a spatial group of ``size`` ranks, whose
    collectives run on ``group`` (None: the default group)."""

    def __init__(self, index: int, size: int, group=None):
        self.index = index
        self.size = size
        self.group = group

    def rows(self, total: int):
        """This rank's [lo, hi) of ``total`` rows."""
        h = total // self.size
        return self.index * h, (self.index + 1) * h

    def _exchange(self, part: torch.Tensor) -> torch.Tensor:
        """[S, *part.shape]: every rank's ``part`` in its slot."""
        buf = part.new_zeros((self.size, *part.shape))
        buf[self.index] = part
        dist.all_reduce(buf, group=self.group)
        return buf

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole NCHW activation of which ``x`` is this rank's rows."""
        buf = self._exchange(x)                       # [S, B, C, h, W]
        s, b, c, h, w = buf.shape
        return buf.permute(1, 2, 0, 3, 4).reshape(b, c, s * h, w).contiguous(
            memory_format=torch.channels_last)

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole NCHW activation ``x``."""
        lo, hi = self.rows(x.shape[2])
        return x[:, :, lo:hi].contiguous(memory_format=torch.channels_last)

    def halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's rows of an NCHW activation with ``k`` rows of each
        neighbour above and below them: zero rows at the image's top and
        bottom."""
        h = x.shape[2]
        if h < k:
            raise ValueError(f"a halo of {k} rows needs at least {k} rows a "
                             f"rank, got {h}")
        buf = self._exchange(torch.stack([x[:, :, :k], x[:, :, h - k:]]))
        zero = x.new_zeros(x[:, :, :k].shape)
        above = buf[self.index - 1, 1] if self.index > 0 else zero
        below = buf[self.index + 1, 0] if self.index < self.size - 1 \
            else zero
        return torch.cat([above, x, below], dim=2).contiguous(
            memory_format=torch.channels_last)


def make_row_groups(spatial_parallel: int, rank: int, world: int
                    ) -> RowGroup:
    """This rank's :class:`RowGroup` in the reference mesh's order (rank =
    d·S + s: groups of S consecutive ranks). Every rank makes every group,
    in the same order, as ``new_group`` requires."""
    if spatial_parallel < 1 or world % spatial_parallel:
        raise ValueError(f"distributed.spatial_parallel {spatial_parallel} "
                         f"needs a multiple of it in ranks, got {world}")
    groups = [dist.new_group(ranks=list(range(first,
                                              first + spatial_parallel)))
              for first in range(0, world, spatial_parallel)]
    d, s = divmod(rank, spatial_parallel)
    return RowGroup(s, spatial_parallel, groups[d])


def check_heights(image_size: int, spatial_parallel: int) -> None:
    """Refuse a UNet of ``image_size`` whose sharded heights (every stage
    of at least ``MIN_ROWS`` rows, halving five times) ``spatial_parallel``
    does not divide, naming the height."""
    h = image_size
    for _ in range(6):
        if h >= MIN_ROWS and h % spatial_parallel:
            raise ValueError(
                f"distributed.spatial_parallel {spatial_parallel} does not "
                f"divide the sharded height {h} of a {image_size}² UNet")
        h //= 2


@contextlib.contextmanager
def split(group: Optional[RowGroup]):
    """Run the layers inside on row blocks of ``group`` (None: whole)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, group
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[RowGroup]:
    """The group whose row blocks the layers now take, or None."""
    return _ACTIVE


def refuse_grad(*tensors) -> None:
    """Raise where a split layer would record a graph: the split forward
    has no backward yet."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"gradients through a row-split layer: "
                                  f"{NEXT_SLICE}")
