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
* :meth:`RowGroup.gather_output`: the same, for the network's output;
* :meth:`RowGroup.slice`: this rank's rows of a whole activation;
* :meth:`RowGroup.sum_`: partial statistics summed over the group.

Each exchange is one all-reduce of a zero-filled buffer with one slot a
rank (x + 0 is x, so the sum moves rows bit for bit): gloo runs only
broadcast and all-reduce on CUDA tensors, and the same code then runs
on NCCL.

Training: each rank's graph computes its own output rows' share of the
loss, so the gradients of the weights (and of every activation held
whole on each rank) are partial, and the trainer sums them over the
group. The exchanges are differentiable to that rule: ``halo``'s
gradient sends the halo rows' gradients back to the neighbour that owns
them (one exchange), ``slice``'s fills the other ranks' rows with zeros,
and ``gather``'s sums the whole activation's partial gradient over the
group and keeps this rank's rows. The network's output is gathered by
``gather_output``, whose gradient keeps this rank's rows without a sum:
every rank takes the same loss of the same whole output, so the gradient
reaching it is already whole (summing it would count it S times).
Every rank runs the same graph, so the backward issues the same
collectives in the same order on every rank.

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
#: What spatial parallelism still refuses: its layout with model
#: parallelism.
NEXT_SLICE = ("spatial parallelism together with model parallelism (row-split "
              "activations on ranks that hold shards of the parameters) is "
              "the next slice of the port")

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
        """The whole NCHW activation of which ``x`` is this rank's rows;
        its gradient is summed over the group and cut to this rank's
        rows."""
        return _Gather.apply(x, self, True)

    def gather_output(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` for the network's output, whose gradient every
        rank computes whole: cut to this rank's rows, not summed."""
        return _Gather.apply(x, self, False)

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole NCHW activation ``x``; its
        gradient is zero on the other ranks' rows."""
        return _Slice.apply(x, self)

    def halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's rows of an NCHW activation with ``k`` rows of each
        neighbour above and below them: zero rows at the image's top and
        bottom. Its gradient sends the halo rows' gradients back to their
        owners (:meth:`halo_grad`)."""
        if x.shape[2] < k:
            raise ValueError(f"a halo of {k} rows needs at least {k} rows a "
                             f"rank, got {x.shape[2]}")
        return _Halo.apply(x, self, k)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        buf = self._exchange(x)                       # [S, B, C, h, W]
        s, b, c, h, w = buf.shape
        return buf.permute(1, 2, 0, 3, 4).reshape(b, c, s * h, w).contiguous(
            memory_format=torch.channels_last)

    def _slice(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.rows(x.shape[2])
        return x[:, :, lo:hi].contiguous(memory_format=torch.channels_last)

    def _halo(self, x: torch.Tensor, k: int) -> torch.Tensor:
        h = x.shape[2]
        buf = self._exchange(torch.stack([x[:, :, :k], x[:, :, h - k:]]))
        zero = x.new_zeros(x[:, :, :k].shape)
        above = buf[self.index - 1, 1] if self.index > 0 else zero
        below = buf[self.index + 1, 0] if self.index < self.size - 1 \
            else zero
        return torch.cat([above, x, below], dim=2).contiguous(
            memory_format=torch.channels_last)

    def halo_grad(self, g: torch.Tensor, k: int) -> torch.Tensor:
        """The transpose of :meth:`halo`: from the gradient of this rank's
        rows with their halos, [B, C, h + 2k, W], the gradient of its h
        rows: their own, plus the gradients the neighbours computed for
        them as halo rows (one exchange). The image's zero rows take
        none."""
        h = g.shape[2] - 2 * k
        buf = self._exchange(torch.stack([g[:, :, :k], g[:, :, h + k:]]))
        dx = g[:, :, k:h + k].clone(memory_format=torch.channels_last)
        if self.index > 0:
            dx[:, :, :k] += buf[self.index - 1, 1]
        if self.index < self.size - 1:
            dx[:, :, h - k:] += buf[self.index + 1, 0]
        return dx


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, k):
        ctx.group, ctx.k = group, k
        return group._halo(x, k)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.halo_grad(g, ctx.k), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.group, ctx.summed = group, summed
        return group._gather(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.group.sum_(g.clone(memory_format=torch.contiguous_format))
        return ctx.group._slice(g), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[2]
        return group._slice(x)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.group.rows(ctx.rows)
        b, c, _, w = g.shape
        whole = g.new_zeros((b, c, ctx.rows, w)).contiguous(
            memory_format=torch.channels_last)
        whole[:, :, lo:hi] = g
        return whole, None


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

