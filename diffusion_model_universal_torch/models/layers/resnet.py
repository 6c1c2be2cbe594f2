"""Residual / up / down blocks of the UNet (counterpart of the
reference's ``models/layers/resnet.py``).

Activations are NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view: the GroupNorm op
reads it without a copy. Submodules are named after the reference's flax
parameter tree (``norm1``, ``conv1``, ``time_proj``, ...), which keeps the
weight bridge in :mod:`..convert` mechanical.

Inside ``parallel.spatial.split(group)`` each layer takes this rank's
rows of images whose rows are split over ``group`` (forward only): a
3×3 conv reads one halo row of each neighbour (the height's padding is
the halo, only the width is padded in cuDNN), the 4×4 stride-2 down conv
one row each side, the 4×4 transposed up conv one row each side with its
output cropped to the rank's 2·h rows, the 1×1 shortcut none; GroupNorm
sums its partial statistics over the group (K1's split form); dropout
draws the whole activation's mask and keeps the rank's rows; a down conv
whose output would have fewer than ``MIN_ROWS`` rows gathers its input
and runs whole.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import group_norm as gn_ops
from ...parallel import spatial
from .attention import SelfAttentionBlock


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → a contiguous NHWC view (a copy only if ``x`` is not already
    in channels_last memory)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC → an NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


def conv_same(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A stride-1 SAME conv of an odd square kernel; on row blocks of a
    spatial group, with ``k // 2`` halo rows of each neighbour in place
    of the height's padding."""
    pad = weight.shape[-1] // 2
    group = spatial.active()
    if group is None or pad == 0:
        return F.conv2d(x, weight, bias, padding=pad)
    spatial.refuse_grad(x, weight)
    return F.conv2d(group.halo(x, pad), weight, bias, padding=(0, pad))


def dropout_rows(h: torch.Tensor, p: float, group) -> torch.Tensor:
    """Dropout of this rank's rows ``h`` of a split activation with the
    mask one process would draw for the whole one: the mask is drawn for
    a whole activation of ``h``'s dtype and memory layout from the default
    generator (every rank of the group draws alike) and cut to the rank's
    rows. On the CPU ``F.dropout`` multiplies by its scaled mask, and on
    CUDA its fused kernel scales in f32 and rounds once; both are kept."""
    b, c, rows, w = h.shape
    whole = torch.ones((b, c, rows * group.size, w), dtype=h.dtype,
                       device=h.device).contiguous(
                           memory_format=torch.channels_last)
    lo, hi = group.rows(whole.shape[2])
    mask = F.dropout(whole, p, training=True)[:, :, lo:hi]
    if h.device.type == "cpu":
        return h * mask
    return (h.float() * (mask != 0) * (1.0 / (1.0 - p))).to(h.dtype)


class GroupNormSiLU(nn.Module):
    """GroupNorm(+time bias)(+SiLU) with f32 γ (``weight``) and β (``bias``).

    ``skip``: normalize the virtual concatenation ``[x, skip]`` without
    materializing it and return the two normalized halves. Exact when no
    group straddles the boundary (the caller checks); the halves then use
    ``ch // gs`` groups each, where ``gs`` is the concat's group size.
    Parameters are declared at the concat width either way.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 apply_silu: bool = True):
        super().__init__()
        self.num_groups = gn_ops.resolve_num_groups(num_channels, num_groups)
        self.apply_silu = apply_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def _norm(self, x, weight, bias, groups, time_bias):
        group = spatial.active()
        if group is not None:
            spatial.refuse_grad(x, weight, bias, time_bias)
            return to_nchw(gn_ops.group_norm_silu_split(
                to_nhwc(x), weight, bias, groups, group,
                time_bias=time_bias, apply_silu=self.apply_silu))
        return to_nchw(gn_ops.group_norm_silu(
            to_nhwc(x), weight, bias, groups, time_bias=time_bias,
            apply_silu=self.apply_silu))

    def forward(self, x: torch.Tensor,
                time_bias: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None):
        if skip is None:
            return self._norm(x, self.weight, self.bias, self.num_groups,
                              time_bias)
        ch = x.shape[1]
        gs = self.weight.shape[0] // self.num_groups
        if ch % gs != 0:
            raise ValueError(f"a GroupNorm group of {gs} channels straddles "
                             f"the split at channel {ch}")
        tb_h = time_bias[:, :ch] if time_bias is not None else None
        tb_s = time_bias[:, ch:] if time_bias is not None else None
        yh = self._norm(x, self.weight[:ch], self.bias[:ch], ch // gs, tb_h)
        ys = self._norm(skip, self.weight[ch:], self.bias[ch:],
                        skip.shape[1] // gs, tb_s)
        return yh, ys


class SplitConv(nn.Module):
    """Stride-1 SAME conv over a virtual channel concatenation
    ``[x, skip]``: one kernel at the concat width, applied as
    ``conv(x, w[:, :ch]) + conv(skip, w[:, ch:])``. ``skip=None`` is the
    plain conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, bias: bool = False):
        super().__init__()
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is None:
            return conv_same(x, self.weight, self.bias)
        ch = x.shape[1]
        return (conv_same(x, self.weight[:, :ch], self.bias)
                + conv_same(skip, self.weight[:, ch:]))


class ResidualBlock(nn.Module):
    """Pre-activation residual block with additive time conditioning:
    GN→SiLU→3×3 conv, GN(+time bias)→SiLU→3×3 conv (zero-init), plus a
    1×1 shortcut when the channel count changes.

    ``skip_channels``: a second input, concatenated after x (the UNet's
    skip connection), is consumed through split GN/convs when
    ``split_skip`` is set and no group straddles the boundary, and through
    a real concat otherwise. The parameters are the same either way.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_groups: int = 32,
                 dropout: float = 0.0, conv_bias: bool = False,
                 skip_channels: int = 0, split_skip: bool = True):
        super().__init__()
        ctot = in_channels + skip_channels
        gs = ctot // gn_ops.resolve_num_groups(ctot, num_groups)
        self.split = (split_skip and skip_channels > 0
                      and in_channels % gs == 0 and ctot != out_channels)
        self.norm1 = GroupNormSiLU(ctot, num_groups)
        self.conv1 = SplitConv(ctot, out_channels, 3, conv_bias)
        self.time_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNormSiLU(out_channels, num_groups)
        self.dropout = nn.Dropout(dropout) if dropout > 0.0 else None
        self.conv2 = SplitConv(out_channels, out_channels, 3, conv_bias)
        self.shortcut = (SplitConv(ctot, out_channels, 1, conv_bias)
                         if ctot != out_channels else None)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None and not self.split:
            # Concatenated in NHWC, so the result stays channels_last.
            x = to_nchw(torch.cat([to_nhwc(x), to_nhwc(skip)], dim=-1))
            skip = None
        if skip is None:
            h = self.conv1(self.norm1(x))
        else:
            h = self.conv1(*self.norm1(x, skip=skip))
        # The [B, C] time bias goes into norm2's statistics; it is never
        # added to h first.
        h = self.norm2(h, time_bias=self.time_proj(t_emb))
        if self.dropout is not None:
            group = spatial.active()
            h = (self.dropout(h) if group is None or not self.training
                 else dropout_rows(h, self.dropout.p, group))
        h = self.conv2(h)
        if self.shortcut is not None:
            x = self.shortcut(x, skip)
        return h + x


class Downsample(nn.Module):
    """Stride-2 4×4 conv, padding 1. On row blocks of a spatial group:
    output row o reads input rows 2o−1 … 2o+2, so one halo row each side;
    an output of fewer than ``MIN_ROWS`` rows is computed whole from the
    gathered input (and returned whole)."""

    def __init__(self, channels: int, conv_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 4, 2, 1, bias=conv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = spatial.active()
        if group is None:
            return self.conv(x)
        spatial.refuse_grad(x, self.conv.weight)
        if x.shape[2] * group.size // 2 < spatial.MIN_ROWS:
            return self.conv(group.gather(x))
        return F.conv2d(group.halo(x, 1), self.conv.weight, self.conv.bias,
                        stride=2, padding=(0, 1))


class Upsample(nn.Module):
    """2× upsample by a 4×4 stride-2 transposed conv, padding 1 (the
    reference's flax "SAME" transpose conv with its kernel spatially
    flipped; :mod:`..convert` does the flip)."""

    def __init__(self, channels: int, conv_bias: bool = False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(channels, channels, 4, 2, 1,
                                       bias=conv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = spatial.active()
        if group is None:
            return self.conv(x)
        # Output row o = 2i − 1 + k of input row i and tap k, so rows
        # [2·lo, 2·hi) read input rows lo−1 … hi: one halo row each side.
        # Unpadded in height, the 2h+6 rows start at global row 2·lo − 3.
        spatial.refuse_grad(x, self.conv.weight)
        h = x.shape[2]
        y = F.conv_transpose2d(group.halo(x, 1), self.conv.weight,
                               self.conv.bias, stride=2, padding=(0, 1))
        return y[:, :, 3:3 + 2 * h].contiguous(
            memory_format=torch.channels_last)


class _Stage(nn.Module):
    """``num_layers`` ResidualBlocks (each followed by self-attention when
    ``num_att_heads`` is set), then an optional down- or upsample.

    Only the first block takes the skip connection (``split_skip`` as in
    :class:`ResidualBlock`).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, resample: Optional[str],
                 num_layers: int = 2, num_groups: int = 32,
                 num_att_heads: Optional[int] = None, dropout: float = 0.0,
                 conv_bias: bool = False, skip_channels: int = 0,
                 split_skip: bool = True):
        super().__init__()
        self.num_layers = num_layers
        self.has_attention = num_att_heads is not None
        for i in range(num_layers):
            self.add_module(f"res{i}", ResidualBlock(
                in_channels if i == 0 else out_channels, out_channels,
                temb_channels, num_groups, dropout, conv_bias,
                skip_channels if i == 0 else 0, split_skip))
            if self.has_attention:
                self.add_module(f"attn{i}", SelfAttentionBlock(
                    out_channels, num_att_heads, num_groups))
        if resample == "down":
            self.down = Downsample(out_channels, conv_bias)
        elif resample == "up":
            self.up = Upsample(out_channels, conv_bias)
        self.resample = resample

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"res{i}")(x, t_emb, skip if i == 0 else None)
            if self.has_attention:
                x = getattr(self, f"attn{i}")(x)
        if self.resample == "down":
            x = self.down(x)
        elif self.resample == "up":
            x = self.up(x)
        return x


class ConvDownBlock(_Stage):
    """``num_layers`` ResidualBlocks then a stride-2 downsample."""

    def __init__(self, in_channels, out_channels, temb_channels, **kw):
        super().__init__(in_channels, out_channels, temb_channels, "down",
                         **kw)


class ConvUpBlock(_Stage):
    """ResidualBlocks (the first takes the skip) then a 2× upsample."""

    def __init__(self, in_channels, out_channels, temb_channels, **kw):
        super().__init__(in_channels, out_channels, temb_channels, "up", **kw)


class AttentionDownBlock(_Stage):
    """(ResidualBlock → SelfAttention) × num_layers, then an optional
    downsample."""

    def __init__(self, in_channels, out_channels, temb_channels,
                 num_att_heads: int = 4, downsample: bool = True, **kw):
        super().__init__(in_channels, out_channels, temb_channels,
                         "down" if downsample else None,
                         num_att_heads=num_att_heads, **kw)


class AttentionUpBlock(_Stage):
    """(ResidualBlock → SelfAttention) × num_layers, then an optional
    upsample."""

    def __init__(self, in_channels, out_channels, temb_channels,
                 num_att_heads: int = 4, upsample: bool = True, **kw):
        super().__init__(in_channels, out_channels, temb_channels,
                         "up" if upsample else None,
                         num_att_heads=num_att_heads, **kw)
