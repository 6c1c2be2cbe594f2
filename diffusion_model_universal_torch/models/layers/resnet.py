"""Residual / up / down blocks of the UNet (counterpart of the
reference's ``models/layers/resnet.py``).

Activations are NCHW tensors in ``torch.channels_last`` memory, so
``x.permute(0, 2, 3, 1)`` is a contiguous NHWC view: the GroupNorm op
reads it without a copy. Submodules are named after the reference's flax
parameter tree (``norm1``, ``conv1``, ``time_proj``, ...), which keeps the
weight bridge in :mod:`..convert` mechanical.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import group_norm as gn_ops
from .attention import SelfAttentionBlock


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → a contiguous NHWC view (a copy only if ``x`` is not already
    in channels_last memory)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC → an NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


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
            return F.conv2d(x, self.weight, self.bias, padding=self.padding)
        ch = x.shape[1]
        return (F.conv2d(x, self.weight[:, :ch], self.bias,
                         padding=self.padding)
                + F.conv2d(skip, self.weight[:, ch:], padding=self.padding))


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
            h = self.dropout(h)
        h = self.conv2(h)
        if self.shortcut is not None:
            x = self.shortcut(x, skip)
        return h + x


class Downsample(nn.Module):
    """Stride-2 4×4 conv, padding 1."""

    def __init__(self, channels: int, conv_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 4, 2, 1, bias=conv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """2× upsample by a 4×4 stride-2 transposed conv, padding 1 (the
    reference's flax "SAME" transpose conv with its kernel spatially
    flipped; :mod:`..convert` does the flip)."""

    def __init__(self, channels: int, conv_bias: bool = False):
        super().__init__()
        self.conv = nn.ConvTranspose2d(channels, channels, 4, 2, 1,
                                       bias=conv_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


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
