"""Spatial self-attention block (counterpart of the reference's
``models/layers/attention.py``): flatten H×W to tokens in (h, w) order,
Linear Q/K/V, multi-head attention, output Linear, then a post-residual
GroupNorm with no activation."""

from __future__ import annotations

import torch
from torch import nn

from ...ops import attention as attn_ops
from ...ops import group_norm as gn_ops


class SelfAttentionBlock(nn.Module):
    """Multi-head spatial self-attention with post-residual GroupNorm.

    Takes and returns NCHW tensors in channels_last memory. Head n owns
    channels ``n·D:(n+1)·D`` of each projection. The norm's f32 γ and β
    keep the reference's names, ``norm_scale`` and ``norm_bias``.
    """

    def __init__(self, embedding_dim: int, num_heads: int = 4,
                 num_groups: int = 32):
        super().__init__()
        self.num_heads = num_heads
        self.num_groups = gn_ops.resolve_num_groups(embedding_dim, num_groups)
        self.query = nn.Linear(embedding_dim, embedding_dim)
        self.key = nn.Linear(embedding_dim, embedding_dim)
        self.value = nn.Linear(embedding_dim, embedding_dim)
        self.proj = nn.Linear(embedding_dim, embedding_dim)
        self.norm_scale = nn.Parameter(torch.ones(embedding_dim))
        self.norm_bias = nn.Parameter(torch.zeros(embedding_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        s, n = h * w, self.num_heads
        x_nhwc = x.contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        tokens = x_nhwc.reshape(b, s, c)

        def split(z):  # [B, S, N·D] -> [B, N, S, D] view
            return z.view(b, s, n, c // n).transpose(1, 2)

        out = attn_ops.multi_head_attention(split(self.query(tokens)),
                                            split(self.key(tokens)),
                                            split(self.value(tokens)))
        out = self.proj(out.transpose(1, 2).reshape(b, s, c))
        y = gn_ops.group_norm_silu(out.view(b, h, w, c) + x_nhwc,
                                   self.norm_scale, self.norm_bias,
                                   self.num_groups, apply_silu=False)
        return y.permute(0, 3, 1, 2)
