"""Spatial self-attention block (counterpart of the reference's
``models/layers/attention.py``): flatten H×W to tokens in (h, w) order,
Linear Q/K/V, multi-head attention, output Linear, then a post-residual
GroupNorm with no activation.

On row blocks of a spatial group (``parallel.spatial.split``) the block
gathers its input's rows, computes Q, K, V and the attention over the
whole sequence on every rank of the group (K3 as one process runs it),
keeps the rank's rows of the attention's output, and applies the output
Linear, the residual and the post-residual GroupNorm (K1's split form)
to those rows. In the backward, the gradient reaching the gathered
input on a rank comes from its own output rows only; the gather's
gradient sums it over the group before keeping the rank's rows
(``RowGroup.gather``)."""

from __future__ import annotations

import torch
from torch import nn

from ...ops import attention as attn_ops
from ...ops import group_norm as gn_ops
from ...parallel import spatial


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
        group = spatial.active()
        x_nhwc = x.contiguous(
            memory_format=torch.channels_last).permute(0, 2, 3, 1)
        whole = x_nhwc
        if group is not None:
            whole = group.gather(x).permute(0, 2, 3, 1)
        b, h, w, c = whole.shape
        s, n = h * w, self.num_heads
        tokens = whole.reshape(b, s, c)

        def split(z):  # [B, S, N·D] -> [B, N, S, D] view
            return z.view(b, s, n, c // n).transpose(1, 2)

        out = attn_ops.multi_head_attention(split(self.query(tokens)),
                                            split(self.key(tokens)),
                                            split(self.value(tokens)))
        out = out.transpose(1, 2).reshape(b, h, w, c)
        if group is not None:
            lo, hi = group.rows(h)
            out = out[:, lo:hi]
        h = out.shape[1]
        out = self.proj(out.reshape(b, h * w, c))
        y = out.view(b, h, w, c) + x_nhwc
        if group is not None:
            y = gn_ops.group_norm_silu_split(
                y, self.norm_scale, self.norm_bias, self.num_groups, group,
                apply_silu=False)
        else:
            y = gn_ops.group_norm_silu(y, self.norm_scale, self.norm_bias,
                                       self.num_groups, apply_silu=False)
        return y.permute(0, 3, 1, 2)
