"""Timestep embeddings (counterpart of the reference's
``models/layers/embeddings.py``): a sinusoidal encoding of the integer
timestep followed by a 2-layer MLP, and the score network's embedding of
a continuous noise level σ."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Frequencies exp(arange(half)·(−ln 10000/(half−1))), concat(sin, cos).
    Returns f32 [B, dim] for a [B] input."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class TimeEmbedding(nn.Module):
    """Sinusoid → Linear → exact-erf GELU → Linear.

    Runs in the dtype of its Linear weights (the model's compute dtype).
    """

    def __init__(self, base_dim: int, output_dim: int):
        super().__init__()
        self.base_dim = base_dim
        self.dense1 = nn.Linear(base_dim, output_dim)
        self.dense2 = nn.Linear(output_dim, output_dim)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_embedding(t, self.base_dim)
        emb = self.dense1(emb.to(self.dense1.weight.dtype))
        return self.dense2(F.gelu(emb, approximate="none"))


class SigmaEmbedding(nn.Module):
    """Continuous noise-level embedding of the score network: log σ
    (taken in f32) → Linear(1, C) → SiLU → Linear(C, 4C), in the dtype of
    its Linear weights. ``sigma`` is [B] f32."""

    def __init__(self, base_dim: int, output_dim: int):
        super().__init__()
        self.dense1 = nn.Linear(1, base_dim)
        self.dense2 = nn.Linear(base_dim, output_dim)

    def forward(self, sigma: torch.Tensor) -> torch.Tensor:
        log_sigma = torch.log(sigma.float())[:, None]
        h = self.dense1(log_sigma.to(self.dense1.weight.dtype))
        return self.dense2(F.silu(h))
