"""UNet building blocks of the port."""

from .attention import SelfAttentionBlock
from .embeddings import TimeEmbedding, sinusoidal_embedding
from .resnet import (AttentionDownBlock, AttentionUpBlock, ConvDownBlock,
                     ConvUpBlock, Downsample, GroupNormSiLU, ResidualBlock,
                     SplitConv, Upsample)

__all__ = [
    "AttentionDownBlock", "AttentionUpBlock", "ConvDownBlock", "ConvUpBlock",
    "Downsample", "GroupNormSiLU", "ResidualBlock", "SelfAttentionBlock",
    "SplitConv", "TimeEmbedding", "Upsample", "sinusoidal_embedding",
]
