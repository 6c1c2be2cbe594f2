"""UNet building blocks of the port."""

from .attention import SelfAttentionBlock
from .embeddings import SigmaEmbedding, TimeEmbedding, sinusoidal_embedding
from .resnet import (AttentionDownBlock, AttentionUpBlock, ConvDownBlock,
                     ConvUpBlock, Downsample, GroupNormSiLU, ResidualBlock,
                     SplitConv, Upsample)

__all__ = [
    "AttentionDownBlock", "AttentionUpBlock", "ConvDownBlock", "ConvUpBlock",
    "Downsample", "GroupNormSiLU", "ResidualBlock", "SelfAttentionBlock",
    "SigmaEmbedding", "SplitConv", "TimeEmbedding", "Upsample",
    "sinusoidal_embedding",
]
