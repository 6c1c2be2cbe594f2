"""VGG16 features for the perceptual loss (counterpart of the reference's
``utils/vgg.py``).

The first seven convs of torchvision's ``vgg16().features`` with their
torchvision names (``features.0``, ``features.2``, ...), max pools before
conv 2 and conv 4, and taps after ReLU 1_2, 2_2 and 3_3. Weights come from
a file the user supplies, never a download: the reference's ``.npz``
(``conv{i}/w`` HWIO, ``conv{i}/b``) or a torchvision ``.pth`` state dict
(its later layers and classifier are ignored). ``DMU_VGG16_WEIGHTS`` names
the file for ``utils.losses.PerceptualLoss``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (torchvision features index, cin, cout) of the seven convs.
CONVS = [
    (0, 3, 64), (2, 64, 64),
    (5, 64, 128), (7, 128, 128),
    (10, 128, 256), (12, 256, 256), (14, 256, 256),
]
TAPS = (1, 3, 6)           # taps after these convs (positions in CONVS)
POOL_BEFORE = (2, 4)       # a 2×2 max pool before these convs


class VGG16Features(nn.Module):
    """ImageNet-normalized NCHW images → [relu1_2, relu2_2, relu3_3]."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict({
            str(idx): nn.Conv2d(cin, cout, 3, padding=1)
            for idx, cin, cout in CONVS})

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        h = x
        for i, (idx, _, _) in enumerate(CONVS):
            if i in POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(self.features[str(idx)](h))
            if i in TAPS:
                taps.append(h)
        return taps


def init_vgg16_(net: VGG16Features, generator: torch.Generator
                ) -> VGG16Features:
    """Seeded He-normal weights and zero biases, the reference's
    initializers."""
    with torch.no_grad():
        for conv in net.features.values():
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator)
                              * (2.0 / fan_in) ** 0.5)
            conv.bias.zero_()
    return net


def load_vgg16_params(path: str) -> Dict[str, torch.Tensor]:
    """The :class:`VGG16Features` state dict in a weights file: the
    reference's ``.npz`` or a torchvision ``vgg16`` ``.pth``."""
    if path.endswith(".npz"):
        from ..models.convert import vgg16_state_dict_from_jax
        with np.load(path) as flat:
            return vgg16_state_dict_from_jax(
                [(flat[f"conv{i}/w"], flat[f"conv{i}/b"])
                 for i in range(len(CONVS))])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {f"features.{idx}.{leaf}": sd[f"features.{idx}.{leaf}"]
            for idx, _, _ in CONVS for leaf in ("weight", "bias")}
