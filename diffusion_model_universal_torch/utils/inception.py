"""InceptionV3 feature extractor for FID and the Inception Score
(counterpart of the reference's ``utils/inception.py``).

The architecture is torchvision's ``inception_v3`` without its auxiliary
head (it adds nothing to the features or logits at eval): 2048-d pooled
features (FID's "pool3") and 1000 class logits (the Inception Score).
Every submodule carries torchvision's name (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, ..., ``fc``), so torchvision's ImageNet state
dict loads strictly once its ``AuxLogits.*`` entries are dropped.

Weights are never downloaded. :func:`load_inception_params` reads either
the reference's flat ``.npz`` (keys ``Conv2d_1a_3x3/w``, ..., HWIO conv
kernels) or a torchvision ``.pth`` state dict, so one converted file
serves both packages. ``DMU_INCEPTION_WEIGHTS`` names that file for
``utils.benchmarks.make_extractor``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (name, out_channels, kernel, stride, padding) of the stem convs; the
# max pools sit after Conv2d_2b_3x3 and Conv2d_4a_3x3.
_STEM = [
    ("Conv2d_1a_3x3", 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 64, (3, 3), 1, (1, 1)),
    ("Conv2d_3b_1x1", 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 192, (3, 3), 1, (0, 0)),
]
_POOL_AFTER = ("Conv2d_2b_3x3", "Conv2d_4a_3x3")


def _branch_specs(kind: str, cin):
    """(branch name, cout, (kh, kw), cin, stride) of each BasicConv2d of a
    torchvision InceptionA..E block."""
    if kind == "a":
        cin, pool_features = cin
        return [("branch1x1", 64, (1, 1), cin, 1),
                ("branch5x5_1", 48, (1, 1), cin, 1),
                ("branch5x5_2", 64, (5, 5), 48, 1),
                ("branch3x3dbl_1", 64, (1, 1), cin, 1),
                ("branch3x3dbl_2", 96, (3, 3), 64, 1),
                ("branch3x3dbl_3", 96, (3, 3), 96, 1),
                ("branch_pool", pool_features, (1, 1), cin, 1)]
    if kind == "b":
        return [("branch3x3", 384, (3, 3), cin, 2),
                ("branch3x3dbl_1", 64, (1, 1), cin, 1),
                ("branch3x3dbl_2", 96, (3, 3), 64, 1),
                ("branch3x3dbl_3", 96, (3, 3), 96, 2)]
    if kind == "c":
        cin, c7 = cin
        return [("branch1x1", 192, (1, 1), cin, 1),
                ("branch7x7_1", c7, (1, 1), cin, 1),
                ("branch7x7_2", c7, (1, 7), c7, 1),
                ("branch7x7_3", 192, (7, 1), c7, 1),
                ("branch7x7dbl_1", c7, (1, 1), cin, 1),
                ("branch7x7dbl_2", c7, (7, 1), c7, 1),
                ("branch7x7dbl_3", c7, (1, 7), c7, 1),
                ("branch7x7dbl_4", c7, (7, 1), c7, 1),
                ("branch7x7dbl_5", 192, (1, 7), c7, 1),
                ("branch_pool", 192, (1, 1), cin, 1)]
    if kind == "d":
        return [("branch3x3_1", 192, (1, 1), cin, 1),
                ("branch3x3_2", 320, (3, 3), 192, 2),
                ("branch7x7x3_1", 192, (1, 1), cin, 1),
                ("branch7x7x3_2", 192, (1, 7), 192, 1),
                ("branch7x7x3_3", 192, (7, 1), 192, 1),
                ("branch7x7x3_4", 192, (3, 3), 192, 2)]
    if kind == "e":
        return [("branch1x1", 320, (1, 1), cin, 1),
                ("branch3x3_1", 384, (1, 1), cin, 1),
                ("branch3x3_2a", 384, (1, 3), 384, 1),
                ("branch3x3_2b", 384, (3, 1), 384, 1),
                ("branch3x3dbl_1", 448, (1, 1), cin, 1),
                ("branch3x3dbl_2", 384, (3, 3), 448, 1),
                ("branch3x3dbl_3a", 384, (1, 3), 384, 1),
                ("branch3x3dbl_3b", 384, (3, 1), 384, 1),
                ("branch_pool", 192, (1, 1), cin, 1)]
    raise ValueError(kind)


# torchvision's blocks: (module name, kind, cin spec).
_LAYOUT = [
    ("Mixed_5b", "a", (192, 32)), ("Mixed_5c", "a", (256, 64)),
    ("Mixed_5d", "a", (288, 64)), ("Mixed_6a", "b", 288),
    ("Mixed_6b", "c", (768, 128)), ("Mixed_6c", "c", (768, 160)),
    ("Mixed_6d", "c", (768, 160)), ("Mixed_6e", "c", (768, 192)),
    ("Mixed_7a", "d", 768), ("Mixed_7b", "e", 1280),
    ("Mixed_7c", "e", 2048),
]


class BasicConv2d(nn.Module):
    """Conv without bias → BatchNorm (eval statistics, eps 1e-3) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 average pool, pad 1, the padding counted."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class InceptionBlock(nn.Module):
    """One of torchvision's InceptionA..E: its BasicConv2d branches under
    their torchvision names. Stride-1 convs pad to keep the size, stride-2
    convs pad nothing."""

    def __init__(self, kind: str, cin):
        super().__init__()
        self.kind = kind
        for name, cout, (kh, kw), bcin, stride in _branch_specs(kind, cin):
            pad = (0, 0) if stride == 2 else (kh // 2, kw // 2)
            self.add_module(name, BasicConv2d(bcin, cout, (kh, kw), stride,
                                              pad))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kind
        if k == "a":
            return torch.cat([
                self.branch1x1(x),
                self.branch5x5_2(self.branch5x5_1(x)),
                self.branch3x3dbl_3(self.branch3x3dbl_2(
                    self.branch3x3dbl_1(x))),
                self.branch_pool(_avgpool3(x))], dim=1)
        if k == "b":
            return torch.cat([
                self.branch3x3(x),
                self.branch3x3dbl_3(self.branch3x3dbl_2(
                    self.branch3x3dbl_1(x))),
                _maxpool(x)], dim=1)
        if k == "c":
            b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
            bd = self.branch7x7dbl_1(x)
            for i in range(2, 6):
                bd = getattr(self, f"branch7x7dbl_{i}")(bd)
            return torch.cat([self.branch1x1(x), b7, bd,
                              self.branch_pool(_avgpool3(x))], dim=1)
        if k == "d":
            b3 = self.branch3x3_2(self.branch3x3_1(x))
            b7 = self.branch7x7x3_1(x)
            for i in range(2, 5):
                b7 = getattr(self, f"branch7x7x3_{i}")(b7)
            return torch.cat([b3, b7, _maxpool(x)], dim=1)
        b3 = self.branch3x3_1(x)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(_avgpool3(x))], dim=1)


class InceptionV3(nn.Module):
    """ImageNet-normalized NCHW images (299² for the standard features) →
    (pooled features [B, 2048], logits [B, 1000])."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, cout, kernel, stride, padding in _STEM:
            self.add_module(name, BasicConv2d(cin, cout, kernel, stride,
                                              padding))
            cin = cout
        for name, kind, cin_spec in _LAYOUT:
            self.add_module(name, InceptionBlock(kind, cin_spec))
        self.fc = nn.Linear(2048, 1000)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        for name, *_ in _STEM:
            h = getattr(self, name)(h)
            if name in _POOL_AFTER:
                h = _maxpool(h)
        for name, _, _ in _LAYOUT:
            h = getattr(self, name)(h)
        feats = h.mean(dim=(2, 3))
        return feats, self.fc(feats)


def init_inception_(net: InceptionV3, generator: torch.Generator
                    ) -> InceptionV3:
    """Seeded random weights with the reference's initializers: He-normal
    convs, identity BatchNorm statistics, fc ~ N(0, 1/2048), zero bias."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator)
                               * (2.0 / fan_in) ** 0.5)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        net.fc.weight.copy_(torch.randn(net.fc.weight.shape,
                                        generator=generator) * 2048 ** -0.5)
        net.fc.bias.zero_()
    return net


# -- weights ----------------------------------------------------------------

def unflatten_npz(path: str) -> Dict:
    """A flat ``a/b/c``-keyed ``.npz`` → nested dicts of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


def flatten_to_npz(tree: Dict, path: str) -> None:
    """Nested dicts of arrays → a flat ``a/b/c``-keyed ``.npz``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_inception_params(path: str) -> Dict[str, torch.Tensor]:
    """The :class:`InceptionV3` state dict in a weights file: the
    reference's ``.npz`` or a torchvision ``.pth`` (its ``AuxLogits.*``
    entries dropped)."""
    from ..models.convert import inception_state_dict_from_jax
    if path.endswith(".npz"):
        return inception_state_dict_from_jax(unflatten_npz(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}


def save_inception_npz(net: InceptionV3, path: str) -> None:
    """Write ``net``'s weights as the reference's flat ``.npz``."""
    from ..models.convert import inception_params_to_jax
    flatten_to_npz(inception_params_to_jax(net), path)


# -- extractor front end ----------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """NCHW images in [0, 1] → ImageNet-normalized."""
    mean = x.new_tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
    std = x.new_tensor(IMAGENET_STD).view(1, 3, 1, 1)
    return (x - mean) / std


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW bilinear resize to size², antialiased when it shrinks, as the
    reference's ``jax.image.resize(..., "bilinear")``. Growing, the
    antialiased and the plain filter agree; the plain one is the faster
    on the card."""
    h, w = x.shape[-2:]
    if (h, w) == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False,
                         antialias=size < h or size < w)


def nhwc_to_nchw3(images, device: torch.device) -> torch.Tensor:
    """NHWC images (numpy or tensor) → contiguous f32 NCHW on ``device``,
    one channel repeated to three. (On the permuted, channels-last
    strides cuDNN ran InceptionV3's f32 convs slower on the H100:
    ``PERF.md``.)"""
    x = torch.as_tensor(images).to(device, torch.float32)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return x.permute(0, 3, 1, 2).contiguous()


class InceptionExtractor:
    """[−1, 1] NHWC images → (2048-d pool features, 1000 logits) on the
    device: [0, 1], bilinear 299², ImageNet-normalized, InceptionV3 in
    f32.

    Args:
        state_dict: :class:`InceptionV3` weights; or
        weights_path: a file :func:`load_inception_params` reads.
        device: ``cuda`` unless given.
    """

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        from ..models.base import resolve_device
        if state_dict is None:
            if weights_path is None:
                raise ValueError("need state_dict or weights_path")
            state_dict = load_inception_params(weights_path)
        self.device = resolve_device(device)
        net = InceptionV3()
        net.load_state_dict(state_dict, strict=True)
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        x = (nhwc_to_nchw3(images, self.device) + 1.0) / 2.0
        return self.net(imagenet_normalize(resize_bilinear(x, 299)))
