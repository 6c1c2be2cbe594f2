"""The weight bridge between the reference's flax parameter trees (the
UNet, with either time embedding, and the EnergyNet) and the port's
``state_dict``s.

The port names its submodules after the flax tree (``down0.res0.norm1``,
``mid_attn.query``, ``time_embedding.dense1``, ...), so the mapping is per
leaf:

* conv ``kernel`` ``[kh, kw, I, O]`` ↔ ``weight`` ``[O, I, kh, kw]``
* transposed-conv ``kernel`` ``[kh, kw, I, O]`` ↔ spatially flipped
  ``weight`` ``[I, O, kh, kw]`` (the up stages' ``up.conv``)
* Dense ``kernel`` ``[I, O]`` ↔ Linear ``weight`` ``[O, I]``
* GroupNorm ``scale`` ↔ ``weight``; ``embedding`` ↔ ``weight``
* every other leaf (``bias``, ``norm_scale``, ``norm_bias``, and the
  EnergyNet's top-level ``norm1_scale``/``norm1_bias``/...) keeps its name
  and layout.

The sample-quality harness's networks cross the same way: the seeded
extractor's ``filters`` (HWIO) and ``head``, InceptionV3's nested tree
(conv ``w`` HWIO, BatchNorm ``bn_w``/``bn_b``/``bn_mean``/``bn_var``, the
``fc`` ``w`` [2048, 1000] and ``b``) and VGG16's ``[(w, b)]`` list.

The flax tree is nested dicts of numpy arrays, as the reference's
model-only checkpoint pickles it, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.vgg import CONVS as VGG_CONVS
from .layers import GroupNormSiLU

Tree = Dict[str, Any]


def _leaves(tree: Tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def unet_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """Flax UNet params (nested dicts of arrays) → the port's state_dict,
    to be loaded with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        a = np.asarray(leaf, np.float32)
        *mods, name = path
        if name == "kernel" and a.ndim == 4:
            if mods[-2:-1] == ["up"]:   # transposed conv of an up stage
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                a = a.transpose(3, 2, 0, 1)
            name = "weight"
        elif name == "kernel":
            a, name = a.T, "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        sd[".".join(mods + [name])] = torch.from_numpy(
            np.array(a, dtype=np.float32, order="C"))
    return sd


def unet_params_to_jax(module: nn.Module) -> Tree:
    """The port's UNet → flax params as nested dicts of f32 numpy arrays:
    the exact inverse of :func:`unet_state_dict_from_jax`."""
    return state_dict_to_jax(module, module.state_dict())


def flax_layout(owner: nn.Module, key: str, name: str, ndim: int
                ) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    """The flax counterpart of parameter ``name`` (``key`` in full) of
    ``owner``: ``(flax_name, perm, flipped)``, where flax axis k is axis
    ``perm[k]`` of the port's tensor, read in reverse along the axes in
    ``flipped`` (the rules above)."""
    if name != "weight":
        return name, tuple(range(ndim)), ()
    if isinstance(owner, nn.ConvTranspose2d):
        return "kernel", (2, 3, 0, 1), (2, 3)
    if ndim == 4:
        return "kernel", (2, 3, 1, 0), ()
    if isinstance(owner, nn.Linear):
        return "kernel", (1, 0), ()
    if isinstance(owner, nn.Embedding):
        return "embedding", (0, 1), ()
    if isinstance(owner, GroupNormSiLU):
        return "scale", (0,), ()
    raise ValueError(f"no flax counterpart for {key}")


def state_dict_to_jax(module: nn.Module,
                      tensors: Dict[str, torch.Tensor]) -> Tree:
    """Any tensors keyed and shaped like ``module``'s state_dict (weights,
    gradients, Adam moments, an EMA) → the flax tree, leaf by leaf with the
    rules above; ``module`` names the owner of each key."""
    tree: Tree = {}
    for key, value in tensors.items():
        prefix, _, name = key.rpartition(".")
        a = value.detach().to("cpu", torch.float32).numpy()
        name, perm, flipped = flax_layout(module.get_submodule(prefix), key,
                                          name, a.ndim)
        if flipped:
            a = np.flip(a, flipped)
        a = a.transpose(perm)
        node = tree
        for part in filter(None, prefix.split(".")):
            node = node.setdefault(part, {})
        node[name] = np.array(a, dtype=np.float32, order="C")
    return tree


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _oihw(w) -> torch.Tensor:
    """Conv kernel HWIO → OIHW."""
    return _tensor(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def feature_extractor_state_dict_from_jax(filters, head
                                          ) -> Dict[str, torch.Tensor]:
    """The reference's seeded extractor (``filters`` HWIO, ``head``
    [features, classes]) → ``utils.benchmarks.FeatureExtractor``'s
    state dict."""
    sd = {f"convs.{i}.weight": _oihw(w) for i, w in enumerate(filters)}
    sd["head"] = _tensor(head)
    return sd


_BN_LEAVES = (("bn_w", "bn.weight"), ("bn_b", "bn.bias"),
              ("bn_mean", "bn.running_mean"), ("bn_var", "bn.running_var"))


def inception_state_dict_from_jax(params: Tree) -> Dict[str, torch.Tensor]:
    """The reference's InceptionV3 tree → ``utils.inception.InceptionV3``'s
    (torchvision-named) state dict, to be loaded with ``strict=True``."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Tree, prefix: str) -> None:
        if "bn_w" in node:
            sd[f"{prefix}.conv.weight"] = _oihw(node["w"])
            for ours, theirs in _BN_LEAVES:
                sd[f"{prefix}.{theirs}"] = _tensor(node[ours])
            sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
            return
        for k, v in node.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk({k: v for k, v in params.items() if k != "fc"}, "")
    sd["fc.weight"] = _tensor(np.asarray(params["fc"]["w"]).T)
    sd["fc.bias"] = _tensor(params["fc"]["b"])
    return sd


def inception_params_to_jax(module: nn.Module) -> Tree:
    """``InceptionV3`` → the reference's tree, the inverse of
    :func:`inception_state_dict_from_jax`."""
    tree: Tree = {}
    sd = module.state_dict()

    def arr(key):
        return sd[key].detach().to("cpu", torch.float32).numpy().copy()

    for key in sd:
        if not key.endswith(".conv.weight"):
            continue
        prefix = key[:-len(".conv.weight")]
        node = tree
        for part in prefix.split("."):
            node = node.setdefault(part, {})
        node["w"] = arr(key).transpose(2, 3, 1, 0).copy()
        for ours, theirs in _BN_LEAVES:
            node[ours] = arr(f"{prefix}.{theirs}")
    tree["fc"] = {"w": arr("fc.weight").T.copy(), "b": arr("fc.bias")}
    return tree


def vgg16_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """The reference's VGG16 ``[(w HWIO, b)]`` list →
    ``utils.vgg.VGG16Features``' state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for (idx, _, _), (w, b) in zip(VGG_CONVS, params, strict=True):
        sd[f"features.{idx}.weight"] = _oihw(w)
        sd[f"features.{idx}.bias"] = _tensor(b)
    return sd
