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

The flax tree is nested dicts of numpy arrays, as the reference's
model-only checkpoint pickles it, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

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


def state_dict_to_jax(module: nn.Module,
                      tensors: Dict[str, torch.Tensor]) -> Tree:
    """Any tensors keyed and shaped like ``module``'s state_dict (weights,
    gradients, Adam moments, an EMA) → the flax tree, leaf by leaf with the
    rules above; ``module`` names the owner of each key."""
    tree: Tree = {}
    for key, value in tensors.items():
        prefix, _, name = key.rpartition(".")
        owner = module.get_submodule(prefix)
        a = value.detach().to("cpu", torch.float32).numpy()
        if name == "weight":
            if isinstance(owner, nn.ConvTranspose2d):
                a, name = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1), "kernel"
            elif a.ndim == 4:
                a, name = a.transpose(2, 3, 1, 0), "kernel"
            elif isinstance(owner, nn.Linear):
                a, name = a.T, "kernel"
            elif isinstance(owner, nn.Embedding):
                name = "embedding"
            elif isinstance(owner, GroupNormSiLU):
                name = "scale"
            else:
                raise ValueError(f"no flax counterpart for {key}")
        node = tree
        for part in filter(None, prefix.split(".")):
            node = node.setdefault(part, {})
        node[name] = np.array(a, dtype=np.float32, order="C")
    return tree
