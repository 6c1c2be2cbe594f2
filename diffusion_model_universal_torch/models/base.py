"""Base diffusion-model contract of the port (counterpart of the
reference's ``models/base.py``).

A model object holds its configuration, its device, its noise-prediction
network ``net`` (an ``nn.Module`` in ``eval()``) and the compute dtype of
the network's conv and Linear weights. Checkpoints use the reference's
model-only pickle, ``{model_state_dict, config}``, whose state dict is the
flax parameter tree as nested dicts of numpy arrays; both packages read
and write the same file.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

from ..utils.config import canonicalize_model_config
from .convert import unet_params_to_jax, unet_state_dict_from_jax

Draw = Callable[[], torch.Tensor]
Noise = Optional[Iterable[torch.Tensor]]
#: (lo, hi, n): a batch that holds rows [lo, hi) of a global batch of n
#: (one rank's share under data parallelism).
Rows = Optional[Tuple[int, int, int]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device to run on: ``cuda`` unless the caller names another.

    Raises if CUDA is asked for and missing: nothing falls back to the
    CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() "
                           "is false; pass device='cpu' (--device cpu) to "
                           "run on the CPU")
    return dev


def row_draws(b: int, rows: Rows) -> Tuple[int, slice]:
    """(n, keep) for a batch of ``b`` rows that are ``rows`` of a global
    batch: a loss's random inputs, drawn or given, are those of all n
    rows of the global batch (a loss draws them for all n), and it keeps
    ``[keep]``; so every layout of the ranks draws what one process
    would, and batch-wide terms (the time weights' range) are the global
    batch's."""
    if rows is None:
        return b, slice(None)
    lo, hi, n = rows
    if hi - lo != b or not 0 <= lo <= hi <= n:
        raise ValueError(f"rows {rows} do not describe a batch of {b}")
    return n, slice(lo, hi)


class BaseDiffusionModel:
    """Static model description, device and network."""

    net: torch.nn.Module

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        self.config: Dict = canonicalize_model_config(config)
        self.device = resolve_device(device)
        self.image_size: int = self.config.get("image_size", 32)
        self.image_channels: int = self.config.get(
            "in_channels", self.config.get("image_channels", 3))
        # bf16 by default on the card, f32 on the CPU; the config key wins.
        dtype_name = self.config.get("compute_dtype")
        if dtype_name is None:
            dtype_name = "bfloat16" if self.device.type == "cuda" \
                else "float32"
        if dtype_name not in DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{tuple(DTYPES)}, got {dtype_name!r}")
        self.compute_dtype = DTYPES[dtype_name]

    def sample_shape(self, batch_size: int) -> Tuple[int, int, int, int]:
        """NHWC sample shape."""
        return (batch_size, self.image_size, self.image_size,
                self.image_channels)

    def _install_net(self, net: torch.nn.Module,
                     init: Callable[[torch.nn.Module, torch.Generator],
                                    torch.nn.Module],
                     seed: int, trainable: bool,
                     cast: Callable[[torch.nn.Module, torch.dtype],
                                    torch.nn.Module]) -> None:
        """Initialize ``net`` from a CPU generator seeded by ``seed``, move
        it to the device (conv weights in the activations' channels_last
        layout, so a conv does not copy its weight on every call) and set
        it as ``self.net`` in ``eval()``. Serving (``trainable`` false)
        casts the matmul weights to the compute dtype with ``cast``;
        training keeps f32 master weights and computes under autocast in
        a bf16 compute dtype."""
        init(net, torch.Generator().manual_seed(seed))
        net = net.to(self.device, memory_format=torch.channels_last)
        self.trainable = trainable
        self.autocast = trainable and self.compute_dtype != torch.float32
        if not trainable:
            net = cast(net, self.compute_dtype)
        self.net = net.eval()

    def _run_net(self, train: bool, *args) -> torch.Tensor:
        """``net(*args)`` with dropout on when ``train``, under autocast
        for a trainable bf16 model."""
        if self.net.training != train:
            self.net.train(train)
        with torch.autocast(self.device.type, dtype=self.compute_dtype,
                            enabled=self.autocast):
            return self.net(*args)

    # -- sampler draws ----------------------------------------------------
    def _drawer(self, shape, generator: Optional[torch.Generator],
                noise: Noise) -> Draw:
        """The sampler's source of N(0, I) draws of ``shape``: the next
        tensor of ``noise`` when given, else ``generator``."""
        if noise is not None:
            it = iter(noise)
            return lambda: next(it).to(self.device, torch.float32)
        return lambda: torch.randn(shape, generator=generator,
                                   device=self.device, dtype=torch.float32)

    def _t(self, b: int, t: int) -> torch.Tensor:
        """[b] integer timesteps ``t`` on the device."""
        return torch.full((b,), int(t), dtype=torch.long, device=self.device)

    def _init_noise(self, batch_size: int, draw: Draw) -> torch.Tensor:
        x = draw()
        if tuple(x.shape) != self.sample_shape(batch_size):
            raise ValueError(f"initial noise has shape {tuple(x.shape)}, "
                             f"expected {self.sample_shape(batch_size)}")
        return x

    # -- checkpointing ----------------------------------------------------
    def load_params(self, params: Dict) -> None:
        """Load a flax parameter tree (nested dicts of arrays) into
        ``net``, strictly."""
        self.net.load_state_dict(unet_state_dict_from_jax(params),
                                 strict=True)

    def save(self, path: str) -> None:
        """Model-only checkpoint: ``{model_state_dict, config}`` with the
        flax parameter tree, readable by the reference's ``load``."""
        payload = {"model_state_dict": unet_params_to_jax(self.net),
                   "config": self.config}
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "wb") as f:
            pickle.dump(payload, f)

    def load(self, path: str) -> None:
        """Load the weights of a model-only checkpoint into ``net``."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self.load_params(payload["model_state_dict"])

    @classmethod
    def load_with_config(cls, path: str,
                         device: Union[str, torch.device, None] = None
                         ) -> "BaseDiffusionModel":
        """Rebuild the model from the checkpoint's own config, then load
        its weights."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        model = cls(payload["config"], device=device)
        model.load_params(payload["model_state_dict"])
        return model
