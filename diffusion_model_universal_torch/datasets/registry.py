"""Dataset classes, registry and ``get_dataset`` of the port (counterpart
of the reference's ``datasets/registry.py``).

Every dataset takes ``(data_dir, image_size, transforms, split_ratios,
crop_size)`` and exposes ``train_dataset``/``val_dataset``/``test_dataset``
as uint8 arrays; ``get_dataset`` always returns the (train, val, test)
loader tuple. CIFAR-10 splits its 50k train pool by a seeded permutation
(seed 42) and takes the official 10k batch as test; the synthetic set
splits by the same permutation. MNIST and CelebA are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import NOT_PORTED
from ..utils.config import default_data_config_path, load_data_config
from . import sources
from .pipeline import (TRAIN_ONLY, DeviceDataLoader, PrefetchLoader,
                       apply_static_transforms, make_augment_fn,
                       split_indices)


class ArrayImageDataset:
    """Base: uint8 NHWC split arrays + loader construction."""

    def __init__(self, data_dir: str, image_size: int,
                 transforms: Optional[Dict[str, Sequence]] = None,
                 split_ratios: Optional[Dict[str, float]] = None,
                 crop_size: Optional[int] = None,
                 mean: Sequence[float] = (0.5, 0.5, 0.5),
                 std: Sequence[float] = (0.5, 0.5, 0.5),
                 use_labels: bool = False, **_: Any):
        self.data_dir = data_dir
        self.image_size = image_size
        self.transforms = transforms or {"train": [], "eval": []}
        self.split_ratios = split_ratios or {"train": 0.8, "val": 0.1,
                                             "test": 0.1}
        self.crop_size = crop_size
        self.mean = list(mean)
        self.std = list(std)
        self.use_labels = use_labels
        self._split_labels: Optional[Dict[str, np.ndarray]] = None
        splits = self._build_splits()
        self.train_dataset = splits["train"]
        self.val_dataset = splits["val"]
        self.test_dataset = splits["test"]
        if use_labels and self._split_labels is None:
            raise ValueError(f"{type(self).__name__} has no class labels")
        labels = self._split_labels or {}
        self.train_labels = labels.get("train")
        self.val_labels = labels.get("val")
        self.test_labels = labels.get("test")

    def _build_splits(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _prep(self, images: np.ndarray, train: bool) -> np.ndarray:
        tlist = self.transforms.get("train" if train else "eval", [])
        return apply_static_transforms(images, tlist, self.image_size)

    def get_dataloaders(self, batch_size: int, world_size: int = 1,
                        rank: int = 0, seed: int = 0,
                        eval_batch_size: Optional[int] = None,
                        device: torch.device = torch.device("cpu")
                        ) -> Tuple[DeviceDataLoader, DeviceDataLoader,
                                   DeviceDataLoader]:
        ebs = eval_batch_size or batch_size
        ch = self.train_dataset.shape[-1]
        mean = (self.mean * ch)[:ch] if len(self.mean) < ch else self.mean[:ch]
        std = (self.std * ch)[:ch] if len(self.std) < ch else self.std[:ch]
        aug_train = make_augment_fn(self.transforms.get("train", []),
                                    mean, std, train=True)
        aug_eval = make_augment_fn(self.transforms.get("eval", []),
                                   mean, std, train=False)
        common = dict(world_size=world_size, rank=rank, device=device)
        train = DeviceDataLoader(self.train_dataset, batch_size, aug_train,
                                 shuffle=True, seed=seed,
                                 labels=self.train_labels, **common)
        val = DeviceDataLoader(self.val_dataset, ebs, aug_eval,
                               shuffle=False, drop_last=False,
                               labels=self.val_labels, **common)
        test = DeviceDataLoader(self.test_dataset, ebs, aug_eval,
                                shuffle=False, drop_last=False,
                                labels=self.test_labels, **common)
        return train, val, test


class CIFAR10Dataset(ArrayImageDataset):
    """CIFAR-10: seeded ratio split of the 50k train pool, the official
    10k batch as test."""

    def _build_splits(self) -> Dict[str, np.ndarray]:
        train_raw, test_raw = sources.load_cifar10(self.data_dir)
        train_raw = self._prep(train_raw, True)
        test_raw = self._prep(test_raw, False)
        idx = split_indices(len(train_raw), self.split_ratios, seed=42)
        if self.use_labels:
            tr_l, te_l = sources.load_cifar10_labels(self.data_dir)
            self._split_labels = {"train": tr_l[idx["train"]],
                                  "val": tr_l[idx["val"]], "test": te_l}
        return {"train": train_raw[idx["train"]],
                "val": train_raw[idx["val"]], "test": test_raw}


class SyntheticDataset(ArrayImageDataset):
    """Procedural dataset for tests and smoke runs (no files needed)."""

    num_samples = 2048

    def __init__(self, *args, num_samples: Optional[int] = None, **kwargs):
        if num_samples is not None:
            self.num_samples = num_samples
        super().__init__(*args, **kwargs)

    def _build_splits(self) -> Dict[str, np.ndarray]:
        imgs = sources.make_synthetic(self.num_samples, self.image_size)
        idx = split_indices(len(imgs), self.split_ratios, seed=42)
        if self.use_labels:
            labels = (np.arange(len(imgs)) % 10).astype(np.int64)
            self._split_labels = {k: labels[v] for k, v in idx.items()}
        return {k: imgs[v] for k, v in idx.items()}


DATASET_REGISTRY = {
    "cifar10": CIFAR10Dataset,
    "synthetic": SyntheticDataset,
}

_NOT_PORTED_DATASETS = ("mnist", "celeba")


def get_dataset(config: Dict, world_size: int = 1, rank: int = 0,
                data_config_path: Optional[str] = None,
                device: torch.device = torch.device("cpu")
                ) -> Tuple[Any, Any, Any]:
    """Build (train, val, test) loaders from a full run config, with the
    dataset's block of the shared data config; batches land on
    ``device``."""
    name = config["data"]["dataset"].lower()
    if name in _NOT_PORTED_DATASETS:
        raise NotImplementedError(f"dataset {name} is {NOT_PORTED}")
    cls = DATASET_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"Unknown dataset: {name}; available: "
                         f"{sorted(DATASET_REGISTRY)}")
    block = load_data_config(
        data_config_path or default_data_config_path(), name)
    transforms = {"train": block.get("transforms", []),
                  "eval": [t for t in block.get("transforms", [])
                           if t.get("name") not in TRAIN_ONLY]}
    kwargs: Dict[str, Any] = dict(
        data_dir=config["data"].get("data_dir", block.get("data_dir", "data")),
        image_size=block.get("image_size",
                             config["data"].get("image_size", 32)),
        transforms=transforms, split_ratios=block.get("splits"),
        mean=block.get("mean", [0.5, 0.5, 0.5]),
        std=block.get("std", [0.5, 0.5, 0.5]))
    if "crop_size" in block:
        kwargs["crop_size"] = block["crop_size"]
    if (config["data"].get("use_labels", False)
            or int(config.get("model_config", {}).get("num_classes", 0)) > 0):
        kwargs["use_labels"] = True
    if name == "synthetic":
        kwargs["num_samples"] = config["data"].get(
            "num_samples", block.get("num_samples", 2048))
    dataset = cls(**kwargs)
    loader_cfg = block.get("dataloader", {})
    batch_size = config.get("training", {}).get(
        "batch_size", loader_cfg.get("batch_size", 128))
    train, val, test = dataset.get_dataloaders(
        batch_size, world_size=world_size, rank=rank, device=device)
    if loader_cfg.get("num_workers", config.get("data", {}).get(
            "num_workers", 2)):
        train, val, test = (PrefetchLoader(train), PrefetchLoader(val),
                            PrefetchLoader(test))
    return train, val, test
