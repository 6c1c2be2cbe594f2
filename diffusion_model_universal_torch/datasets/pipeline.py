"""The port's data pipeline (counterpart of the reference's
``datasets/pipeline.py``).

Datasets are host uint8 NHWC arrays, built once; deterministic geometry
runs at load time. Each batch is gathered on the host, moved to the
device as uint8, and augmented there (flips, normalize) with draws from a
``torch.Generator`` on that device. Shuffling is the reference's
``(seed, epoch)`` numpy permutation, so the port visits the same images
in the same order; the flip draws differ (another generator).

Not ported yet: resizing to another size, ``random_rotation``,
``random_crop`` and ``color_jitter`` (they raise).
"""

from __future__ import annotations

import queue
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .. import NOT_PORTED

TRAIN_ONLY = {"random_horizontal_flip", "random_vertical_flip",
               "random_rotation", "color_jitter", "random_crop"}

Augment = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def host_center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """Center-crop uint8 NHWC images."""
    h, w = images.shape[1:3]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return images[:, top:top + size, left:left + size, :]


def host_resize(images: np.ndarray, size: int) -> np.ndarray:
    """Identity when the images already have ``size``; any other size is
    not ported yet."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    raise NotImplementedError(
        f"resizing {images.shape[1]}x{images.shape[2]} images to {size} "
        f"is {NOT_PORTED}")


def apply_static_transforms(images: np.ndarray,
                            transforms: Sequence[Dict[str, Any]],
                            image_size: int) -> np.ndarray:
    """Run the deterministic geometry stages of a YAML transform list."""
    for t in transforms or []:
        name = t.get("name")
        if name == "center_crop":
            images = host_center_crop(images, int(t.get("size", image_size)))
        elif name == "resize":
            images = host_resize(images, int(t.get("size", image_size)))
        elif name == "grayscale_to_rgb" and images.shape[-1] == 1:
            images = np.repeat(images, 3, axis=-1)
        elif name == "grayscale" and images.shape[-1] == 3:
            gray = (0.299 * images[..., 0] + 0.587 * images[..., 1]
                    + 0.114 * images[..., 2])
            images = gray[..., None].astype(np.uint8)
    return host_resize(images, image_size)


def make_augment_fn(transforms: Sequence[Dict[str, Any]],
                    mean: Sequence[float], std: Sequence[float],
                    train: bool) -> Augment:
    """The YAML transform list as ``augment(batch_uint8, generator) ->
    f32 NHWC`` on the batch's device. Train-only transforms are dropped in
    eval mode, as in the reference."""
    steps: List[Tuple[str, float]] = []
    has_normalize = False
    for t in transforms or []:
        name = t.get("name")
        if name in ("center_crop", "resize", "to_tensor", "grayscale",
                    "grayscale_to_rgb"):
            continue
        if name == "normalize":
            has_normalize = True
            continue
        if name in TRAIN_ONLY and not train:
            continue
        if name not in ("random_horizontal_flip", "random_vertical_flip"):
            raise NotImplementedError(f"transform {name!r} is {NOT_PORTED}")
        steps.append((name, float(t.get("p", 0.5))))

    def augment(batch: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        x = batch.float() / 255.0
        b = x.shape[0]
        for name, p in steps:
            flip = torch.rand((b, 1, 1, 1), generator=generator,
                              device=x.device) < p
            dim = 2 if name == "random_horizontal_flip" else 1
            x = torch.where(flip, x.flip(dim), x)
        if has_normalize:
            m = torch.tensor(mean, dtype=torch.float32, device=x.device)
            s = torch.tensor(std, dtype=torch.float32, device=x.device)
            x = (x - m) / s
        return x

    return augment


class DeviceDataLoader:
    """Epoch-shuffled, host-sharded, device-augmented batch iterator.

    Per-host contiguous shard of the index space (``world_size``/``rank``),
    a per-epoch permutation seeded by (seed, epoch), a uint8 gather on the
    host (numpy indexing), and the augmentation on ``device``. Batches are
    f32 NHWC tensors, or ``{"image", "label"}`` dicts with labels.
    """

    def __init__(self, images: np.ndarray, batch_size: int,
                 augment: Augment, shuffle: bool = True, seed: int = 0,
                 world_size: int = 1, rank: int = 0,
                 drop_last: bool = True,
                 labels: Optional[np.ndarray] = None,
                 device: torch.device = torch.device("cpu")):
        if images.dtype != np.uint8:
            raise ValueError("loader expects uint8 host arrays")
        if labels is not None and len(labels) != len(images):
            raise ValueError(
                f"{len(labels)} labels for {len(images)} images")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.augment = augment
        self.shuffle = shuffle
        self.seed = seed
        self.world_size = world_size
        self.rank = rank
        self.drop_last = drop_last
        self.device = torch.device(device)
        self.epoch = 0
        n = len(images)
        self.shard_size = n // world_size if world_size > 1 else n
        if drop_last:
            self.num_batches = self.shard_size // batch_size
        else:
            self.num_batches = -(-self.shard_size // batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_batches

    def batch_indices(self) -> List[np.ndarray]:
        """The image indices of each batch of the current epoch."""
        n = len(self.images)
        if self.shuffle:
            order = np.random.default_rng((self.seed, self.epoch)
                                          ).permutation(n)
        else:
            order = np.arange(n)
        if self.world_size > 1:
            order = order[self.rank * self.shard_size:
                          (self.rank + 1) * self.shard_size]
        out = []
        for i in range(self.num_batches):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            out.append(idx)
        return out

    def __iter__(self) -> Iterator[Any]:
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + self.epoch) & 0x7FFFFFFF)
        for idx in self.batch_indices():
            batch = torch.from_numpy(self.images[idx]).to(self.device)
            out = self.augment(batch, gen)
            if self.labels is not None:
                yield {"image": out, "label": torch.from_numpy(
                    self.labels[idx]).to(self.device)}
            else:
                yield out
        self.epoch += 1


class PrefetchLoader:
    """Runs the wrapped loader ``depth`` batches ahead on a thread (the
    reference's ``num_workers`` analogue): the host gather and the copy to
    the device overlap the training step."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        done = object()
        stop = threading.Event()
        error: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except Exception as e:  # handed to the consumer
                error.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)


def split_indices(n: int, ratios: Dict[str, float],
                  seed: int = 42) -> Dict[str, np.ndarray]:
    """Split [0, n) into train/val/test with a seeded permutation."""
    total = sum(ratios.values())
    if abs(total - 1.0) > 1e-6:
        raise ValueError(f"split ratios must sum to 1, got {total}")
    order = np.random.default_rng(seed).permutation(n)
    n_train = int(n * ratios.get("train", 0.8))
    n_val = int(n * ratios.get("val", 0.1))
    return {"train": order[:n_train],
            "val": order[n_train:n_train + n_val],
            "test": order[n_train + n_val:]}
