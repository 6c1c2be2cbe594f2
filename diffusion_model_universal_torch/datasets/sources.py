"""Raw dataset readers of the port (counterpart of the reference's
``datasets/sources.py``; numpy only, nothing is downloaded).

Readers return uint8 NHWC arrays from the standard on-disk formats, so a
data directory prepared for the reference works unchanged. CIFAR-10 and
the procedural synthetic set are ported; MNIST and CelebA are not yet.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Tuple

import numpy as np


class DatasetNotFoundError(FileNotFoundError):
    pass


def _find(data_dir: Path, names) -> Path:
    for name in names:
        for candidate in (data_dir / name, data_dir / (name + ".gz")):
            if candidate.exists():
                return candidate
        hits = list(data_dir.rglob(name)) + list(data_dir.rglob(name + ".gz"))
        if hits:
            return hits[0]
    raise DatasetNotFoundError(
        f"none of {names} found under {data_dir} — place the standard "
        "torchvision-format files there (nothing is downloaded)")


def _read_pickle(path: Path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_cifar10(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(train [50000,32,32,3], test [10000,32,32,3]) uint8 from the
    python-pickle batch files (cifar-10-batches-py)."""
    root = Path(data_dir)

    def read_batch(path: Path) -> np.ndarray:
        d = _read_pickle(path)
        raw = d[b"data"] if b"data" in d else d["data"]
        return np.asarray(raw, np.uint8).reshape(-1, 3, 32, 32).transpose(
            0, 2, 3, 1)

    train = np.concatenate([read_batch(_find(root, [f"data_batch_{i}"]))
                            for i in range(1, 6)])
    return train, read_batch(_find(root, ["test_batch"]))


def load_cifar10_labels(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(train_labels [50000], test_labels [10000]) int64 class ids."""
    root = Path(data_dir)

    def read_labels(path: Path) -> np.ndarray:
        d = _read_pickle(path)
        return np.asarray(d.get(b"labels", d.get("labels")), np.int64)

    train = np.concatenate([read_labels(_find(root, [f"data_batch_{i}"]))
                            for i in range(1, 6)])
    return train, read_labels(_find(root, ["test_batch"]))


def make_synthetic(num_samples: int = 2048, image_size: int = 32,
                   channels: int = 3, seed: int = 42) -> np.ndarray:
    """Procedural dataset: smooth random Gaussian blobs + gradients, fully
    deterministic for a given seed (the reference's draws, in its order)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    yy /= image_size
    xx /= image_size
    imgs = np.zeros((num_samples, image_size, image_size, channels),
                    np.float32)
    for c in range(channels):
        cx = rng.uniform(0.2, 0.8, (num_samples, 1, 1))
        cy = rng.uniform(0.2, 0.8, (num_samples, 1, 1))
        s = rng.uniform(0.05, 0.25, (num_samples, 1, 1))
        amp = rng.uniform(0.4, 1.0, (num_samples, 1, 1))
        blob = amp * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * s ** 2)))
        grad = rng.uniform(-0.3, 0.3, (num_samples, 1, 1)) * (xx - 0.5)
        imgs[..., c] = np.clip(blob + grad + 0.3, 0.0, 1.0)
    return (imgs * 255).astype(np.uint8)
