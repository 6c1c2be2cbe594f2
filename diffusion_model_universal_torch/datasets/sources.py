"""Raw dataset readers of the port (counterpart of the reference's
``datasets/sources.py``; numpy only, nothing is downloaded).

Readers return uint8 NHWC arrays from the standard on-disk formats, so a
data directory prepared for the reference works unchanged: MNIST's IDX
files (gzipped or not), CIFAR-10's pickle batches, CelebA's ``.npz``
cache or its aligned JPEGs with the official partition file, and the
procedural synthetic set. CelebA's JPEGs are decoded with PIL, which is
imported only there.
"""

from __future__ import annotations

import gzip
import pickle
import struct
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np


class DatasetNotFoundError(FileNotFoundError):
    pass


def _open_maybe_gz(path: Path):
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx_images(path: Path) -> np.ndarray:
    """Parse an IDX3 image file (MNIST's raw format) to [N, H, W] uint8."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX3 magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: Path) -> np.ndarray:
    """Parse an IDX1 label file (MNIST's raw format) to [N] uint8."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX1 magic {magic}")
        return np.frombuffer(f.read(n), np.uint8)


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


def load_mnist(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(train [60000,28,28,1], test [10000,28,28,1]) uint8."""
    root = Path(data_dir)
    train = read_idx_images(_find(root, ["train-images-idx3-ubyte",
                                         "train-images.idx3-ubyte"]))
    test = read_idx_images(_find(root, ["t10k-images-idx3-ubyte",
                                        "t10k-images.idx3-ubyte"]))
    return train[..., None], test[..., None]


def load_mnist_labels(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(train_labels [60000], test_labels [10000]) int64 class ids."""
    root = Path(data_dir)
    train = read_idx_labels(_find(root, ["train-labels-idx1-ubyte",
                                         "train-labels.idx1-ubyte"]))
    test = read_idx_labels(_find(root, ["t10k-labels-idx1-ubyte",
                                        "t10k-labels.idx1-ubyte"]))
    return train.astype(np.int64), test.astype(np.int64)


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


def load_celeba(data_dir: str, image_size: int = 64
                ) -> Tuple[Union[np.ndarray, List[Path]],
                           Optional[np.ndarray]]:
    """CelebA as (images, split ids) or (JPEG paths, split ids).

    A cache ``celeba_{N}.npz`` (``images`` uint8 NHWC, optional
    ``splits`` 0/1/2), as ``scripts/build_celeba_cache.py`` writes it, is
    taken first: the one of exactly ``image_size``, else the smallest
    larger one (the static transforms shrink it), never a smaller one.
    Otherwise the paths of ``img_align_celeba/*.jpg`` in the order of
    ``list_eval_partition.txt``, with its split ids.
    """
    root = Path(data_dir)
    sized = []
    for p in root.glob("celeba_*.npz"):
        try:
            size = int(p.stem.split("_")[-1])
        except ValueError:
            continue
        if size >= image_size:
            sized.append((size != image_size, size, p))
    for _, _, cache in sorted(sized):
        with np.load(cache) as z:
            return z["images"], z.get("splits")
    img_dir = None
    for candidate in (root / "img_align_celeba",
                      root / "celeba" / "img_align_celeba"):
        if candidate.exists():
            img_dir = candidate
            break
    if img_dir is None:
        raise DatasetNotFoundError(
            f"CelebA not found under {root}: provide celeba_{image_size}.npz "
            "or img_align_celeba/ plus list_eval_partition.txt (nothing is "
            "downloaded)")
    names, split_ids = [], []
    with open(_find(root, ["list_eval_partition.txt"])) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 2:
                names.append(parts[0])
                split_ids.append(int(parts[1]))
    return [img_dir / n for n in names], np.asarray(split_ids, np.int32)


def decode_jpegs_crop_resize(paths, crop: int, out_size: int,
                             num_threads: int = 16,
                             chunk: int = 2048,
                             antialias: bool = False) -> np.ndarray:
    """Decode JPEGs to [N, out_size, out_size, 3] uint8, as the
    reference's JPEG ingest: an image of the first image's size is
    center-cropped to min(crop, w, h) and resized by
    :func:`..pipeline.crop_resize_bilinear` (the reference's C++ loader's
    bilinear, its default path), or with ``antialias`` by
    :func:`..pipeline.host_resize` (the reference's path when its loader
    cannot load); an image of another size is cropped and resized by PIL
    with ``BILINEAR``. PIL decodes on a thread pool (libjpeg releases the
    interpreter lock); a chunk of ``chunk`` images is held decoded at a
    time."""
    from concurrent.futures import ThreadPoolExecutor

    try:
        from PIL import Image
    except ImportError as e:
        raise DatasetNotFoundError(
            f"decoding CelebA's JPEGs needs PIL; provide "
            f"celeba_{out_size}.npz instead (scripts/build_celeba_cache.py "
            "writes it where PIL is installed)") from e

    from .pipeline import crop_resize_bilinear, host_center_crop, host_resize

    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    if n == 0:
        return out
    with Image.open(paths[0]) as im0:
        w0, h0 = im0.size
    c0 = min(crop, w0, h0)

    def decode(path):
        with Image.open(path) as img:
            img = img.convert("RGB")
            if img.size == (w0, h0):
                return np.asarray(img, np.uint8), False
            w, h = img.size
            c = min(crop, w, h)
            left, top = (w - c) // 2, (h - c) // 2
            small = img.crop((left, top, left + c, top + c)).resize(
                (out_size, out_size), Image.BILINEAR)
            return np.asarray(small, np.uint8), True

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for start in range(0, n, chunk):
            decoded = list(pool.map(decode, paths[start:start + chunk]))
            same = [i for i, (_, odd) in enumerate(decoded) if not odd]
            for i, (a, odd) in enumerate(decoded):
                if odd:
                    out[start + i] = a
            if same:
                raw = np.stack([decoded[i][0] for i in same])
                out[[start + i for i in same]] = (
                    host_resize(host_center_crop(raw, c0), out_size)
                    if antialias else
                    crop_resize_bilinear(raw, c0, out_size))
    return out
