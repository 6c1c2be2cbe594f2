"""The port's data pipeline (counterpart of the reference's
``datasets/pipeline.py``).

Datasets are host uint8 NHWC arrays, built once; deterministic geometry
(center crop, the bilinear resize, grayscale) runs at load time on the
host. Each batch is gathered on the host, moved to the device as uint8,
and augmented there (flips, rotation, crop, colour jitter, normalize)
with draws from a ``torch.Generator`` on that device. Shuffling is the
reference's ``(seed, epoch)`` numpy permutation, so the port visits the
same images in the same order; the augmentation draws differ (another
generator). Each stochastic stage is a function of the batch and its
draws (:func:`rotate_batch`, :func:`random_crop_batch`,
:func:`color_jitter_batch`), so the draws can be injected.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import resolve_device
from ..utils.inception import resize_bilinear

TRAIN_ONLY = {"random_horizontal_flip", "random_vertical_flip",
               "random_rotation", "color_jitter", "random_crop"}
_STATIC = {"center_crop", "resize", "to_tensor", "grayscale",
           "grayscale_to_rgb"}

#: ``augment(batch_uint8, generator, rows=None)``; ``rows`` (lo, hi, n):
#: the batch is those rows of a global batch of n, whose draws are made.
Augment = Callable[..., torch.Tensor]


def host_center_crop(images: np.ndarray, size: int) -> np.ndarray:
    """Center-crop uint8 NHWC images."""
    h, w = images.shape[1:3]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return images[:, top:top + size, left:left + size, :]


def host_resize(images: np.ndarray, size: int,
                chunk: int = 4096) -> np.ndarray:
    """Bilinear resize of uint8 NHWC images to ``size``² by
    :func:`..utils.inception.resize_bilinear` (``jax.image.resize``'s
    weights: a shrink widens the triangle kernel by the scale, a stretch
    is plain bilinear with half-pixel centers), rounded half to even and
    clipped to uint8, on the host in chunks of ``chunk`` images (the f32
    copy of a whole CelebA split would not fit)."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    n, _, _, c = images.shape
    out = np.empty((n, size, size, c), np.uint8)
    for start in range(0, n, chunk):
        x = torch.from_numpy(images[start:start + chunk].astype(np.float32))
        r = resize_bilinear(x.permute(0, 3, 1, 2), size)
        out[start:start + chunk] = r.round().clamp(0, 255).to(
            torch.uint8).permute(0, 2, 3, 1).numpy()
    return out


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


# -- the stochastic stages, each a function of the batch and its draws -----

def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB in [0, 1] to HSV with hue in [0, 1) (torchvision's
    ``_rgb2hsv``, which ColorJitter's hue stage uses)."""
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(-1)
    minc = rgb.amin(-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-12),
                    torch.zeros_like(maxc))
    safe = torch.where(delta > 0, delta, torch.ones_like(delta))
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h))
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`rgb_to_hsv` ([..., 3], hue in [0, 1))."""
    h, s, v = hsv.unbind(-1)
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    sector = torch.remainder(i.to(torch.int32), 6).long().unsqueeze(0)
    pick = [torch.stack(c).gather(0, sector)[0]
            for c in ((v, q, p, p, t, v), (t, v, v, q, p, p),
                      (p, p, t, v, v, q))]
    return torch.stack(pick, dim=-1)


def rotate_batch(x: torch.Tensor, degrees: torch.Tensor,
                 interpolation: str = "nearest") -> torch.Tensor:
    """Rotate each NHWC image by its own angle (degrees, counter-clockwise
    as viewed) about ((h−1)/2, (w−1)/2), same size, zeros outside: the
    inverse map of each output pixel, sampled by ``grid_sample`` at pixel
    coordinates (``align_corners=True``), each tap outside the image
    reading zero (``padding_mode="zeros"``), nearest (torchvision's
    default) or bilinear."""
    _, h, w, _ = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device),
        indexing="ij")
    rad = degrees.float() * (math.pi / 180.0)
    cos, sin = rad.cos()[:, None, None], rad.sin()[:, None, None]
    ys = cos * (yy - cy) + sin * (xx - cx) + cy
    xs = -sin * (yy - cy) + cos * (xx - cx) + cx
    grid = torch.stack([xs * (2.0 / max(w - 1, 1)) - 1.0,
                        ys * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode=interpolation,
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def random_crop_batch(x: torch.Tensor, offsets: torch.Tensor, size: int,
                      padding: int = 0) -> torch.Tensor:
    """Pad NHWC images by ``padding`` with their edge pixels, then crop
    image b to ``size``² at (row, column) ``offsets[b]``."""
    if padding:
        x = F.pad(x.permute(0, 3, 1, 2), (padding,) * 4,
                  mode="replicate").permute(0, 2, 3, 1)
    r = torch.arange(size, device=x.device)
    rows = offsets[:, 0, None] + r
    cols = offsets[:, 1, None] + r
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, rows[:, :, None], cols[:, None, :]]


#: torchvision's rgb_to_grayscale weights, of its contrast and saturation.
LUMA = (0.2989, 0.587, 0.114)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return (x * torch.tensor(LUMA, device=x.device)).sum(-1)


def _per_image(f: torch.Tensor) -> torch.Tensor:
    return f[:, None, None, None]


def _brightness(x, f):
    return (x * _per_image(f[:, 0])).clamp(0.0, 1.0)


def _contrast(x, f):
    gray = _gray(x) if x.shape[-1] == 3 else x[..., 0]
    m = _per_image(gray.mean(dim=(1, 2)))
    return ((x - m) * _per_image(f[:, 1]) + m).clamp(0.0, 1.0)


def _saturation(x, f):
    gray = _gray(x)[..., None]
    return ((x - gray) * _per_image(f[:, 2]) + gray).clamp(0.0, 1.0)


def _hue(x, f):
    hsv = rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + f[:, 3, None, None], 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]],
                                  -1)).clamp(0.0, 1.0)


JITTER_STAGES = {"brightness": _brightness, "contrast": _contrast,
                 "saturation": _saturation, "hue": _hue}


def jitter_stages(t: Dict[str, Any], channels: int) -> List[str]:
    """The enabled stages of a ``color_jitter`` entry, in
    ``JITTER_STAGES`` order (saturation and hue only on RGB)."""
    return [name for name in JITTER_STAGES
            if float(t.get(name, 0.0))
            and (channels == 3 or name in ("brightness", "contrast"))]


def color_jitter_batch(x: torch.Tensor, factors: torch.Tensor,
                       perms: Optional[torch.Tensor],
                       stages: Sequence[str]) -> torch.Tensor:
    """torchvision ColorJitter on NHWC images in [0, 1], each stage
    clamped to [0, 1]. ``factors`` [B, 4]: each image's brightness,
    contrast and saturation factors and its hue shift; ``perms`` [B, n]
    (n ≥ 2 enabled ``stages``): image b runs ``stages[perms[b, i]]`` i-th,
    so each image has its own stage order."""
    fns = [JITTER_STAGES[s] for s in stages]
    if len(fns) == 1:
        return fns[0](x, factors)
    for i in range(len(fns)):
        out = x
        for s, fn in enumerate(fns):
            out = torch.where(_per_image(perms[:, i] == s), fn(x, factors),
                              out)
        x = out
    return x


def _rotation_range(t: Dict[str, Any]) -> Tuple[float, float]:
    deg = t.get("degrees", 10)
    if isinstance(deg, (list, tuple)):
        return float(deg[0]), float(deg[1])
    return -float(deg), float(deg)


def make_augment_fn(transforms: Sequence[Dict[str, Any]],
                    mean: Sequence[float], std: Sequence[float],
                    train: bool) -> Augment:
    """The YAML transform list as ``augment(batch_uint8, generator,
    rows=None) -> f32 NHWC`` on the batch's device. Train-only transforms
    are dropped in eval mode, as in the reference. With ``rows`` (lo, hi,
    n) the batch is rows [lo, hi) of a global batch of n: every draw is
    made for the n rows and the batch keeps its own, so the rows equal
    those of the global batch's augmentation. Rotation angles are U[-degrees,
    degrees] (or U[lo, hi] for a pair), crop offsets uniform in [0,
    max_off], jitter factors U[max(0, 1−v), 1+v] and the hue shift
    U[−hue, hue], hue in [0, 0.5]."""
    steps: List[Tuple[str, Dict[str, Any]]] = []
    has_normalize = False
    for t in transforms or []:
        name = t.get("name")
        if name in _STATIC:
            continue
        if name == "normalize":
            has_normalize = True
            continue
        if name not in TRAIN_ONLY:
            raise ValueError(f"unknown transform {name!r}")
        if not train:
            continue
        if name == "color_jitter":
            hue = float(t.get("hue", 0.0))
            if not 0.0 <= hue <= 0.5:
                raise ValueError(
                    f"color_jitter hue must be in [0, 0.5], got {hue}")
        if name == "random_rotation":
            _rotation_range(t)
            if str(t.get("interpolation", "nearest")).lower() not in (
                    "nearest", "bilinear"):
                raise ValueError(f"random_rotation interpolation "
                                 f"{t['interpolation']!r}")
        steps.append((name, t))

    def augment(batch: torch.Tensor, generator: torch.Generator,
                rows=None) -> torch.Tensor:
        x = batch.float() / 255.0
        lo, hi, n = rows or (0, x.shape[0], x.shape[0])

        def uniform(lo_, hi_, *shape):
            u = torch.rand((n, *shape), generator=generator,
                           device=x.device)[lo:hi]
            return u * (hi_ - lo_) + lo_

        for name, t in steps:
            if name in ("random_horizontal_flip", "random_vertical_flip"):
                flip = uniform(0.0, 1.0, 1, 1, 1) < float(t.get("p", 0.5))
                dim = 2 if name == "random_horizontal_flip" else 1
                x = torch.where(flip, x.flip(dim), x)
            elif name == "random_rotation":
                x = rotate_batch(x, uniform(*_rotation_range(t)),
                                 str(t.get("interpolation",
                                           "nearest")).lower())
            elif name == "random_crop":
                size = int(t.get("size", x.shape[1]))
                pad = int(t.get("padding", 0))
                max_off = x.shape[1] + 2 * pad - size
                if max_off < 0:
                    raise ValueError(f"random_crop size {size} exceeds the "
                                     f"padded image {x.shape[1] + 2 * pad}")
                offs = torch.randint(0, max_off + 1, (n, 2),
                                     generator=generator,
                                     device=x.device)[lo:hi]
                x = random_crop_batch(x, offs, size, pad)
            else:   # color_jitter
                stages = jitter_stages(t, x.shape[-1])
                if not stages:
                    continue
                ranges = [(max(0.0, 1 - float(t.get(k, 0.0))),
                           1 + float(t.get(k, 0.0)))
                          for k in ("brightness", "contrast", "saturation")]
                hue = float(t.get("hue", 0.0))
                factors = torch.stack([uniform(*r) for r in ranges]
                                      + [uniform(-hue, hue)], dim=-1)
                perms = (torch.argsort(uniform(0.0, 1.0, len(stages)),
                                       dim=1) if len(stages) > 1 else None)
                x = color_jitter_batch(x, factors, perms, stages)
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
    host (numpy indexing), and the augmentation on ``device`` (``cuda``
    unless the caller names another; raises without CUDA). Batches are
    f32 NHWC tensors, or ``{"image", "label"}`` dicts with labels.

    ``split`` (r, N), for one process's N ranks (``train --num_devices
    N``): each batch of the unsharded loader is cut into N row blocks,
    rows [r·n//N, (r+1)·n//N) of a batch of n, and the loader gathers and
    augments block r only, with the draws of the whole batch. It yields
    ``{"image", "rows": (lo, hi, n)}`` dicts (and ``"label"``), every
    batch, an empty block too, so the N ranks' blocks stacked in rank
    order are the unsharded loader's batch.
    """

    def __init__(self, images: np.ndarray, batch_size: int,
                 augment: Augment, shuffle: bool = True, seed: int = 0,
                 world_size: int = 1, rank: int = 0,
                 drop_last: bool = True,
                 labels: Optional[np.ndarray] = None,
                 device=None, split: Optional[Tuple[int, int]] = None):
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
        self.device = resolve_device(device)
        if split is not None and world_size > 1:
            raise ValueError("a loader takes a host shard (world_size) or "
                             "a row split, not both")
        self.split = split
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
            if self.split is None:
                batch = torch.from_numpy(self.images[idx]).to(self.device)
                out = self.augment(batch, gen)
                if self.labels is not None:
                    yield {"image": out, "label": torch.from_numpy(
                        self.labels[idx]).to(self.device)}
                else:
                    yield out
                continue
            r, parts = self.split
            n = len(idx)
            rows = (r * n // parts, (r + 1) * n // parts, n)
            idx = idx[rows[0]:rows[1]]
            batch = torch.from_numpy(self.images[idx]).to(self.device)
            out = {"image": self.augment(batch, gen, rows), "rows": rows}
            if self.labels is not None:
                out["label"] = torch.from_numpy(self.labels[idx]).to(
                    self.device)
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

        device = getattr(self.loader, "device", None)

        def worker():
            try:
                if device is not None and device.type == "cuda" \
                        and device.index is not None:
                    torch.cuda.set_device(device)
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
