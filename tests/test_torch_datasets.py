"""The port's MNIST and CelebA readers, resize and augmentation stages
against the JAX package's, on the CPU, on files written here from a
numpy seed (IDX3/IDX1, ``celeba_{N}.npz`` caches, small JPEGs with
``list_eval_partition.txt``).

The stochastic stages are held with JAX's own draws: the test rebuilds
them from ``make_augment_fn``'s key schedule (one ``split`` per stage;
the jitter's five sub-keys) and injects them into the port's stage
functions.
"""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_universal_tpu import native as jnative
from diffusion_model_universal_tpu.datasets import pipeline as jpipe
from diffusion_model_universal_tpu.datasets import registry as jreg
from diffusion_model_universal_tpu.datasets import sources as jsrc
from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.datasets import pipeline as tpipe
from diffusion_model_universal_torch.datasets import registry as treg
from diffusion_model_universal_torch.datasets import sources as tsrc
from diffusion_model_universal_torch.scripts import build_celeba_cache
from diffusion_model_universal_torch.utils.config import (
    default_data_config_path, load_data_config)

torch.set_num_threads(2)


def _write_idx(path, arr, magic=None):
    head = (struct.pack(">IIII", magic or 2051, *arr.shape) if arr.ndim == 3
            else struct.pack(">II", magic or 2049, len(arr)))
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def write_mnist(root, n_train=40, n_test=12, gz=True):
    """MNIST's four IDX files (gzipped, as torchvision keeps them)."""
    rng = np.random.default_rng(7)
    sfx = ".gz" if gz else ""
    root.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("t10k", n_test)):
        _write_idx(root / f"{split}-images-idx3-ubyte{sfx}",
                   rng.integers(0, 256, (n, 28, 28), dtype=np.uint8))
        _write_idx(root / f"{split}-labels-idx1-ubyte{sfx}",
                   rng.integers(0, 10, n, dtype=np.uint8))


def _mnist_block():
    return load_data_config(default_data_config_path(), "mnist")


# -- readers ---------------------------------------------------------------

@pytest.mark.parametrize("gz", [True, False])
def test_idx_readers_match_jax(tmp_path, gz):
    """IDX3/IDX1, gzipped or not: equal arrays; a bad magic raises in
    both."""
    write_mnist(tmp_path, gz=gz)
    for ours, theirs in ((tsrc.load_mnist, jsrc.load_mnist),
                         (tsrc.load_mnist_labels, jsrc.load_mnist_labels)):
        for a, b in zip(ours(str(tmp_path)), theirs(str(tmp_path))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert tsrc.load_mnist(str(tmp_path))[0].shape == (40, 28, 28, 1)
    bad = tmp_path / "bad-idx3"
    _write_idx(bad, np.zeros((1, 2, 2)), magic=2049)
    for reader in (tsrc.read_idx_images, jsrc.read_idx_images):
        with pytest.raises(ValueError, match="magic"):
            reader(bad)


def test_load_celeba_cache_choice(tmp_path):
    """The exact-size cache first, then the smallest larger one, never a
    smaller one, and without a usable cache the JPEG layout; equal to
    JAX's choice every time."""
    for size in (32, 96, 128):
        np.savez(tmp_path / f"celeba_{size}.npz",
                 images=np.full((2, size, size, 3), size, np.uint8))
    np.savez(tmp_path / "celeba_big.npz", images=np.zeros((1, 1, 1, 3)))
    for want, image_size in ((32, 32), (96, 64), (96, 96), (128, 100)):
        a, sa = tsrc.load_celeba(str(tmp_path), image_size)
        b, sb = jsrc.load_celeba(str(tmp_path), image_size)
        assert a.shape[1] == b.shape[1] == want and sa is sb is None
    for loader in (tsrc.load_celeba, jsrc.load_celeba):
        with pytest.raises(FileNotFoundError, match="CelebA not found"):
            loader(str(tmp_path), 256)


def _write_celeba_jpegs(root, n=10):
    """Smooth 178×218 JPEGs (one odd 150×200 image) and the official
    partition file: 6 train, 2 valid, 2 test."""
    from PIL import Image
    img_dir = root / "img_align_celeba"
    img_dir.mkdir(parents=True)
    lines = []
    for i in range(n):
        h, w = (200, 150) if i == 3 else (218, 178)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        arr = np.stack([127 + 100 * np.sin(xx / 9.0 + i),
                        127 + 100 * np.cos(yy / 13.0 - i),
                        127 + 60 * np.sin((xx + yy) / 7.0)], -1)
        Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(
            img_dir / f"{i:06d}.jpg", quality=95)
        lines.append(f"{i:06d}.jpg {0 if i < 6 else (1 if i < 8 else 2)}")
    (root / "list_eval_partition.txt").write_text("\n".join(lines) + "\n")


def test_celeba_jpeg_path_matches_jax(tmp_path, monkeypatch):
    """The JPEG path: the same paths and partition as JAX, and the decoded
    178-crop at 64² within 1 LSB of JAX's jax.image path (its C++ crop
    and resize hidden; that one does not antialias its shrink). The odd
    150×200 image, which JAX crops and shrinks with PIL's BILINEAR, within
    2 LSB. CelebADataset splits by the partition file as JAX's does."""
    pytest.importorskip("PIL")
    _write_celeba_jpegs(tmp_path)
    (paths, ids), (jpaths, jids) = (tsrc.load_celeba(str(tmp_path)),
                                    jsrc.load_celeba(str(tmp_path)))
    assert paths == jpaths
    np.testing.assert_array_equal(ids, jids)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    got = tsrc.decode_jpegs_crop_resize(paths, 178, 64, num_threads=2)
    want = jsrc.decode_jpegs_crop_resize(paths, 178, 64, num_threads=2)
    d = np.abs(got.astype(int) - want.astype(int))
    assert np.delete(d, 3, axis=0).max() <= 1 and d[3].max() <= 2
    kw = dict(data_dir=str(tmp_path), image_size=64, crop_size=178,
              transforms={"train": [], "eval": []})
    ours, theirs = treg.CelebADataset(**kw), jreg.CelebADataset(**kw)
    for k, n in (("train_dataset", 6), ("val_dataset", 2),
                 ("test_dataset", 2)):
        assert getattr(ours, k).shape == getattr(theirs, k).shape == (
            n, 64, 64, 3)
    cache = build_celeba_cache.main([str(tmp_path), "--size", "64",
                                     "--threads", "2"])
    with np.load(cache) as z:
        np.testing.assert_array_equal(z["images"], got)
        np.testing.assert_array_equal(z["splits"], ids)


# -- the resize and the stochastic stages ---------------------------------

@pytest.mark.parametrize("n,size,c,out", [(12, 28, 1, 32), (6, 128, 3, 64)])
def test_host_resize_matches_jax(n, size, c, out):
    """MNIST's 28→32 stretch and CelebA's 128→64 shrink (antialiased in
    both packages), rounded to uint8: within 1 LSB, with at most 0.1% of
    the pixels off by one (measured: none at 28→32, 0.008% at 128→64)."""
    imgs = np.random.default_rng(0).integers(0, 256, (n, size, size, c),
                                             dtype=np.uint8)
    d = np.abs(tpipe.host_resize(imgs, out, chunk=5).astype(int)
               - jpipe.host_resize(imgs, out).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_hsv_both_ways_match_jax():
    """rgb→hsv and hsv→rgb on random colours, greys, primaries and ties
    between channels: 1e-6 abs (measured: equal)."""
    rng = np.random.default_rng(3)
    x = rng.random((300, 3)).astype(np.float32)
    x[:60] = np.round(x[:60] * 2) / 2
    for ours, theirs in ((tpipe.rgb_to_hsv, jpipe._rgb_to_hsv),
                         (tpipe.hsv_to_rgb, jpipe._hsv_to_rgb)):
        np.testing.assert_allclose(ours(torch.from_numpy(x)).numpy(),
                                   np.asarray(theirs(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("interpolation,order", [("nearest", 0),
                                                 ("bilinear", 1)])
def test_rotation_matches_jax(interpolation, order):
    """Six 32² RGB images and one grey one at angles in ±45°, against
    ``_rotate_batch``: bilinear within 1e-5 abs; nearest may differ only
    where a source coordinate rounds at a tie, and no pixel differs here
    (measured: none, 0 of 7·32²)."""
    rng = np.random.default_rng(4)
    for c, b in ((3, 6), (1, 1)):
        x = rng.random((b, 32, 32, c)).astype(np.float32)
        ang = rng.uniform(-45, 45, b).astype(np.float32)
        got = tpipe.rotate_batch(torch.from_numpy(x), torch.from_numpy(ang),
                                 interpolation).numpy()
        want = np.asarray(jpipe._rotate_batch(jnp.asarray(x),
                                              jnp.asarray(ang), order))
        if order:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert int((np.abs(got - want) > 0).any(-1).sum()) == 0


def _jax_augment(transforms, batch, seed):
    """JAX's augmentation of ``batch`` (no normalize: values in [0, 1])."""
    fn = jpipe.make_augment_fn(transforms, [0.5], [0.5], train=True)
    return np.asarray(fn(jnp.asarray(batch), jax.random.PRNGKey(seed)))


def _stage_key(seed):
    """The key of ``make_augment_fn``'s first stage."""
    return jax.random.split(jax.random.PRNGKey(seed))[1]


def test_random_crop_matches_jax():
    """Edge padding 4 and a 32² crop at JAX's offsets
    (randint(key, (b, 2), 0, max_off + 1)): the same pixels, within 1e-7
    (compiled, JAX takes x/255 as x·(1/255): 6e-8 apart on half of
    them)."""
    batch = np.random.default_rng(5).integers(0, 256, (5, 32, 32, 3),
                                              dtype=np.uint8)
    t = [{"name": "random_crop", "size": 32, "padding": 4}]
    offs = np.array(jax.random.randint(_stage_key(1), (5, 2), 0, 9))
    got = tpipe.random_crop_batch(torch.from_numpy(batch).float() / 255.0,
                                  torch.from_numpy(offs), 32, 4)
    np.testing.assert_allclose(got.numpy(), _jax_augment(t, batch, 1),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("jitter,c", [
    ({"brightness": 0.4, "contrast": 0.4, "saturation": 0.4, "hue": 0.1}, 3),
    ({"saturation": 0.5}, 3),
    ({"brightness": 0.3, "contrast": 0.5, "saturation": 0.2, "hue": 0.2}, 1)])
def test_color_jitter_matches_jax(jitter, c):
    """ColorJitter with JAX's factors and per-image stage orders replayed
    from its key schedule: 1e-6 abs (f32 rounding of the luma dot and the
    HSV round trip). On one channel only
    brightness and contrast run."""
    b = 6
    batch = np.random.default_rng(6).integers(0, 256, (b, 16, 16, c),
                                              dtype=np.uint8)
    t = {"name": "color_jitter", **jitter}
    kb, kc, ks, kh, kp = jax.random.split(_stage_key(2), 5)
    factors = np.stack(
        [np.asarray(jax.random.uniform(k, (b,), minval=max(0.0, 1 - v),
                                       maxval=1 + v))
         for k, v in ((kb, jitter.get("brightness", 0.0)),
                      (kc, jitter.get("contrast", 0.0)),
                      (ks, jitter.get("saturation", 0.0)))]
        + [np.asarray(jax.random.uniform(kh, (b,), minval=-jitter.get(
            "hue", 0.0), maxval=jitter.get("hue", 0.0)))], -1)
    stages = tpipe.jitter_stages(t, c)
    perms = None
    if len(stages) > 1:
        perms = torch.from_numpy(np.asarray(jax.vmap(
            lambda k: jax.random.permutation(k, len(stages)))(
                jax.random.split(kp, b))).astype(np.int64))
    got = tpipe.color_jitter_batch(torch.from_numpy(batch).float() / 255.0,
                                   torch.from_numpy(factors), perms, stages)
    np.testing.assert_allclose(got.numpy(), _jax_augment([t], batch, 2),
                               atol=1e-6, rtol=0)
    for make in (tpipe.make_augment_fn, jpipe.make_augment_fn):
        with pytest.raises(ValueError, match="hue"):
            make([{"name": "color_jitter", "hue": 0.6}], [0.5], [0.5], True)


def test_augment_draws_from_the_loader_generator():
    """Every stage in one train-mode list runs on the generator's draws (a
    seed gives the same batch twice, another seed another); eval mode
    drops the train-only stages; unknown names and interpolations
    raise."""
    t = [{"name": "random_rotation", "degrees": [-20, 30],
          "interpolation": "bilinear"},
         {"name": "random_crop", "size": 28, "padding": 2},
         {"name": "color_jitter", "brightness": 0.2, "contrast": 0.2,
          "saturation": 0.2, "hue": 0.05},
         {"name": "random_horizontal_flip"}, {"name": "normalize"}]
    batch = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8))
    aug = tpipe.make_augment_fn(t, [0.5] * 3, [0.5] * 3, train=True)
    a, b, c = (aug(batch, torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert a.shape == (4, 28, 28, 3) and torch.equal(a, b)
    assert not torch.equal(a, c) and a.abs().max() <= 1.0
    ev = tpipe.make_augment_fn(t, [0.5] * 3, [0.5] * 3, train=False)(
        batch, torch.Generator())
    torch.testing.assert_close(ev, batch.float() / 127.5 - 1.0)
    for bad in ({"name": "random_erase"},
                {"name": "random_rotation", "interpolation": "bicubic"}):
        with pytest.raises(ValueError):
            tpipe.make_augment_fn([bad], [0.5], [0.5], train=True)


# -- datasets, splits and labels -----------------------------------------

def test_mnist_splits_and_labels_match_jax(tmp_path):
    """MNIST through the packaged data config (resize 28→32, grey→RGB):
    the seeded 90/10 train/val split (renormalized: test is 0), the
    official test set, labels exact, images within 1 LSB (the resize);
    then ``get_dataset`` on the CPU yields normalized 32² RGB batches with
    labels."""
    write_mnist(tmp_path)
    block = _mnist_block()
    kw = dict(data_dir=str(tmp_path), image_size=32, use_labels=True,
              split_ratios=block["splits"],
              transforms={"train": block["transforms"],
                          "eval": block["transforms"]})
    ours, theirs = treg.MNISTDataset(**kw), jreg.MNISTDataset(**kw)
    for k, n in (("train", 36), ("val", 4), ("test", 12)):
        a, b = getattr(ours, f"{k}_dataset"), getattr(theirs, f"{k}_dataset")
        assert a.shape == b.shape == (n, 32, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        np.testing.assert_array_equal(getattr(ours, f"{k}_labels"),
                                      getattr(theirs, f"{k}_labels"))
    cfg = {"data": {"dataset": "MNIST", "data_dir": str(tmp_path),
                    "use_labels": True},
           "training": {"batch_size": 8}}
    train, val, test = get_dataset(cfg, device="cpu")
    batch = next(iter(train))
    assert batch["image"].shape == (8, 32, 32, 3)
    assert batch["label"].dtype == torch.int64
    assert -1.0 <= float(batch["image"].min()) <= float(
        batch["image"].max()) <= 1.0
    assert len(test) == 2


@pytest.mark.parametrize("with_splits", [True, False])
def test_celeba_cache_splits_match_jax(tmp_path, with_splits):
    """CelebA from a ``celeba_128.npz`` cache at image_size 64 through the
    packaged transforms (the 178 center crop is a no-op, the shrink to
    64 antialiased): split by its ids, or by the seeded 80/10/10 split
    without them; images within 1 LSB of JAX's."""
    rng = np.random.default_rng(9)
    images = rng.integers(0, 256, (20, 128, 128, 3), dtype=np.uint8)
    extra = {"splits": rng.integers(0, 3, 20)} if with_splits else {}
    np.savez(tmp_path / "celeba_128.npz", images=images, **extra)
    block = load_data_config(default_data_config_path(), "celeba")
    kw = dict(data_dir=str(tmp_path), image_size=64,
              split_ratios=block["splits"],
              transforms={"train": block["transforms"],
                          "eval": block["transforms"]})
    ours, theirs = treg.CelebADataset(**kw), jreg.CelebADataset(**kw)
    for k in ("train_dataset", "val_dataset", "test_dataset"):
        a, b = getattr(ours, k), getattr(theirs, k)
        assert a.shape == b.shape and a.shape[1:] == (64, 64, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    if with_splits:
        assert len(ours.train_dataset) == int((extra["splits"] == 0).sum())


def test_dataset_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """``get_dataset``, ``get_dataloaders`` and ``DeviceDataLoader`` run on
    ``cuda`` unless told otherwise, and raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    images = np.zeros((4, 2, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.DeviceDataLoader(images, 2, lambda b, g: b)
    ds = treg.SyntheticDataset(data_dir="unused", image_size=32,
                               num_samples=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.get_dataloaders(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_dataset({"data": {"dataset": "synthetic", "num_samples": 10}})
    assert tpipe.DeviceDataLoader(images, 2, lambda b, g: b,
                                  device="cpu").device.type == "cpu"
