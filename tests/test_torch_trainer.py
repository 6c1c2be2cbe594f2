"""The port's data pipeline, evaluation weighting and training CLI, on the
CPU, at a small size (C=32, 32², T=4, B=4).

The data pipeline is held against the JAX package's (the synthetic set,
the split, the batch order, normalization, the CIFAR-10 reader on a file
written here in the pickle-batch format). The CLI trains, checkpoints,
resumes and generates from the EMA weights end to end.
"""

import hashlib
import json
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import noop_context_fn
import yaml

from diffusion_model_universal_tpu.datasets import pipeline as jpipe
from diffusion_model_universal_tpu.datasets import registry as jreg
from diffusion_model_universal_tpu.datasets import sources as jsrc
from diffusion_model_universal_tpu.utils.losses import \
    DiffusionLoss as JaxLoss
from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.datasets import pipeline as tpipe
from diffusion_model_universal_torch.datasets import registry as treg
from diffusion_model_universal_torch.datasets import sources as tsrc
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.utils.checkpoint import (
    CheckpointManager, read_state)
from diffusion_model_universal_torch.utils.config import (
    default_data_config_path, load_data_config)
from diffusion_model_universal_torch.utils.images import decode_png
from diffusion_model_universal_torch.utils.losses import DiffusionLoss

torch.set_num_threads(2)

_SPLIT = {"train": 0.8, "val": 0.1, "test": 0.1}


# -- data -----------------------------------------------------------------

def test_packaged_data_config_equals_jax_copy():
    """The port ships its own copy of data_config.yaml; it must stay equal
    to the JAX package's."""
    from diffusion_model_universal_tpu.utils.config import \
        default_data_config_path as jax_path
    with open(default_data_config_path()) as f, open(jax_path()) as g:
        assert yaml.safe_load(f) == yaml.safe_load(g)
    assert load_data_config(default_data_config_path(),
                            "synthetic")["num_samples"] == 2048


@pytest.mark.parametrize("n,ratios", [(50, _SPLIT),
                                      (37, {"train": 0.5, "val": 0.25,
                                            "test": 0.25})])
def test_synthetic_and_split_match_jax(n, ratios):
    np.testing.assert_array_equal(tsrc.make_synthetic(n, 32),
                                  jsrc.make_synthetic(n, 32))
    ours, theirs = (tpipe.split_indices(n, ratios),
                    jpipe.split_indices(n, ratios))
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_synthetic_dataset_splits_match_jax():
    kw = dict(data_dir="unused", image_size=32, split_ratios=_SPLIT,
              transforms={"train": [], "eval": []}, num_samples=60)
    a, b = treg.SyntheticDataset(**kw), jreg.SyntheticDataset(**kw)
    for k in ("train_dataset", "val_dataset", "test_dataset"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_batch_order_matches_jax(shuffle, drop_last):
    """The (seed, epoch) permutation visits the same images in the same
    batches, over two epochs and with a host shard."""
    images = np.repeat(np.arange(23, dtype=np.uint8)[:, None, None, None],
                       2, axis=1).repeat(2, axis=2)
    for world, rank in ((1, 0), (2, 1)):
        ours = tpipe.DeviceDataLoader(images, 4, lambda b, g: b,
                                      shuffle=shuffle, seed=3,
                                      world_size=world, rank=rank,
                                      drop_last=drop_last, device="cpu")
        theirs = jpipe.DeviceDataLoader(images, 4, lambda b, k: b,
                                        shuffle=shuffle, seed=3,
                                        world_size=world, rank=rank,
                                        drop_last=drop_last)
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = [b[:, 0, 0, 0].numpy() for b in ours]
            want = [np.asarray(b)[:, 0, 0, 0] for b in theirs]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_normalize_and_flips_match_jax_semantics():
    """Eval-mode normalization equals JAX's exactly; a flip is a flip of
    the whole image, drawn per image. ``random_rotation``, once refused
    here, runs (``tests/test_torch_datasets.py`` holds it against
    JAX)."""
    transforms = [{"name": "random_horizontal_flip", "p": 0.5},
                  {"name": "normalize"}]
    mean, std = [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, (6, 4, 4, 3), dtype=np.uint8)
    got = tpipe.make_augment_fn(transforms, mean, std, train=False)(
        torch.from_numpy(batch), torch.Generator())
    want = jpipe.make_augment_fn(transforms, mean, std, train=False)(
        jnp.asarray(batch), jax.random.PRNGKey(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    flipped = tpipe.make_augment_fn(transforms, mean, std, train=True)(
        torch.from_numpy(batch), torch.Generator().manual_seed(1))
    for img, out in zip(got, flipped):
        assert torch.equal(out, img) or torch.equal(out, img.flip(1))
    rotated = tpipe.make_augment_fn(
        [{"name": "random_rotation", "degrees": [80, 100]}], mean, std,
        train=True)(torch.from_numpy(batch), torch.Generator())
    assert rotated.shape == batch.shape
    assert not torch.equal(rotated, torch.from_numpy(batch) / 255.0)


def _write_cifar(root, n=6):
    """CIFAR-10's python pickle batches (bytes keys, CHW rows of uint8)."""
    rng = np.random.default_rng(5)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)


def test_cifar10_reader_matches_jax(tmp_path):
    _write_cifar(tmp_path)
    (tr, te), (jtr, jte) = (tsrc.load_cifar10(str(tmp_path)),
                            jsrc.load_cifar10(str(tmp_path)))
    assert tr.shape == (30, 32, 32, 3) and te.shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(tr, jtr)
    np.testing.assert_array_equal(te, jte)
    for a, b in zip(tsrc.load_cifar10_labels(str(tmp_path)),
                    jsrc.load_cifar10_labels(str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    kw = dict(data_dir=str(tmp_path), image_size=32, split_ratios=_SPLIT,
              transforms={"train": [], "eval": []})
    a, b = treg.CIFAR10Dataset(**kw), jreg.CIFAR10Dataset(**kw)
    for k in ("train_dataset", "val_dataset", "test_dataset"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# -- evaluation -------------------------------------------------------------

def test_eval_weights_each_sample_as_a_batch_of_one():
    """The reference's eval vmaps a batch-1 loss: over one sample the SNR
    weight's affine rescale gives every sample min_weight. The port's
    per-sample losses equal JAX's batch-1 losses (rtol 1e-6) and that
    weighting."""
    cfg = {"time_weight_params": {"min_weight": 0.1, "max_weight": 1.0}}
    ac = np.cumprod(1 - np.linspace(1e-4, 2e-2, 50)).astype(np.float32)
    rng = np.random.default_rng(1)
    pred, target = (rng.normal(size=(3, 4, 4, 3)).astype(np.float32)
                    for _ in range(2))
    t = np.array([1, 20, 49])
    got = DiffusionLoss("mse", cfg, 50, torch.from_numpy(ac)).per_sample(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(t))
    jl = JaxLoss("mse", cfg, 50, jnp.asarray(ac))
    want = [float(jl(jnp.asarray(pred[i:i + 1]), jnp.asarray(target[i:i + 1]),
                     jnp.asarray(t[i:i + 1]))) for i in range(3)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), 0.1 * ((pred - target) ** 2).mean(axis=(1, 2, 3)),
        rtol=1e-5)


# -- the training CLI ---------------------------------------------------------

def _config(tmp_path, num_epochs):
    return {
        "model_name": "DDPM",
        "model_config": {"num_timesteps": 4, "image_size": 32,
                         "in_channels": 3, "model_channels": 32,
                         "compute_dtype": "float32", "dropout": 0.1},
        "training": {"num_epochs": num_epochs, "batch_size": 4,
                     "learning_rate": 1e-3, "ema_decay": 0.99,
                     "scheduler": {"type": "cosine", "min_lr": 1e-6},
                     "val_interval": 4, "sample_interval": 2,
                     "checkpoint_interval": 1},
        "data": {"dataset": "synthetic", "data_dir": "unused",
                 "num_samples": 20},
        "logging": {"log_interval": 1, "gradient_logging_freq": 2,
                    "track_per_layer_metrics": True,
                    "track_time_metrics": True},
        "output": {"output_dir": str(tmp_path / "run")},
    }


def _write(tmp_path, cfg):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_resume_generate_cli_on_cpu(tmp_path, capsys):
    """Train 2 epochs (4 steps each), checkpoint every epoch, validate and
    save best_model, a sample grid at epoch 1; resume from the latest
    checkpoint for a third epoch with the parameters bit-equal to the
    saved ones; generate from the final checkpoint's EMA weights."""
    base = ["--model_type", "ddpm", "--device", "cpu", "--seed", "0"]
    assert train_cli.main(["--config", _write(tmp_path,
                                              _config(tmp_path, 2))]
                          + base) == 0
    ck = tmp_path / "run" / "checkpoints"
    assert sorted(p.name for p in ck.iterdir()) == [
        "best_model", "checkpoint_epoch_0", "checkpoint_epoch_1",
        "config.json", "final_model"]
    grid = decode_png((tmp_path / "run" / "samples" / "epoch_1.png")
                      .read_bytes())
    assert grid.shape == (4 * 34 + 2, 2 * 34 + 2, 3)  # 4 samples × x_T, x_0
    saved = read_state(str(ck / "checkpoint_epoch_1"))
    assert (saved["step"], saved["epoch"]) == (8, 1)
    digest = hashlib.sha256()
    for p in saved["params"].values():
        digest.update(p.contiguous().numpy().tobytes())
    capsys.readouterr()

    cfg_path = _write(tmp_path, _config(tmp_path, 3))
    assert train_cli.main(["--config", cfg_path, "--resume", "latest"]
                          + base) == 0
    out = capsys.readouterr().out
    assert (f"Resumed from epoch 2 at step 8 (params sha256 "
            f"{digest.hexdigest()})") in out
    final = read_state(str(ck / "final_model"))
    assert final["step"] == 12 and final["opt_state"]["count"] == 12
    losses = [v for line in (tmp_path / "run" / "metrics.jsonl")
              .read_text().splitlines()
              for k, v in yaml.safe_load(line).items() if k == "train/loss"]
    assert len(losses) == 12 and np.isfinite(losses).all()

    model = DDPM(_config(tmp_path, 3)["model_config"], device="cpu")
    gen_cli.load_params(model, str(ck / "final_model"), use_ema=True)
    for n, p in model.net.state_dict().items():
        assert torch.equal(p, final["ema_params"][n])
    assert gen_cli.main(["--config", cfg_path, "--model_type", "ddpm",
                         "--checkpoint", str(ck / "final_model"), "--ema",
                         "--device", "cpu", "--num_samples", "2",
                         "--output_dir", str(tmp_path / "gen")]) == 0
    assert decode_png((tmp_path / "gen" / "samples_grid.png")
                      .read_bytes()).shape == (34 + 2, 2 * 34 + 2, 3)


def test_checkpoint_names_latest_and_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), config={"a": 1})
    for name in ("checkpoint_epoch_2", "checkpoint_epoch_10", "best_model",
                 "emergency_checkpoint_epoch_3", "checkpoint_epoch_7"):
        mgr.save(name, {"step": 1})
    assert mgr.latest_epoch_checkpoint() == "checkpoint_epoch_10"
    assert mgr.prune_epoch_checkpoints(2) == ["checkpoint_epoch_2"]
    assert mgr.exists("best_model") and mgr.exists(
        "emergency_checkpoint_epoch_3")
    assert mgr.load_config() == {"a": 1}
    orbax_like = tmp_path / "orbax" / "checkpoint_epoch_0"
    orbax_like.mkdir(parents=True)
    (orbax_like / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        read_state(str(orbax_like))


# -- what is not ported, and the device default ---------------------------------

@pytest.mark.parametrize("extra,fragment", [
    (["--profile", "trace_dir", "--profile_steps", "2"], "--profile"),
    (["--profile", "--profile_steps", "2"], "--profile"),
    (["--multihost"], "--multihost"), (["--num_devices", "2"],
                                       "--num_devices"),
    (["--num_gpus", "3"], "--num_devices > 1 is not yet ported")])
def test_train_cli_refuses_unported_flags(tmp_path, extra, fragment, capsys,
                                          monkeypatch):
    """The name is from when all these flags were refused. ``--multihost``
    without the environment torchrun sets exits with a message naming
    it. ``--num_devices 2`` trains two gloo ranks on the CPU end to end,
    rank 0 writing the checkpoints. ``--num_gpus 3`` (the reference's
    spelling) is no longer refused as not ported (the ``fragment``); the
    batch of 4, which 3 ranks cannot split, is
    (``tests/test_torch_parallel.py`` holds the ranks against one process
    and JAX). ``--profile``, once
    refused here, runs: one warm-up update and ``--profile_steps`` traced
    ones on the CPU, then the epoch; a ``*.pt.trace.json`` Chrome trace of
    the host ops lands in DIR (default ``output_dir/profile``)."""
    args = ["--config", _write(tmp_path, _config(tmp_path, 1)),
            "--model_type", "ddpm", "--device", "cpu"]
    if extra[0] == "--multihost":
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            monkeypatch.delenv(key, raising=False)
        with pytest.raises(SystemExit, match="--multihost .*torchrun"):
            train_cli.main(args + extra)
        return
    if extra[0] == "--num_gpus":
        with pytest.raises(SystemExit, match="batch_size 4 is not a "
                                             "multiple of --num_devices 3"
                           ) as err:
            train_cli.main(args + extra)
        assert fragment not in str(err.value)
        return
    if extra[0] == "--num_devices":
        assert train_cli.main(args + extra) == 0
        final = read_state(str(tmp_path / "run" / "checkpoints"
                                / "final_model"))
        assert final["step"] == 4
        lines = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
        assert sum("train/loss" in line for line in lines) == 4
        return
    out_dir = (tmp_path / "run" / "profile" if extra[1].startswith("--")
               else tmp_path / extra[1])
    if extra[1] == "trace_dir":
        extra = ["--profile", str(out_dir), *extra[2:]]
    assert train_cli.main(args + extra) == 0
    assert f"Profiler trace written to {out_dir}" in capsys.readouterr().out
    (trace,) = out_dir.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::convolution")
               for e in events)
    final = read_state(str(tmp_path / "run" / "checkpoints" / "final_model"))
    assert final["step"] == 3 + 4


def _write_mnist(root):
    rng = np.random.default_rng(7)
    root.mkdir()
    for split, n in (("train", 10), ("t10k", 4)):
        for kind, head, data in (
                ("images-idx3", struct.pack(">IIII", 2051, n, 28, 28),
                 rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)),
                ("labels-idx1", struct.pack(">II", 2049, n),
                 rng.integers(0, 10, n, dtype=np.uint8))):
            (root / f"{split}-{kind}-ubyte").write_bytes(head
                                                         + data.tobytes())


@pytest.mark.parametrize("section,key,value,fragment", [
    ("training", "scan_steps", 4, "scan_steps"),
    ("training", "grad_accum_steps", 2, "grad_accum_steps"),
    ("training", "adam_mu_dtype", "bfloat16", "adam_mu_dtype"),
    ("model_config", "remat_policy", "save_convout", "remat_policy"),
    ("training", "ema_dtype", "bfloat16", "ema_dtype"),
    ("data", "dataset", "mnist", "mnist"),
    ("data", "dataset", "celeba", "celeba")])
def test_unported_options_raise(tmp_path, section, key, value, fragment):
    """``scan_steps > 1`` is refused. The other options, once refused here,
    run and differ from their defaults (``tests/test_torch_datasets.py``
    and ``tests/test_torch_train_options.py`` hold them against JAX)."""
    cfg = _config(tmp_path, 1)
    cfg[section][key] = value
    if key == "scan_steps":
        with pytest.raises(ValueError, match=f"{fragment}.*not yet ported"):
            DDPMTrainer(DDPM(cfg["model_config"], device="cpu",
                             trainable=True),
                        *get_dataset(cfg, device="cpu"), cfg)
        return
    if value == "mnist":
        _write_mnist(tmp_path / "mnist")
        cfg["data"]["data_dir"] = str(tmp_path / "mnist")
    elif value == "celeba":
        np.savez(tmp_path / "celeba_64.npz", images=np.random.default_rng(
            0).integers(0, 256, (10, 64, 64, 3), dtype=np.uint8))
        cfg["data"]["data_dir"] = str(tmp_path)
    model = DDPM(cfg["model_config"], device="cpu", trainable=True)
    loaders = get_dataset(cfg, device="cpu")
    tr = DDPMTrainer(model, *loaders, cfg)
    batches = list(loaders[0])
    m = (tr.accum_step(batches[:2]) if key == "grad_accum_steps"
         else tr.step(batches[0]))
    assert torch.isfinite(m["loss"]) and tr.step_count == 1
    if key == "grad_accum_steps":
        assert tr.steps_per_epoch == -(-len(loaders[0]) // 2)
    elif key == "remat_policy":
        assert model.net._remat_context is not noop_context_fn
    elif key == "dataset":
        assert batches[0].shape[1:] == ((32, 32, 3) if value == "mnist"
                                        else (64, 64, 3))
    else:
        state = tr.optimizer.mu if key == "adam_mu_dtype" else tr.ema
        assert {v.dtype for v in state} == {torch.bfloat16}
    tr.cleanup()


def test_train_cli_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_cli.build_argparser().parse_args(
        ["--config", "c", "--model_type", "ddpm"]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--config", _write(tmp_path, _config(tmp_path, 1)),
                        "--model_type", "ddpm"])
