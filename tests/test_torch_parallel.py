"""The port's data parallelism (``parallel/mesh.py``), on the CPU, at a
small size (C=32, 32², T=8, B=4), with dropout 0 and remat off wherever
two runs are compared.

Two gloo ranks, spawned by the port's launcher through a ``file://``
rendezvous under ``tmp_path``, take one update that is held against a JAX
``DDPMTrainer.step`` on a two-device mesh (the conftest's virtual CPU
devices) with the same weights, global batch and key-derived t and
noise; and against one process of the port: three accumulated updates
(their replicas bit-equal to each other), ``validate()`` for 1, 2 and 3
ranks over a ragged tail, the preemption agreement with a SIGTERM on one
rank, rank-0-only checkpoint writes and a resume; a failed rank stops
the others. The loader's two modes
are held against one process and against JAX's host shard, and the
``distributed`` layout against JAX's ``make_mesh``.
"""

import json
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_ranks as ranks
from diffusion_model_universal_tpu.datasets import pipeline as jpipe
from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.parallel.mesh import make_mesh
from diffusion_model_universal_tpu.trainers import DDPMTrainer as JaxTrainer
from diffusion_model_universal_torch import NOT_PORTED
from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.datasets import pipeline as tpipe
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.parallel import mesh
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers import DDPMTrainer

torch.set_num_threads(2)

C, T, B = 32, 8, 4
MODEL_CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
             "in_channels": 3, "compute_dtype": "float32", "remat": False,
             "dropout": 0.0}


def _config(tmp_path, **training):
    return {"model_name": "DDPM", "model_config": MODEL_CFG,
            "training": {"num_epochs": 1, "batch_size": B,
                         "learning_rate": 1e-3, "ema_decay": 0.999,
                         "grad_clip": 1.0, "val_interval": 1000,
                         "sample_interval": 0, "checkpoint_interval": 1,
                         "scheduler": {"type": "cosine", "min_lr": 1e-6},
                         **training},
            # 60 images: 48 train, 6 val (a ragged tail of 2), 6 test.
            "data": {"dataset": "synthetic", "data_dir": "unused",
                     "num_samples": 60},
            "logging": {"log_interval": 1},
            "output": {"output_dir": str(tmp_path / "run")}}


def _spawn(fn, n, tmp_path, *args):
    out = tmp_path / f"{fn.__name__}_{n}"
    out.mkdir()
    assert mesh.spawn(fn, n, args=(str(out), *args), device_type="cpu",
                      rendezvous_dir=str(tmp_path)) == 0
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def _adam_leaves(state, name):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if any(getattr(k, "name", None) == name for k in path):
            out.append(np.asarray(leaf))
    return out


# -- the slice against JAX ----------------------------------------------

def test_two_ranks_match_jax_two_device_step(tmp_path):
    """Two port ranks, each with its rows of the batch and the t and
    noise JAX derives from ``_step_key(0)`` (the time weights rescale
    over the whole batch's t), take one update; JAX takes
    one ``DDPMTrainer.step`` on a two-device mesh. The tolerances of
    ``tests/test_torch_train.py``'s one-device step: loss rtol 1e-5,
    global and per-layer gradient norms rtol 1e-4, Adam μ rtol 1e-3 +
    atol 1e-7 and ν atol 1e-12 (f32 sums in another order). The two
    replicas are bit-equal."""
    cfg = _config(tmp_path, num_epochs=2, skip_nonfinite_updates=3)
    model = DDPM(MODEL_CFG, device="cpu", seed=3, trainable=True)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        unet_params_to_jax(model.net))
    jmodel = JaxDDPM(MODEL_CFG)
    jmodel.init_params = lambda key: jax.tree_util.tree_map(jnp.asarray,
                                                            params)
    jtr = JaxTrainer(jmodel, [None] * 5, None, None,
                     dict(cfg, output={"output_dir": str(tmp_path / "jax")}),
                     mesh=make_mesh(jax.devices()[:2]), seed=0)
    x = np.clip(np.random.default_rng(6).normal(size=(B, 32, 32, 3)),
                -1, 1).astype(np.float32)
    kt, kn, _ = jax.random.split(jtr._step_key(0), 3)
    t = np.asarray(jax.random.randint(kt, (B,), 0, T))
    noise = np.asarray(jax.random.normal(kn, x.shape, jnp.float32))
    jm = jtr.step(jnp.asarray(x))

    got = _spawn(ranks.injected_step, 2, tmp_path, cfg,
                 unet_state_dict_from_jax(params), torch.from_numpy(x),
                 torch.from_numpy(t), torch.from_numpy(noise))
    for key in ("params", "ema", "mu", "nu"):
        for a, b in zip(got[0][key], got[1][key]):
            assert torch.equal(a, b), key
    ours = got[0]
    np.testing.assert_allclose(ours["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(ours["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)

    def tree(tensors):
        return state_dict_to_jax(model.net, dict(zip(
            [n for n, _ in model.net.named_parameters()], tensors)))

    norms = tree([torch.full(p.shape, v) for p, v in
                  zip(model.net.parameters(), ours["layer_grad_norms"])])
    np.testing.assert_allclose(
        [a.flat[0] for a in jax.tree_util.tree_leaves(norms)],
        [float(v) for v in jax.tree_util.tree_leaves(jm["layer_grad_norms"])],
        rtol=1e-4, atol=1e-8)
    state = jax.device_get(jtr.state)
    for name, atol in (("mu", 1e-7), ("nu", 1e-12)):
        got_leaves = jax.tree_util.tree_leaves(tree(ours[name]))
        want = _adam_leaves(state.opt_state, name)
        assert len(got_leaves) == len(want)
        for a, b in zip(got_leaves, want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=atol)


# -- two ranks against one process --------------------------------------

def test_replicas_validate_preemption_and_resume_against_one_process(
        tmp_path):
    """Two ranks against one process of the port on the same data:
    ``validate()`` equal to rtol 1e-6 (f64 sums; also for 3 ranks, whose
    split of the ragged tail of 2 leaves rank 0 no row); three updates of
    ``grad_accum_steps: 2``, each loss rtol 1e-5 and gradient norm rtol
    1e-4, μ after them rtol 1e-3 + atol 1e-7, the replicas bit-equal
    after each; then ``train()`` with a SIGTERM on rank 1 alone after
    two of its updates: both ranks save at the same step, rank 0 alone
    writes the checkpoint and the log (histograms on), and one process
    resumes its bits."""
    cfg = _config(tmp_path, grad_accum_steps=2)
    cfg["logging"] = {"log_interval": 1, "track_histograms": True,
                      "gradient_logging_freq": 4}
    got = _spawn(ranks.updates_then_preempt, 2, tmp_path, cfg, 3, 2)
    three = _spawn(ranks.validate_only, 3, tmp_path, cfg)

    one = DDPMTrainer(DDPM(MODEL_CFG, device="cpu", seed=0, trainable=True),
                      *get_dataset(cfg, device="cpu"),
                      dict(cfg, output={"output_dir": str(tmp_path / "one")}),
                      seed=0)
    val = one.validate()
    for r in got + three:
        np.testing.assert_allclose(r["val"], val, rtol=1e-6)
    metrics = []
    for i, chunk in enumerate(one._updates(one.train_loader)):
        if i == 3:
            break
        m = one.accum_step(chunk)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    assert got[0]["digests"] == got[1]["digests"]
    assert len(set(got[0]["digests"])) == 3
    for (loss, norm), (want_loss, want_norm) in zip(got[0]["metrics"],
                                                    metrics):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(norm, want_norm, rtol=1e-4)
    for a, b in zip(got[0]["after_updates"]["mu"], one.optimizer.mu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-7)
    one.cleanup()

    # train() restarts the epoch at step 3; rank 1's SIGTERM comes after
    # its second update there, so both stop at step 5.
    for r in got:
        assert r["preempted"] and r["history"]["preempted"] == 1.0
        assert r["step"] == 5
    assert got[0]["saves"] == ["checkpoint_epoch_0"] and got[1]["saves"] == []
    # Rank 0 alone logged steps 3 and 4; both ranks computed step 4's
    # histograms (their gradients' all-reduce needs both).
    logged = [json.loads(line) for line in
              (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
              if "train/loss" in line]
    assert [m["step"] for m in logged] == [3, 4]
    assert any(k.endswith("_hist/mean") for k in logged[1])
    assert got[0]["digest_at_preemption"] == got[1]["digest_at_preemption"]
    resumed = DDPMTrainer(
        DDPM(MODEL_CFG, device="cpu", seed=9, trainable=True),
        *get_dataset(cfg, device="cpu"), cfg, seed=0)
    assert resumed.load_checkpoint() == 1 and resumed.step_count == 5
    assert train_cli.params_digest(resumed.params) == \
        got[0]["digest_at_preemption"]
    resumed.cleanup()


def test_a_failed_rank_stops_the_others_and_raises(tmp_path):
    """No rank outlives a failed one: rank 1 raises while rank 0 waits in
    a barrier for it; the launcher stops what is left and raises, naming
    the first rank it finds failed (rank 0's barrier may fail first, on
    the lost connection), long before the group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank [01] of 2 exited with code"):
        mesh.spawn(ranks.fail_on_rank1, 2, args=(str(tmp_path),),
                   device_type="cpu", rendezvous_dir=str(tmp_path))
    assert time.perf_counter() - t0 < 120


# -- the loader's two modes ---------------------------------------------

@pytest.mark.parametrize("parts", [2, 3])
def test_split_rows_stack_to_the_one_process_batch(parts):
    """``--num_devices`` mode: the ranks' rows of every batch, stacked in
    rank order, equal the unsplit loader's batch, random flips, rotation,
    crop and jitter included (each rank draws the whole batch's
    augmentation and keeps its rows), over two epochs, the ragged eval
    tail too."""
    images = np.random.default_rng(0).integers(0, 256, (23, 8, 8, 3),
                                               dtype=np.uint8)
    transforms = [{"name": "random_horizontal_flip", "p": 0.5},
                  {"name": "random_rotation", "degrees": 10},
                  {"name": "random_crop", "size": 8, "padding": 2},
                  {"name": "color_jitter", "brightness": 0.2,
                   "contrast": 0.2, "saturation": 0.2, "hue": 0.05},
                  {"name": "normalize"}]
    aug = tpipe.make_augment_fn(transforms, [0.5] * 3, [0.5] * 3, train=True)
    for shuffle, drop_last in ((True, True), (False, False)):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last,
                  device="cpu")
        whole = tpipe.DeviceDataLoader(images, 5, aug, **kw)
        split = [tpipe.DeviceDataLoader(images, 5, aug, split=(r, parts),
                                        **kw) for r in range(parts)]
        for epoch in (0, 1):
            for loader in (whole, *split):
                loader.set_epoch(epoch)
            want = list(whole)
            got = [list(loader) for loader in split]
            assert all(len(g) == len(want) for g in got)
            for k, batch in enumerate(want):
                blocks = [g[k] for g in got]
                n = batch.shape[0]
                assert [b["rows"] for b in blocks] == [
                    (r * n // parts, (r + 1) * n // parts, n)
                    for r in range(parts)]
                torch.testing.assert_close(
                    torch.cat([b["image"] for b in blocks]), batch,
                    rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 3])
def test_multihost_shard_matches_jax(world):
    """``--multihost`` mode: each process's batches through
    ``get_dataset(config, world, rank)`` visit the images JAX's
    ``DeviceDataLoader(world_size, rank)`` visits, over two epochs."""
    images = np.repeat(np.arange(50, dtype=np.uint8)[:, None, None, None],
                       2, axis=1).repeat(2, axis=2)
    for rank in range(world):
        ours = tpipe.DeviceDataLoader(images, 4, lambda b, g: b, seed=5,
                                      world_size=world, rank=rank,
                                      device="cpu")
        theirs = jpipe.DeviceDataLoader(images, 4, lambda b, k: b, seed=5,
                                        world_size=world, rank=rank)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got = [b[:, 0, 0, 0].numpy() for b in ours]
            want = [np.asarray(b)[:, 0, 0, 0] for b in theirs]
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# -- the layout and the CLI ---------------------------------------------

@pytest.mark.parametrize("devices,model,spatial,refusal", [
    (2, 2, 1, "model_parallel"), (2, 1, 2, "spatial_parallel"),
    (2, 3, 1, "mesh 0x1x3 != 2 devices"),
    (3, 1, 2, "mesh 1x2x1 != 3 devices")])
def test_distributed_layout_refusals(tmp_path, devices, model, spatial,
                                     refusal):
    """The config's ``distributed`` section, once ignored: a layout that
    does not cover the devices raises as JAX's ``make_mesh`` does (its
    message), and one that does but asks for tensor or spatial
    parallelism is refused as not ported, by the CLI before any rank
    starts."""
    if refusal.startswith("mesh"):
        with pytest.raises(ValueError, match=refusal):
            make_mesh(jax.devices()[:devices], model_parallel=model,
                      spatial_parallel=spatial)
    else:
        assert make_mesh(jax.devices()[:devices], model_parallel=model,
                         spatial_parallel=spatial).size == devices
        refusal = f"{refusal} > 1 is {NOT_PORTED}"
    with pytest.raises(ValueError, match=refusal):
        mesh.make_layout(devices, model_parallel=model,
                         spatial_parallel=spatial)
    cfg = dict(_config(tmp_path), distributed={
        "backend": "nccl", "find_unused_parameters": False,
        "model_parallel": model, "spatial_parallel": spatial})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(SystemExit, match=refusal):
        train_cli.main(["--config", str(path), "--model_type", "ddpm",
                        "--device", "cpu", "--num_devices", str(devices)])
    assert not (tmp_path / "run").exists()


def test_multihost_cli_at_world_one(tmp_path, monkeypatch, capsys):
    """``train --multihost`` joins the group torchrun's environment
    describes (world 1 here, gloo on the CPU), trains, checkpoints and
    leaves the group."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(key, value)
    cfg = _config(tmp_path)
    cfg["data"]["num_samples"] = 20
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config", str(path), "--model_type", "ddpm",
                           "--device", "cpu", "--multihost"]) == 0
    out = capsys.readouterr().out
    assert "Data parallel: 1 ranks over gloo, global batch 4 (4 a rank)" \
        in out and "Final test loss" in out
    assert not mesh.is_initialized()
    assert (tmp_path / "run" / "checkpoints" / "final_model"
            / "state.pt").is_file()
