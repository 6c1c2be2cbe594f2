"""The port's data and model parallelism and its sampling over ranks
(``parallel/mesh.py``), on the CPU, at a small size (C=32, 32², T=8,
B=4), with dropout 0 and remat off wherever two runs are compared.

Two gloo ranks, spawned once for the module by the port's launcher
through a ``file://`` rendezvous (the ``two_ranks`` fixture; a spawn
costs seconds of process start), run every two-rank scenario in turn:
one update that is held against a JAX ``DDPMTrainer.step`` on a
two-device mesh (the conftest's virtual CPU devices) with the same
weights, global batch and key-derived t and noise; and, against one
process of the port, three accumulated updates (their replicas
bit-equal to each other), the preemption agreement with a SIGTERM on one
rank, rank-0-only checkpoint writes and a resume; ``generate`` (ragged
rows, CFG, DPM++, inpainting, a chunked request), ``serve`` over HTTP
and ``train --benchmark``'s harness, each rank sampling its rows; and
``distributed.model_parallel: 2``: three updates from half of each
sharded leaf, a checkpoint that restores at world 1 and at (D=2,
M=1), and an emergency checkpoint of each rank's own shards that one
process restores. ``validate()`` is held for 1, 2 and 3 ranks over a ragged tail; a
failed rank stops the others. The loader's two modes are held against
one process and against JAX's host shard, the ``distributed`` layout
against JAX's ``make_mesh``, and the shard plan against JAX's
``param_sharding``. Chained, the ranks equal one process, which the other
test files hold against JAX.
"""

import json
import re
import shutil
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
from diffusion_model_universal_tpu.parallel.mesh import (MODEL_AXIS,
                                                          make_mesh,
                                                          param_sharding)
from diffusion_model_universal_tpu.trainers import DDPMTrainer as JaxTrainer
from diffusion_model_universal_torch import NOT_PORTED
from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.datasets import pipeline as tpipe
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models.convert import (
    flax_layout, state_dict_to_jax, unet_params_to_jax,
    unet_state_dict_from_jax)
from diffusion_model_universal_torch.parallel import mesh
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.scripts.serve import SamplerService
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.utils.checkpoint import read_state
from diffusion_model_universal_torch.utils.images import decode_png
from diffusion_model_universal_torch.utils.memory import \
    estimate_sampler_bytes

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


def _spawn(n, tmp_path, plan):
    """``plan``'s scenarios (``torch_parallel_ranks.scenarios``) on ``n``
    spawned gloo ranks: each rank's {name: result}."""
    out = tmp_path / f"ranks_{n}"
    out.mkdir()
    assert mesh.spawn(ranks.scenarios, n, args=(str(out), plan),
                      device_type="cpu", rendezvous_dir=str(tmp_path)) == 0
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


#: The sampling scenarios' model: conditional, so CFG runs, and T=4.
SAMPLER_CFG = dict(MODEL_CFG, num_classes=10, num_timesteps=4)
#: The whole-UNet bound of the port against one process or JAX.
UNET_TOL = dict(atol=1e-3, rtol=1e-3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _budget(model, batch: int) -> float:
    """The ``DMU_SAMPLER_HBM_BYTES`` whose budget fits ``batch`` samples
    a device and no more."""
    params = sum(p.numel() * 4 for p in model.net.parameters())
    return estimate_sampler_bytes(batch, 32, C, 3, 4, params) / 0.5


def _injected_inputs():
    """The JAX step's weights (the port's seed-3 UNet perturbed), batch,
    and the t and noise ``DDPMTrainer._step_key(0)`` derives."""
    model = DDPM(MODEL_CFG, device="cpu", seed=3, trainable=True)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        unet_params_to_jax(model.net))
    x = np.clip(np.random.default_rng(6).normal(size=(B, 32, 32, 3)),
                -1, 1).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    kt, kn, _ = jax.random.split(key, 3)
    t = np.array(jax.random.randint(kt, (B,), 0, T))
    noise = np.array(jax.random.normal(kn, x.shape, jnp.float32))
    return {"model": model, "params": params, "x": x, "t": t,
            "noise": noise, "key": key}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank scenario of this module in one spawn of two gloo
    ranks (a spawn costs seconds of process start): (each rank's
    {scenario: result}, the scenarios' inputs)."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    setup = {"tmp": tmp, "injected": _injected_inputs()}
    inj = setup["injected"]
    setup["jax_cfg"] = _config(tmp / "inj", num_epochs=2,
                               skip_nonfinite_updates=3)
    preempt = _config(tmp, grad_accum_steps=2)
    preempt["logging"] = {"log_interval": 1, "track_histograms": True,
                          "gradient_logging_freq": 4}
    setup["preempt_cfg"] = preempt

    # A conditional checkpoint, an inpainting image and mask, and the
    # requests of generate (DMU_SAMPLER_HBM_BYTES of the chunked one:
    # room for 2 samples a device, so 7 go in 2 chunks of 4, as one
    # process plans them with room for 4).
    sampler = DDPM(SAMPLER_CFG, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():   # the zero-initialized head too
        for p in sampler.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ckpt = str(tmp / "cond.ckpt")
    sampler.save(ckpt)
    cfg_path = tmp / "sampler.yaml"
    cfg_path.write_text(yaml.safe_dump({"model_config": SAMPLER_CFG}))
    r = np.random.default_rng(3)
    np.save(tmp / "image.npy", r.uniform(-1, 1, (32, 32, 3)).astype(
        np.float32))
    np.save(tmp / "mask.npy", (r.uniform(size=(32, 32)) > 0.5).astype(
        np.float32))
    base = ["--config", str(cfg_path), "--model_type", "ddpm",
            "--checkpoint", ckpt, "--device", "cpu", "--seed", "3"]
    cases = {
        "odd": (base + ["--num_samples", "5"], None, None),
        "cfg": (base + ["--num_samples", "4", "--class_id", "2"], None,
                None),
        "dpm": (base + ["--num_samples", "3", "--sampler", "dpm++",
                        "--sampler_steps", "4"], None, None),
        "inpaint": (base + ["--num_samples", "3", "--inpaint_image",
                            str(tmp / "image.npy"), "--inpaint_mask",
                            str(tmp / "mask.npy")], None, None),
        "chunked": (base + ["--num_samples", "7"], _budget(sampler, 2),
                    _budget(sampler, 4))}
    setup.update(sampler=sampler, cases=cases, gen_cli=base + [
        "--num_samples", "3", "--output_dir", str(tmp / "gen_ranks")])
    port = _free_port()
    setup["serve_argv"] = [
        "--config", str(cfg_path), "--model_type", "ddpm", "--checkpoint",
        ckpt, "--device", "cpu", "--serve_batch", "4", "--port", str(port)]
    setup["serve_bodies"] = [
        {"num_samples": 3, "seed": 4},
        {"num_samples": 4, "seed": 5, "class_id": 3, "sampler": "dpm++",
         "sampler_steps": 3},
        {"num_samples": 2, "sampler": "dpm++", "sampler_steps": 1},
        {"num_samples": 2, "seed": 6, "sampler": "heun", "sampler_steps": 3}]
    bench = dict(_config(tmp / "bench"), model_config=SAMPLER_CFG,
                 benchmark={"n_samples": 5, "batch_size": 4,
                            "use_inception": False, "sampler": "dpm++",
                            "sampler_steps": 3})
    setup["bench_cfg"] = bench
    setup["bench_images"] = torch.from_numpy(np.clip(r.normal(
        size=(8, 32, 32, 3)), -1, 1).astype(np.float32))
    mp = dict(_config(tmp / "mp"), distributed={"model_parallel": 2})
    setup["mp_cfg"] = mp
    plan = [("injected", "injected_step",
             (setup["jax_cfg"], unet_state_dict_from_jax(inj["params"]),
              torch.from_numpy(inj["x"]), torch.from_numpy(inj["t"]),
              torch.from_numpy(inj["noise"]))),
            ("preempt", "updates_then_preempt", (preempt, 3, 2)),
            ("generate", "generate_draws",
             ({k: (argv, budget) for k, (argv, budget, _) in
               cases.items()},)),
            ("generate_cli", "generate_cli", (setup["gen_cli"],)),
            ("serve", "serve_ranks", (setup["serve_argv"],
                                      setup["serve_bodies"])),
            ("benchmark", "benchmark", (bench, ckpt, setup["bench_images"])),
            ("model_parallel", "model_parallel", (mp, 3))]
    return _spawn(2, tmp, plan), setup


def _adam_leaves(state, name):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if any(getattr(k, "name", None) == name for k in path):
            out.append(np.asarray(leaf))
    return out


# -- the slice against JAX ----------------------------------------------

def test_two_ranks_match_jax_two_device_step(two_ranks, tmp_path):
    """Two port ranks, each with its rows of the batch and the t and
    noise JAX derives from ``_step_key(0)`` (the time weights rescale
    over the whole batch's t), take one update; JAX takes
    one ``DDPMTrainer.step`` on a two-device mesh. The tolerances of
    ``tests/test_torch_train.py``'s one-device step: loss rtol 1e-5,
    global and per-layer gradient norms rtol 1e-4, Adam μ rtol 1e-3 +
    atol 1e-7 and ν atol 1e-12 (f32 sums in another order). The two
    replicas are bit-equal."""
    results, setup = two_ranks
    inj = setup["injected"]
    model, params, x = inj["model"], inj["params"], inj["x"]
    jmodel = JaxDDPM(MODEL_CFG)
    jmodel.init_params = lambda key: jax.tree_util.tree_map(jnp.asarray,
                                                            params)
    jtr = JaxTrainer(jmodel, [None] * 5, None, None,
                     dict(setup["jax_cfg"],
                          output={"output_dir": str(tmp_path / "jax")}),
                     mesh=make_mesh(jax.devices()[:2]), seed=0)
    np.testing.assert_array_equal(
        jax.random.key_data(jtr._step_key(0)),
        jax.random.key_data(inj["key"]))
    jm = jtr.step(jnp.asarray(x))

    got = [r["injected"] for r in results]
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
        two_ranks, tmp_path):
    """Two ranks against one process of the port on the same data:
    ``validate()`` equal to rtol 1e-6 (f64 sums; also for 3 ranks, whose
    split of the ragged tail of 2 leaves rank 0 no row); three updates of
    ``grad_accum_steps: 2``, each loss rtol 1e-5 and gradient norm rtol
    1e-4, μ after them rtol 1e-3 + atol 1e-7, the replicas bit-equal
    after each; then ``train()`` with a SIGTERM on rank 1 alone after
    two of its updates: both ranks save at the same step, rank 0 alone
    writes the checkpoint and the log (histograms on), and one process
    resumes its bits."""
    results, setup = two_ranks
    cfg = setup["preempt_cfg"]
    got = [r["preempt"] for r in results]
    three = [r["val"] for r in _spawn(3, tmp_path, [
        ("val", "validate_only", (cfg,))])]

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
              (setup["tmp"] / "run" / "metrics.jsonl").read_text()
              .splitlines() if "train/loss" in line]
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
    pytest.param(2, 2, 1, "training.batch_size 3 is not a multiple of "
                          "D·M = 2 (--num_devices 2: data 1 × spatial 1 × "
                          "model 2)",
                 id="2-2-1-model_parallel"),
    (2, 1, 2, "spatial_parallel"),
    (2, 3, 1, "mesh 0x1x3 != 2 devices"),
    (3, 1, 2, "mesh 1x2x1 != 3 devices")])
def test_distributed_layout_refusals(tmp_path, devices, model, spatial,
                                     refusal):
    """The config's ``distributed`` section, once ignored: a layout that
    does not cover the devices raises as JAX's ``make_mesh`` does (its
    message); spatial parallelism lays the ranks out as JAX's mesh and
    its training (the backward half, not ported) is refused; model
    parallelism runs, in JAX's layout, and the CLI refuses a batch that
    the D·M ranks cannot split (JAX needs only D to divide it: its model
    axis shards channels, the port's ranks split rows), all before any
    rank starts."""
    cfg = dict(_config(tmp_path), distributed={
        "backend": "nccl", "find_unused_parameters": False,
        "model_parallel": model, "spatial_parallel": spatial})
    if refusal.startswith("mesh"):
        with pytest.raises(ValueError, match=refusal):
            make_mesh(jax.devices()[:devices], model_parallel=model,
                      spatial_parallel=spatial)
        with pytest.raises(ValueError, match=refusal):
            mesh.make_layout(devices, model_parallel=model,
                             spatial_parallel=spatial)
    else:
        jmesh = make_mesh(jax.devices()[:devices], model_parallel=model,
                          spatial_parallel=spatial)
        assert jmesh.size == devices
        assert mesh.make_layout(devices, model_parallel=model,
                                spatial_parallel=spatial) == dict(
                                    jmesh.shape)
        if spatial > 1:
            refusal = (f"distributed: training under {refusal} {spatial} "
                       f"is {NOT_PORTED}")
        else:
            cfg["training"]["batch_size"] = 3
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(SystemExit, match=re.escape(refusal)):
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


# -- sampling over ranks --------------------------------------------------

def _close(got, want):
    """The whole-UNet bound; returns the max |got − want|."""
    np.testing.assert_allclose(got, want, **UNET_TOL)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


def test_generate_over_two_ranks_gives_the_one_process_images(
        two_ranks, monkeypatch, tmp_path):
    """``generate``'s request drawn by two ranks, each its rows of every
    chunk with the chunk's draws made for the whole chunk, and gathered by
    rank 0, against one process: an odd ``--num_samples`` (ragged rows:
    2 and 3), CFG, DPM++, inpainting (the image tiled to the batch, a 2-D
    mask), and 7 samples in two chunks of 4 (the second ragged: 1 and 2
    rows), each rank planning a budget of 2 samples as one process plans
    4. Within 1e-3 + 1e-3·|ref|; measured ≤ 4e-6 on the CPU. Rank 1 returns
    nothing. The ranks' CLI body (``generate.run_rank``, what ``main``
    spawns) writes one process's PNGs, up to the 8-bit rounding."""
    results, setup = two_ranks
    for name, (argv, _, budget) in setup["cases"].items():
        if budget is None:
            monkeypatch.delenv("DMU_SAMPLER_HBM_BYTES", raising=False)
        else:
            monkeypatch.setenv("DMU_SAMPLER_HBM_BYTES", str(budget))
        args = gen_cli.build_argparser().parse_args(argv)
        want = gen_cli.draw(args, torch.device("cpu"))
        got = results[0]["generate"][name]
        assert got.shape == want.shape == (args.num_samples, 32, 32, 3)
        assert _close(got, want) < 1e-5, name
        assert results[1]["generate"][name] is None
    monkeypatch.delenv("DMU_SAMPLER_HBM_BYTES", raising=False)
    assert [r["generate_cli"]["code"] for r in results] == [0, 0]
    argv = setup["gen_cli"][:-1] + [str(tmp_path)]
    assert gen_cli.run(gen_cli.build_argparser().parse_args(argv),
                       torch.device("cpu")) == 0
    for name in ("samples_grid.png", *(f"sample_{i:04d}.png"
                                       for i in range(3))):
        got, want = (decode_png((d / name).read_bytes()).astype(int)
                     for d in (setup["tmp"] / "gen_ranks", tmp_path))
        assert np.abs(got - want).max() <= 1, name


def test_serve_over_two_ranks_answers_as_one_process(two_ranks):
    """``serve``'s ranks (the launcher's target, ``serve.run_rank``):
    rank 0's HTTP server sends each request to rank 1 and gathers its
    rows of the serve batch of 4: 3 and 4 samples (CFG with DPM++) equal
    one process's service within the whole-UNet bound; a bad
    ``sampler_steps`` answers 400 with the sampler's message while both
    ranks serve on (Heun next); ``/healthz`` counts two devices and the
    warm-up; rank 0's SIGTERM stops both ranks with code 0."""
    results, setup = two_ranks
    served = results[0]["serve"]
    assert served["code"] == 0 and results[1]["serve"]["code"] == 0
    assert served["healthz"]["devices"] == 2
    assert served["healthz"]["requests"] == 4
    one = SamplerService(setup["sampler"], 4)
    for body, (code, got) in zip(setup["serve_bodies"],
                                 served["responses"]):
        kw = {k: v for k, v in body.items()
              if k not in ("num_samples", "seed")}
        try:
            want = one.generate(body["num_samples"], body.get("seed", 0),
                                **kw)
        except ValueError as e:
            assert (code, got) == (400, str(e))
            continue
        assert code == 200
        _close(got, want)


def test_benchmark_over_two_ranks_gives_the_one_process_scores(two_ranks,
                                                               tmp_path):
    """``train --benchmark``'s ``run_benchmark`` on a replica of two ranks
    (its EMA, which starts as the checkpoint's weights): 5 samples in
    batches of 4 (the second's one row on rank 1, rank 0 sampling none
    and still joining the gather), DPM++-3, rank 0 scoring the gathered
    images; FID and IS equal one process's to 1e-6 relative, SSIM and
    PSNR to 1e-5 (the unpaired SSIM is about 0.008 here, and a row
    sampled alone differs from one in a batch of four at f32 rounding),
    and rank 1 returns none."""
    results, setup = two_ranks
    cfg = dict(setup["bench_cfg"],
               output={"output_dir": str(tmp_path / "one")})
    model = DDPM(SAMPLER_CFG, device="cpu", seed=0, trainable=True)
    model.load(str(setup["tmp"] / "cond.ckpt"))
    tr = DDPMTrainer(model, [None] * 5, None, None, cfg, seed=0)
    want = train_cli.run_benchmark(tr, cfg, [setup["bench_images"]], True,
                                   mesh.sampling_scope())
    tr.cleanup()
    got = results[0]["benchmark"]["results"]
    assert results[1]["benchmark"]["results"] is None
    assert set(got) == set(want) == {"fid", "is_mean", "is_std", "ssim",
                                     "psnr"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=(
            1e-5 if k in ("ssim", "psnr") else 1e-6))


# -- model parallelism ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_param_shapes():
    """The JAX UNet's parameter tree as shapes (``jax.eval_shape`` of its
    init: nothing compiled)."""
    return jax.eval_shape(JaxDDPM(MODEL_CFG).init_params,
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("model_parallel", [2, 4])
def test_shard_plan_matches_jax_param_sharding(jax_param_shapes,
                                               model_parallel):
    """``mesh.shard_plan`` against JAX's ``param_sharding`` on the C=32
    UNet's tree (``jax.eval_shape`` of its init: nothing compiled): the
    same leaves sharded (those of at least 2¹⁶ elements with a dimension
    the model axis divides) along the same flax axis; and rank r's block
    of each (``mesh.shard_block``, through ``models/convert.py``'s
    layouts) holds exactly the elements JAX's device r of the model axis
    holds."""
    jmesh = make_mesh(jax.devices()[:model_parallel],
                      model_parallel=model_parallel)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(
            param_sharding(jmesh, jax_param_shapes))[0]:
        spec = tuple(sh.spec)
        want[tuple(k.key for k in path)] = (
            spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None, sh)
    net = DDPM(MODEL_CFG, device="cpu").net
    plan = mesh.shard_plan(net, model_parallel)
    sharded = 0
    for (key, p), spec in zip(net.named_parameters(), plan):
        prefix, _, name = key.rpartition(".")
        flax_name, perm, flips = flax_layout(net.get_submodule(prefix), key,
                                             name, p.ndim)
        axis, sh = want.pop((*filter(None, prefix.split(".")), flax_name))
        assert (None if spec is None else perm.index(spec)) == axis, key
        if spec is None:
            continue
        sharded += 1
        whole = torch.arange(p.numel(), dtype=torch.float64).view(p.shape)

        def flax_view(t):
            return np.flip(t.numpy(), flips).transpose(perm)
        index = sh.devices_indices_map(tuple(flax_view(whole).shape))
        for r, device in enumerate(jmesh.devices.reshape(-1)):
            block = mesh.shard_block(whole, spec, model_parallel, r)
            assert block.numel() * model_parallel == p.numel()
            np.testing.assert_array_equal(flax_view(block),
                                          flax_view(whole)[index[device]])
    assert not want and sharded > 0


def test_shard_plan_refuses_a_flipped_axis():
    """A transposed conv whose largest dimension is spatial would be
    sharded along an axis the flax layout reads in reverse; the plan
    refuses it (the UNet's transposed convs shard along a channel
    axis)."""
    net = torch.nn.Sequential(torch.nn.ConvTranspose2d(1, 1, 256))
    with pytest.raises(NotImplementedError, match="0.weight"):
        mesh.shard_plan(net, 2)


def test_model_parallel_updates_match_one_process(two_ranks, tmp_path):
    """``distributed.model_parallel: 2`` on two ranks (D=1, M=2, each
    rank its rows of the batch): between updates a rank holds exactly
    half of each sharded leaf's f32 parameter, EMA, μ and ν, along the
    planned axis, the network's copy of it empty, and the small leaves
    whole; three updates against one process: loss rtol 1e-5, gradient
    norm rtol 1e-4, the gathered μ rtol 1e-3 + atol 1e-7 (the JAX step's
    tolerances); both ranks gather the same parameters."""
    results, setup = two_ranks
    got = [r["model_parallel"] for r in results]
    net = DDPM(MODEL_CFG, device="cpu").net
    whole = [tuple(p.shape) for p in net.parameters()]
    plan = got[0]["plan"]
    assert plan == mesh.shard_plan(net, 2)
    assert sum(a is not None for a in plan) > 0
    for g in got:
        for i, (shape, axis) in enumerate(zip(whole, plan)):
            want = list(shape)
            if axis is not None:
                want[axis] //= 2
                assert g["shapes"]["net"][i] == (0,)
            else:
                assert g["shapes"]["net"][i] == shape
            for k in ("params", "ema", "mu", "nu"):
                assert g["shapes"][k][i] == tuple(want), (k, i)
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["metrics"] == got[1]["metrics"]
    cfg = dict(setup["mp_cfg"], distributed={},
               output={"output_dir": str(tmp_path / "one")})
    one = DDPMTrainer(DDPM(MODEL_CFG, device="cpu", seed=0, trainable=True),
                      *get_dataset(cfg, device="cpu"), cfg, seed=0)
    for chunk, (loss, norm) in zip(one._updates(one.train_loader),
                                   got[0]["metrics"]):
        m = one.accum_step(chunk)
        np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(norm, float(m["grad_norm"]), rtol=1e-4)
    for a, b in zip(got[0]["state"]["opt_state"]["mu"], one.optimizer.mu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-7)
    one.cleanup()


def test_model_parallel_checkpoint_restores_in_any_layout(two_ranks):
    """The checkpoint rank 0 wrote at (D=1, M=2) is one process's format:
    a world-1 trainer restores the ranks' gathered parameters, EMA, μ
    and ν bit for bit, and so did a (D=2, M=1) trainer and a new (D=1,
    M=2) one (each rank keeping its shards) on the two ranks."""
    results, setup = two_ranks
    state = results[0]["model_parallel"]["state"]
    assert results[1]["model_parallel"]["state"] is None
    gathered = ranks.state_digest(state)
    cfg = dict(setup["mp_cfg"], distributed={})
    one = DDPMTrainer(DDPM(MODEL_CFG, device="cpu", seed=7, trainable=True),
                      *get_dataset(cfg, device="cpu"), cfg, seed=0)
    assert one.load_checkpoint("mp") == 1 and one.step_count == 3
    assert ranks.replica_digest(one) == gathered
    assert train_cli.params_digest(one.params) == \
        results[0]["model_parallel"]["digest"]
    one.cleanup()
    for r in results:
        assert r["model_parallel"]["restored_dp"] == gathered
        assert r["model_parallel"]["restored_mp"] == gathered


def test_model_parallel_emergency_checkpoint_joins_the_shards(two_ranks,
                                                             tmp_path):
    """Under ``model_parallel: 2`` an exception in ``train()`` leaves an
    emergency checkpoint written with no collective, each rank's shards
    in a file of its own; a world-1 trainer restores from it the ranks'
    gathered parameters, EMA, μ and ν bit for bit, and a set with a
    shard missing is refused by name."""
    results, setup = two_ranks
    epoch, gathered = results[0]["model_parallel"]["emergency"]
    assert results[1]["model_parallel"]["emergency"] == (epoch, gathered)
    cfg = dict(setup["mp_cfg"], distributed={})
    one = DDPMTrainer(DDPM(MODEL_CFG, device="cpu", seed=7, trainable=True),
                      *get_dataset(cfg, device="cpu"), cfg, seed=0)
    name = f"emergency_checkpoint_epoch_{epoch}"
    written = one.ckpt.directory / name
    assert sorted(f.name for f in written.iterdir()) == [
        "shard_0_of_2.pt", "shard_1_of_2.pt"]
    one.load_checkpoint(name)
    assert one.step_count == 4
    assert ranks.replica_digest(one) == gathered
    one.cleanup()
    shutil.copy(written / "shard_1_of_2.pt", tmp_path)
    with pytest.raises(FileNotFoundError, match=r"shards \[0\] of 2"):
        read_state(str(tmp_path))
