"""Spatial parallelism's forward path (``parallel/spatial.py``) on the
CPU, at a small size (C=32, 32² and 64², T=8, B=2 or 4), in f32.

In one process: K1's split form in its plain versions (partial sums of 2
and 4 row blocks added, then the apply) and the three halo convs over 2
and 4 row blocks, each against the JAX package on the whole input; the
layout against JAX's ``make_mesh``, and the refusals.

On ranks, in one spawn (``torch_spatial_ranks.phases``): two gloo ranks
split each image's rows (``spatial_parallel: 2``) for the UNet's forward
at 32² and 64² (attention at 8² sharded), held against the JAX UNet's
jitted apply under its spatial mesh and against one process of the port;
``validate()``/``test()`` with dropout 0.1, DPM++-4 samples,
``train --benchmark``'s harness and the sample grid, each against one
process of the port; the refusals of a training update; then four ranks,
as one spatial group (S=4, dropout 0.1) and as D=2 data groups of S=2.
Last, the two faults repaired beside the slice: CelebA's JPEG path
against the reference's C++ loader, and the logged throughput of a
two-rank ``train()``.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_spatial_ranks as ranks
from diffusion_model_universal_tpu import native as jnative
from diffusion_model_universal_tpu.datasets import sources as jsrc
from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.models.layers import resnet as jresnet
from diffusion_model_universal_tpu.ops.group_norm import group_norm_silu_xla
from diffusion_model_universal_tpu.parallel.mesh import (
    activation_sharding_scope, make_mesh)
from diffusion_model_universal_torch import NOT_PORTED
from diffusion_model_universal_torch.datasets import sources as tsrc
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models.convert import (
    unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.models.layers.resnet import (
    Downsample, SplitConv, Upsample)
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.parallel import mesh, spatial
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.utils.benchmarks import SAMPLERS
from diffusion_model_universal_torch.utils.images import decode_png

torch.set_num_threads(2)

C, T, B = 32, 8, 4
MODEL_CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
             "in_channels": 3, "compute_dtype": "float32", "remat": False,
             "dropout": 0.1}
#: ``tests/test_torch_model.py::test_ddpm_apply_matches_jax``'s bound.
UNET_TOL = dict(atol=1e-4, rtol=1e-4)


def _config(tmp, spatial_parallel=1, **model):
    return {"model_name": "DDPM", "model_config": dict(MODEL_CFG, **model),
            "training": {"num_epochs": 1, "batch_size": B,
                         "learning_rate": 1e-3, "val_interval": 1000,
                         "sample_interval": 0, "checkpoint_interval": 0},
            # 50 images: 40 train, 5 val (a ragged tail of 1), 5 test.
            "data": {"dataset": "synthetic", "data_dir": "unused",
                     "num_samples": 50},
            "distributed": {"spatial_parallel": spatial_parallel},
            "benchmark": {"n_samples": 6, "batch_size": B,
                          "use_inception": False, "sampler": "dpm++",
                          "sampler_steps": 3},
            "logging": {"log_interval": 1, "track_time_metrics": True},
            "output": {"output_dir": str(tmp)}}


class _Blocks:
    """Row block ``index`` of ``size`` of the whole NCHW ``whole``, as a
    ``RowGroup`` gives it to a layer, in one process: its halos come from
    ``whole``."""

    def __init__(self, whole, index, size):
        self.whole, self.index, self.size = whole, index, size

    def rows(self, total):
        h = total // self.size
        return self.index * h, (self.index + 1) * h

    def halo(self, x, k):
        lo, hi = self.rows(self.whole.shape[2])
        padded = torch.nn.functional.pad(self.whole, (0, 0, k, k))
        return padded[:, :, lo:hi + 2 * k]

    def gather(self, x):
        return self.whole


# -- K1's split form and the halo convs, in one process ------------------

@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("variant", ["time_bias_silu", "split_skip",
                                     "no_silu"])
def test_split_group_norm_matches_jax(blocks, variant):
    """The plain split GroupNorm: each row block's partial sums
    (``gn_partial_sums_plain``, the time bias folded in at the block's
    rows) added in one process, then each block's apply
    (``gn_apply_sums_plain``), against ``group_norm_silu_xla`` on the
    whole x; the split-skip form normalizes the two halves of the
    virtual concat with their own groups, as ``GroupNormSiLU`` does."""
    rng = np.random.default_rng(blocks)
    c, g, skip_c = 64, 32, (64 if variant == "split_skip" else 0)
    x = rng.standard_normal((2, 16, 8, c)).astype(np.float32) * 2 + 0.5
    s = rng.standard_normal((2, 16, 8, skip_c)).astype(np.float32)
    tb = rng.standard_normal((2, c + skip_c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c + skip_c).astype(np.float32)
    bias = rng.standard_normal(c + skip_c).astype(np.float32)
    silu = variant != "no_silu"
    tbias = None if variant == "no_silu" else tb
    whole = np.concatenate([x, s], -1) if skip_c else x
    want = np.asarray(group_norm_silu_xla(
        jnp.asarray(whole), jnp.asarray(scale), jnp.asarray(bias), g,
        None if tbias is None else jnp.asarray(tbias), apply_silu=silu))
    gs = (c + skip_c) // g
    halves = [(x, slice(0, c))] + ([(s, slice(c, c + skip_c))]
                                   if skip_c else [])
    got = []
    for part, ch in halves:
        t = torch.from_numpy(part)
        tbh = None if tbias is None else torch.from_numpy(tbias[:, ch])
        cuts = t.chunk(blocks, dim=1)
        sums = sum(gn_ops.gn_partial_sums_plain(r, tbh) for r in cuts)
        got.append(torch.cat([gn_ops.gn_apply_sums_plain(
            r, sums, torch.from_numpy(scale[ch]), torch.from_numpy(bias[ch]),
            part.shape[-1] // gs, 16 * 8, tbh, apply_silu=silu)
            for r in cuts], dim=1))
    np.testing.assert_allclose(torch.cat(got, -1).numpy(), want, atol=1e-5,
                               rtol=1e-5)


def _conv_case(kind):
    """(JAX module, port module, the port's state-dict prefix)."""
    if kind == "conv3x3":
        import flax.linen as nn
        return (nn.Conv(24, (3, 3), padding="SAME", use_bias=True,
                        name="conv1"), SplitConv(16, 24, 3, bias=True), "")
    if kind == "down":
        return jresnet.Downsample(16, conv_bias=True), \
            Downsample(16, conv_bias=True), ""
    return jresnet.Upsample(16, conv_bias=True), \
        Upsample(16, conv_bias=True), "up"


@functools.lru_cache(maxsize=None)
def _conv_reference(kind):
    """(input, perturbed JAX parameters, the JAX module's output)."""
    jmod, _, _ = _conv_case(kind)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 12, 16)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        shapes)
    return x, params, np.asarray(jax.jit(jmod.apply)({"params": params},
                                                     jnp.asarray(x)))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", ["conv3x3", "down", "up"])
def test_halo_convs_match_jax(kind, size):
    """The 3×3 SAME conv, the 4×4 stride-2 down conv and the 4×4 stride-2
    transposed up conv, each on 2 and 4 row blocks of a 16-row input with
    its halo rows (zero rows at the image's edges), the blocks' outputs
    stacked, against the JAX module on the whole input; the up conv's
    output cropped to each block's 2·h rows."""
    _, tmod, prefix = _conv_case(kind)
    x, params, want = _conv_reference(kind)
    tree = {prefix: params} if prefix else (
        {"conv1": params} if kind == "conv3x3" else params)
    state = {k.removeprefix(prefix + ".") if prefix else
             k.removeprefix("conv1."): v
             for k, v in unet_state_dict_from_jax(tree).items()}
    tmod.load_state_dict(state, strict=True)
    whole = torch.from_numpy(x).permute(0, 3, 1, 2)
    outs = []
    with torch.no_grad():
        for i in range(size):
            group = _Blocks(whole, i, size)
            lo, hi = group.rows(16)
            with spatial.split(group):
                outs.append(tmod(whole[:, :, lo:hi]))
    got = torch.cat(outs, dim=2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# -- the layout and the refusals --------------------------------------------

@pytest.mark.parametrize("devices,spatial_parallel", [(2, 2), (4, 2),
                                                      (4, 4)])
def test_layout_matches_jax_mesh(devices, spatial_parallel):
    """``make_layout`` gives JAX's mesh shape, and each rank's data and
    spatial index are its device's place in JAX's mesh (rank = d·S + s)."""
    jmesh = make_mesh(jax.devices()[:devices],
                      spatial_parallel=spatial_parallel)
    layout = mesh.make_layout(devices, spatial_parallel=spatial_parallel)
    assert layout == dict(jmesh.shape)
    ids = [d.id for d in jax.devices()[:devices]]
    for r in range(devices):
        d, s, m = map(int, np.argwhere(
            np.vectorize(lambda dev: dev.id)(jmesh.devices) == ids[r])[0])
        assert (mesh.data_index(r, layout), mesh.spatial_index(r, layout),
                m) == (d, s, 0)


@pytest.mark.parametrize("case", ["with_model_parallel", "training",
                                  "height"])
def test_spatial_refusals(tmp_path, request, case):
    """Refused before any rank starts, by the CLI: S with M (its message
    names the next slice), training under S (likewise; the eval path
    runs; on the ranks a trainer under S=2 refuses ``step`` and
    ``train``, naming the next slice), and a sharded height that S does
    not divide (named)."""
    cfg = _config(tmp_path / "run", 2)
    args, devices = ["--eval_only"], 2
    if case == "with_model_parallel":
        cfg["distributed"]["model_parallel"] = 2
        devices = 4
        with pytest.raises(ValueError, match=re.escape(
                spatial.NEXT_SLICE)):
            mesh.make_layout(4, model_parallel=2, spatial_parallel=2)
        said = "distributed: distributed.spatial_parallel 2 with " \
               "model_parallel 2"
    elif case == "training":
        args = []
        said = (f"distributed: training under spatial_parallel 2 is "
                f"{NOT_PORTED}: {spatial.NEXT_SLICE}")
        results, _ = request.getfixturevalue("spawned")
        for r in (0, 1):
            for got in results[r]["refusals"].values():
                assert got is not None and spatial.NEXT_SLICE in got
    else:
        cfg["distributed"]["spatial_parallel"] = devices = 16
        said = ("distributed.spatial_parallel 16 does not divide the "
                "sharded height 8 of a 32² UNet")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(SystemExit, match=re.escape(said)):
        train_cli.main(["--config", str(path), "--model_type", "ddpm",
                        "--device", "cpu", "--num_devices", str(devices),
                        *args])
    assert not (tmp_path / "run").exists()


# -- ranks ------------------------------------------------------------------

def _weights(size):
    """A seeded C=32 UNet's state, perturbed so every leaf contributes."""
    model = DDPM(dict(MODEL_CFG, image_size=size), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.net.state_dict()


def _forward_inputs(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.tensor([1, 6])


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank scenario of this module in one spawn of four gloo ranks:
    a phase of two ranks (S=2), then one of four (S=4, and S=2 over D=2):
    (each rank's {scenario: result}, the inputs)."""
    tmp = tmp_path_factory.mktemp("spatial_ranks")
    setup = {"weights": {s: _weights(s) for s in (32, 64)},
             "images": torch.from_numpy(np.clip(np.random.default_rng(
                 5).normal(size=(8, 32, 32, 3)), -1, 1).astype(np.float32))}
    cfg2, cfg4 = _config(tmp / "s2", 2), _config(tmp / "s4", 4)
    cfg_d2 = _config(tmp / "d2", 2, dropout=0.0)
    cfg64 = _config(tmp / "s64", 2, image_size=64)
    tput = dict(_config(tmp / "tput"), distributed={})
    w32 = setup["weights"][32]
    setup.update(cfg2=cfg2, cfg4=cfg4, cfg_d2=cfg_d2, tput=tput)
    two = [("unet32", "unet_forward", (cfg2, w32, *_forward_inputs(32))),
           ("unet64", "unet_forward", (cfg64, setup["weights"][64],
                                       *_forward_inputs(64))),
           ("validate", "validate", (cfg2, w32)),
           ("dpm", "dpm_sample", (cfg2, w32, B, 4)),
           ("grid", "grid", (cfg2, w32)),
           ("refusals", "refusals", (cfg2,)),
           ("throughput", "throughput", (tput, 2))]
    four = [("validate4", "validate", (cfg4, w32)),
            ("validate_d2", "validate", (cfg_d2, w32)),
            ("benchmark_d2", "benchmark", (cfg_d2, w32, setup["images"])),
            ("dpm_d2", "dpm_sample", (cfg_d2, w32, B + 1, 4))]
    try:
        rc = mesh.spawn(ranks.phases, 4, args=(str(tmp), [(2, two),
                                                          (4, four)]),
                        device_type="cpu", rendezvous_dir=str(tmp))
    except RuntimeError as e:
        said = [f"rank {r}:\n{p.read_text()}" for r in range(4)
                for p in [tmp / f"rank{r}.err"] if p.exists()]
        raise AssertionError("\n".join([str(e), *said])) from e
    assert rc == 0
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)], setup


def _one_process(cfg, state=None):
    model = DDPM(cfg["model_config"], device="cpu", seed=0, trainable=True)
    if state is not None:
        model.net.load_state_dict(state)
    from diffusion_model_universal_torch.datasets import get_dataset
    return DDPMTrainer(model, *get_dataset(dict(cfg, distributed={}),
                                           device="cpu"),
                       dict(cfg, distributed={}), seed=0)


@pytest.mark.parametrize("size", [32, 64])
def test_unet_two_ranks_match_jax(spawned, size):
    """Two ranks' UNet forward (rows split from 32 (64) down to 8 rows;
    at 64² ``down3``'s attention at 8² sharded) against the JAX UNet's
    jitted apply on the same converted weights under
    ``activation_sharding_scope`` of a (1, 2, 1) mesh, and against one
    process of the port: both ranks return the whole images."""
    results, setup = spawned
    x, t = _forward_inputs(size)
    cfg = dict(MODEL_CFG, image_size=size)
    params = unet_params_to_jax(_one(cfg, setup["weights"][size]).net)
    jm = JaxDDPM(cfg)
    with activation_sharding_scope(make_mesh(jax.devices()[:2],
                                             spatial_parallel=2)):
        want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x.numpy()),
                                            jnp.asarray(t.numpy())))
    with torch.no_grad():
        one = _one(cfg, setup["weights"][size]).net(x, t)
    for r in (0, 1):
        got = results[r][f"unet{size}"]["out"]
        np.testing.assert_allclose(got.numpy(), want, **UNET_TOL)
        np.testing.assert_allclose(got.numpy(), one.numpy(), **UNET_TOL)


def _one(cfg, state):
    model = DDPM(cfg, device="cpu", seed=0)
    model.net.load_state_dict(state)
    return model


@pytest.mark.parametrize("case", ["validate_2_ranks", "validate_4_ranks",
                                  "validate_2x2_ranks", "dpm_samples",
                                  "benchmark_2x2", "sample_grid"])
def test_ranks_match_one_process(spawned, case):
    """Against one process of the port: ``validate()`` and ``test()`` at
    S=2 and S=4 with dropout 0.1 (the group draws its masks as one
    process, seeded by its data index; the perturbed weights give the
    zero-initialized ``conv2`` after the dropout values, so the masks
    reach the loss) and at D=2 × S=2 (dropout 0: each data group's
    samples counted once); DPM++-4 samples (every rank of a
    group holds its data group's rows whole); ``--benchmark``'s scores
    (the harness gathers each data group's images once); the sample grid
    rank 0 writes."""
    results, setup = spawned
    w32 = setup["weights"][32]
    if case.startswith("validate"):
        key, cfg = {"validate_2_ranks": ("validate", setup["cfg2"]),
                    "validate_4_ranks": ("validate4", setup["cfg4"]),
                    "validate_2x2_ranks": ("validate_d2", setup["cfg_d2"])
                    }[case]
        tr = _one_process(cfg, w32)
        want = {"val": tr.validate(), "test": tr.test()}
        tr.cleanup()
        for r in range(4 if key != "validate" else 2):
            for k in want:
                np.testing.assert_allclose(results[r][key][k], want[k],
                                           rtol=1e-5)
    elif case == "dpm_samples":
        for key, n, world in (("dpm", B, 2), ("dpm_d2", B + 1, 4)):
            tr = _one_process(setup["cfg2"], w32)
            want = getattr(tr.model, SAMPLERS["dpm++"])(
                n, num_steps=4, generator=torch.Generator().manual_seed(3))
            tr.cleanup()
            for r in range(world):
                lo, hi, _ = results[r][key]["rows"]
                np.testing.assert_allclose(results[r][key]["images"],
                                           want[lo:hi], **UNET_TOL)
    elif case == "benchmark_2x2":
        key, cfg = "benchmark_d2", setup["cfg_d2"]
        tr = _one_process(cfg, w32)
        want = train_cli.run_benchmark(tr, cfg, [setup["images"]], True,
                                       mesh.sampling_scope())
        tr.cleanup()
        got = results[0][key]["results"]
        assert set(got) == set(want) == {"fid", "is_mean", "is_std", "ssim",
                                         "psnr"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=1e-5)
        assert all(results[r][key]["results"] is None for r in (1, 2, 3))
    else:
        tr = _one_process(setup["cfg2"], w32)
        with open(tr.generate_samples(0), "rb") as f:
            want = decode_png(f.read())
        tr.cleanup()
        got = decode_png(results[0]["grid"]["png"])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert "png" not in results[1]["grid"]


# -- the repairs ------------------------------------------------------------

def test_celeba_jpeg_path_matches_the_native_loader(tmp_path):
    """CelebA's JPEG path equals the reference's default path byte for
    byte: its C++ loader's center crop and bilinear shrink (loaded here),
    on textured 178×218 JPEGs made from a seed."""
    from PIL import Image
    assert jnative._load() is not None, "the reference's loader must load"
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        yy, xx = np.mgrid[0:218, 0:178].astype(np.float32)
        arr = (rng.integers(0, 256, (218, 178, 3)) * 0.6 + 50 * np.stack(
            [np.sin(xx / 3.0 + i), np.cos(yy / 5.0), np.sin((xx - yy) / 2.0)],
            -1) + 40).clip(0, 255).astype(np.uint8)
        paths.append(tmp_path / f"{i:06d}.jpg")
        Image.fromarray(arr).save(paths[-1], quality=95)
    got = tsrc.decode_jpegs_crop_resize(paths, 178, 64, num_threads=2)
    want = jsrc.decode_jpegs_crop_resize(paths, 178, 64, num_threads=2)
    np.testing.assert_array_equal(got, want)


def test_throughput_counts_the_global_batch(spawned):
    """Under ``--num_devices 2`` each rank's batch holds 2 of the global
    4 rows; the logged samples/s rests on the global batch, as the
    reference's one-process ``--num_devices`` counts it."""
    results, _ = spawned
    counts = results[0]["throughput"]["counts"]
    assert len(counts) == 2
    np.testing.assert_allclose(counts, B, rtol=1e-6)
