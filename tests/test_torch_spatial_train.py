"""Spatial parallelism's backward half (training under
``distributed.spatial_parallel`` S > 1) on the CPU, at a small size
(C=32, 32², T=8, B=2 or 4), in f32.

In one process: K2's split form (c) and (d) in their plain versions on 2
and 4 row blocks (the blocks' (c) sums added, then each block's (d))
against the gradient of JAX's ``group_norm_silu_xla`` on the whole input;
the layout and scan checks that admit training under S.

On ranks, in one spawn (``torch_spatial_ranks.phases``; two ranks, then
four): the transposes of ``slice``, ``halo`` and ``gather`` through the
3×3, down (halo and gathered) and up convs against the vjp of the JAX
modules on the whole input; training updates at S=2 and S=4 and at D=2 ×
S=2 (remat on and off, dropout 0.1, ``grad_accum_steps: 2``, the score
and energy families, ``scan_steps: 2``, ``train``'s rank body with a
checkpoint and a resume) against one process of the port; one S=2 update
against JAX's ``DDPMTrainer.step`` under its spatial mesh. The JAX step
is compiled while the ranks run, and ranks 2 and 3 compute the
one-process references while ranks 0 and 1 run S=2.

Tolerances (``tests/test_torch_train.py::
test_training_step_matches_jax_trainer``'s): loss rtol 1e-5; gradient
norms rtol 1e-4 (+ 1e-8 abs: at C=32 a group is one channel, so the
time bias cancels and its projection's gradient is f32 noise of ~1e-8);
Adam's moments rtol 1e-3 (+ 1e-7 abs for μ, 1e-12 for ν). Updates after
the first use lr 1e-6, so that a first Adam step's ±lr on a weight whose
gradient is near zero (and may flip sign) does not move the next one.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_ranks as ranks
from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.models.layers import resnet as jresnet
from diffusion_model_universal_tpu.ops.group_norm import group_norm_silu_xla
from diffusion_model_universal_tpu.parallel.mesh import make_mesh
from diffusion_model_universal_tpu.trainers import DDPMTrainer as JaxTrainer
from diffusion_model_universal_torch.models import MODEL_REGISTRY
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.parallel import mesh
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.trainers.scan import scan_refusal
from diffusion_model_universal_torch.utils.checkpoint import \
    CheckpointManager
from diffusion_model_universal_torch.utils.images import decode_png

torch.set_num_threads(2)

C, T = 32, 8
DDPM_CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
            "in_channels": 3, "compute_dtype": "float32", "remat": True,
            "dropout": 0.1}
SCORE_CFG = {"model_channels": C, "image_size": 32, "in_channels": 3,
             "compute_dtype": "float32", "num_scales": 4, "remat": True,
             "dropout": 0.1}
ENERGY_CFG = {"model_channels": 8, "num_timesteps": 3, "image_size": 32,
              "in_channels": 3, "compute_dtype": "float32",
              "langevin_steps": 2, "langevin_step_size": 0.1,
              "regularization_weight": 0.5}
#: ``tests/test_torch_train.py``'s JAX-compared step: dropout 0, no remat.
JAX_CFG = dict(DDPM_CFG, remat=False, dropout=0.0)
JAX_B, LR = 4, 1e-3
NAMES = {"ddpm": "DDPM", "score_based": "ScoreBasedDiffusion",
         "energy_based": "EnergyBasedDiffusion"}
LOSS_RTOL, NORM_TOL, MU_TOL = 1e-5, dict(rtol=1e-4, atol=1e-8), \
    dict(rtol=1e-3, atol=1e-7)
#: Seconds after which a rank that waits on a collective no peer joins
#: dumps its tracebacks and exits (the spawn takes about 30 s alone).
RANKS_TIMEOUT = 600


def _config(tmp, family, model, spatial_parallel=1, **training):
    return {"model_name": NAMES[family], "model_config": model,
            "training": {"num_epochs": 1, "batch_size": 2,
                         "learning_rate": LR, "grad_clip": 1.0,
                         "ema_decay": 0.999, "val_interval": 0,
                         "sample_interval": 0, "checkpoint_interval": 0,
                         **training},
            # 5 images: 4 train (2 updates an epoch), 1 val, 1 test.
            "data": {"dataset": "synthetic", "data_dir": "unused",
                     "num_samples": 5},
            "distributed": ({"spatial_parallel": spatial_parallel}
                            if spatial_parallel > 1 else {}),
            "logging": {"log_interval": 1},
            "output": {"output_dir": str(tmp)}}


def _perturbed(family, model_cfg, seed):
    """The family's seeded network, perturbed so every leaf contributes
    (the zero-initialized ``conv2`` after each dropout and ``time_proj``
    included)."""
    model = MODEL_REGISTRY[family](model_cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model.net.state_dict()


def _images(seed, b=2):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(rng.normal(size=(b, 32, 32, 3)), -1,
                                    1).astype(np.float32))


#: (scenario, family, model config, S, world, training options, batches,
#: mode) of the updates held against one process.
def _updates():
    lr = {"learning_rate": 1e-6}
    return [
        ("ddpm_s2", "ddpm", DDPM_CFG, 2, 2, {}, 1, "accum"),
        ("accum_s2", "ddpm", dict(DDPM_CFG, remat=False), 2, 2,
         {"grad_accum_steps": 2}, 2, "accum"),
        ("score_s2", "score_based", SCORE_CFG, 2, 2, {}, 1, "accum"),
        ("energy_s2", "energy_based", ENERGY_CFG, 2, 2, {}, 1, "accum"),
        ("scan_s2", "ddpm", DDPM_CFG, 2, 2, {"scan_steps": 2, **lr}, 2,
         "scan"),
        ("ddpm_s4", "ddpm", DDPM_CFG, 4, 4, {}, 1, "accum"),
        # Two data groups draw their own dropout masks: dropout 0.
        ("ddpm_d2s2", "ddpm", dict(DDPM_CFG, dropout=0.0), 2, 4, {}, 1,
         "accum")]


# -- K2's split form, in one process -------------------------------------

@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("variant", ["time_bias_silu", "split_skip",
                                     "no_silu"])
def test_split_group_norm_grads_match_jax(blocks, variant):
    """The plain split backward: the forward's sums of the row blocks
    added (K1's split form (a)), each block's (c) sums added, then each
    block's (d); dx stacked and dγ, dβ, dtb summed over the blocks against
    the vjp of ``group_norm_silu_xla`` on the whole x (the split-skip form
    normalizes the two halves of the virtual concat with their own
    groups, as ``GroupNormSiLU`` does). f32, 1e-5 abs + rel."""
    rng = np.random.default_rng(10 + blocks)
    c, g, skip_c = 64, 32, (64 if variant == "split_skip" else 0)
    x = rng.standard_normal((2, 16, 8, c)).astype(np.float32) * 2 + 0.5
    s = rng.standard_normal((2, 16, 8, skip_c)).astype(np.float32)
    tb = rng.standard_normal((2, c + skip_c)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c + skip_c).astype(np.float32)
    bias = rng.standard_normal(c + skip_c).astype(np.float32)
    silu = variant != "no_silu"
    tbias = None if variant == "no_silu" else tb
    whole = np.concatenate([x, s], -1) if skip_c else x
    dy = rng.standard_normal(whole.shape).astype(np.float32)

    def fwd(xx, sc, bi, t):
        return group_norm_silu_xla(xx, sc, bi, g, t, apply_silu=silu)

    args = [jnp.asarray(whole), jnp.asarray(scale), jnp.asarray(bias)]
    if tbias is not None:
        args.append(jnp.asarray(tbias))
        _, vjp = jax.vjp(fwd, *args)
    else:
        _, vjp = jax.vjp(lambda a, b_, c_: fwd(a, b_, c_, None), *args)
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    gs = (c + skip_c) // g
    halves = [(x, slice(0, c))] + ([(s, slice(c, c + skip_c))]
                                   if skip_c else [])
    got = {"dx": [], "dscale": [], "dbias": [], "dtb": []}
    for part, ch in halves:
        t = torch.from_numpy(part)
        tbh = None if tbias is None else torch.from_numpy(tbias[:, ch])
        sc, bi = torch.from_numpy(scale[ch]), torch.from_numpy(bias[ch])
        d = torch.from_numpy(dy[..., ch])
        cuts, dcuts = t.chunk(blocks, dim=1), d.chunk(blocks, dim=1)
        groups, count = part.shape[-1] // gs, 16 * 8
        sums = sum(gn_ops.gn_partial_sums_plain(r, tbh) for r in cuts)
        args_ = (sc, bi, groups, count, tbh)
        grad_sums = [gn_ops.gn_bwd_partial_sums_plain(r, dr, sums, *args_,
                                                      apply_silu=silu)
                     for r, dr in zip(cuts, dcuts)]
        summed = sum(grad_sums)
        outs = [gn_ops.gn_bwd_apply_sums_plain(r, dr, sums, gsum, summed,
                                               *args_, apply_silu=silu)
                for r, dr, gsum in zip(cuts, dcuts, grad_sums)]
        got["dx"].append(torch.cat([o[0] for o in outs], dim=1))
        for i, k in ((1, "dscale"), (2, "dbias"), (3, "dtb")):
            if outs[0][i] is not None:
                got[k].append(sum(o[i] for o in outs))
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.cat(got["dx"], -1).numpy(), want[0],
                               **tol)
    np.testing.assert_allclose(torch.cat(got["dscale"]).numpy(), want[1],
                               **tol)
    np.testing.assert_allclose(torch.cat(got["dbias"]).numpy(), want[2],
                               **tol)
    if tbias is not None:
        np.testing.assert_allclose(torch.cat(got["dtb"], -1).numpy(),
                                   want[3], **tol)


# -- the layout and scan_steps under S ------------------------------------

def test_layout_admits_training_under_s(tmp_path):
    """``train``'s layout check takes a training run under S (the height
    and batch checks stay); ``scan_steps`` > 1 under S runs on the CPU
    (eagerly) and is refused on CUDA, by name over NCCL and by the gloo
    refusal over gloo."""
    cfg = _config(tmp_path, "ddpm", DDPM_CFG, 2)
    assert train_cli.check_layout(cfg, 4) == {
        mesh.DATA_AXIS: 2, mesh.SPATIAL_AXIS: 2, mesh.MODEL_AXIS: 1}
    assert scan_refusal(2, "cpu", "gloo", 1, 2) is None
    said = scan_refusal(2, "cuda", "nccl", 1, 2)
    assert "spatial_parallel" in said and "later slice" in said
    assert "gloo" in scan_refusal(2, "cuda", "gloo", 1, 2)


# -- ranks -------------------------------------------------------------------

def _layer_case(kind):
    """(JAX module, the port's state-dict prefix, input rows)."""
    if kind == "conv3x3":
        import flax.linen as nn
        return nn.Conv(24, (3, 3), padding="SAME", use_bias=True,
                       name="conv1"), "", 16
    if kind in ("down", "down_gathered"):
        return jresnet.Downsample(16, conv_bias=True), "", (
            16 if kind == "down" else 8)
    return jresnet.Upsample(16, conv_bias=True), "up", 16


def _port_tree(kind, tree):
    """The port's state dict of a JAX (gradient) tree of ``kind``."""
    prefix = _layer_case(kind)[1]
    wrapped = {prefix: tree} if prefix else (
        {"conv1": tree} if kind == "conv3x3" else tree)
    return {k.removeprefix(prefix + ".") if prefix else
            k.removeprefix("conv1."): v
            for k, v in unet_state_dict_from_jax(wrapped).items()}


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _layer_inputs(kind):
    """(NHWC input, JAX parameters, cotangent) of a layer test."""
    jmod, _, rows = _layer_case(kind)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, rows, 12, 16)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        shapes)
    out = jax.eval_shape(lambda p, xx: jmod.apply({"params": p}, xx),
                         params, jnp.asarray(x))
    return x, params, rng.standard_normal(out.shape).astype(np.float32)


def _layer_vjp(kind, x, params, cot):
    """The JAX module's gradients of the input (NCHW) and of the port's
    weights."""
    jmod = _layer_case(kind)[0]
    _, vjp = jax.vjp(lambda p, xx: jmod.apply({"params": p}, xx), params,
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(cot))
    return _nchw(dx), _port_tree(kind, jax.tree_util.tree_map(np.asarray,
                                                              dparams))


LAYERS = ("conv3x3", "down", "down_gathered", "up")


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank scenario of this module in one spawn of four gloo ranks:
    a phase of two (S=2) in which ranks 2 and 3, outside the group, run
    the one-process references, then one of four. The spawn runs in a
    thread while this process builds and compiles the JAX step and takes
    the JAX layers' vjps. Returns (each rank's {scenario: result}, the
    JAX references)."""
    tmp = tmp_path_factory.mktemp("spatial_train")
    weights = {"ddpm": _perturbed("ddpm", DDPM_CFG, 4),
               "score_based": _perturbed("score_based", SCORE_CFG, 5),
               "energy_based": None}
    images = [_images(20 + i) for i in range(2)]
    plan = {2: [], 4: []}
    solo = {2: [], 3: []}
    layers = {k: _layer_inputs(k) for k in LAYERS}
    for kind, (x, params, cot) in layers.items():
        for world in (2, 4):
            plan[world].append((f"layer_{kind}_{world}", "layer_grads", (
                kind, _port_tree(kind, params), _nchw(x), _nchw(cot))))
    for i, (name, family, model, s, world, training, n, mode) in enumerate(
            _updates()):
        batches = images[:n]
        plan[world].append((name, "update", (
            _config(tmp / name, family, model, s, **training), family,
            weights[family], batches, mode)))
        solo[2 + i % 2].append((f"{name}_one", "update", (
            _config(tmp / f"{name}_1", family, model, 1, **training),
            family, weights[family], batches, mode)))
    argv = ["--config", "unused", "--model_type", "ddpm", "--device", "cpu"]
    for s, where in ((2, plan[2]), (1, solo[3])):
        where.append((f"resume_{s}", "train_resume", (
            _config(tmp / f"resume_{s}", "ddpm", DDPM_CFG, s,
                    checkpoint_interval=1, sample_interval=1,
                    learning_rate=1e-6), argv)))

    # The JAX step (test_torch_train's) on the port's weights, perturbed,
    # with the t and noise JAX draws from its step key (the key
    # ``_step_key(0)`` makes, checked below).
    jparams = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32) + 0.05 * np.random.default_rng(
            1).standard_normal(p.shape).astype(np.float32),
        unet_params_to_jax(MODEL_REGISTRY["ddpm"](
            JAX_CFG, device="cpu", seed=3).net))
    jx = _images(6, JAX_B)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    kt, kn, _ = jax.random.split(key, 3)
    draws = {"t": torch.from_numpy(np.array(jax.random.randint(
                 kt, (JAX_B,), 0, T))),
             "noise": torch.from_numpy(np.array(jax.random.normal(
                 kn, jx.shape, jnp.float32)))}
    jcfg = {"model_name": "DDPM", "model_config": JAX_CFG,
            "training": {"num_epochs": 2, "batch_size": JAX_B,
                         "learning_rate": LR, "ema_decay": 0.999,
                         "grad_clip": 1.0, "skip_nonfinite_updates": 3,
                         "scheduler": {"type": "cosine", "min_lr": 1e-6}},
            "logging": {"log_interval": 1},
            "output": {"output_dir": str(tmp / "jax")}}
    pcfg = copy.deepcopy(jcfg)
    pcfg.update(distributed={"spatial_parallel": 2},
                output={"output_dir": str(tmp / "jax_s2")})
    plan[2].append(("jax_s2", "update", (
        pcfg, "ddpm", unet_state_dict_from_jax(jparams), [jx], "accum",
        [draws])))

    outcome = []

    def spawn():
        try:
            outcome.append(mesh.spawn(
                ranks.phases, 4, args=(str(tmp), [(2, plan[2], solo),
                                                  (4, plan[4])],
                                       RANKS_TIMEOUT),
                device_type="cpu", rendezvous_dir=str(tmp)))
        except BaseException as e:   # raised below, with the ranks' errors
            outcome.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    try:
        jmodel = JaxDDPM(JAX_CFG)
        jmodel.init_params = lambda rng: jax.tree_util.tree_map(
            jnp.asarray, jparams)
        jtr = JaxTrainer(jmodel, [None] * 5, None, None, jcfg,
                         mesh=make_mesh(jax.devices()[:2],
                                        spatial_parallel=2), seed=0)
        assert np.array_equal(jax.random.key_data(jtr._step_key(0)),
                              jax.random.key_data(key))
        refs = {"jax": {"metrics": jax.device_get(jtr.step(jnp.asarray(
                    jx.numpy()))), "params": jparams},
                "layers": {k: _layer_vjp(k, *v) for k, v in layers.items()}}
        refs["jax"]["state"] = jax.device_get(jtr.state)
        jtr.cleanup()
    finally:
        thread.join()
    if isinstance(outcome[0], BaseException):
        said = [f"rank {r}:\n{p.read_text()}" for r in range(4)
                for p in [tmp / f"rank{r}.err", tmp / f"rank{r}.hang"]
                if p.exists() and p.stat().st_size]
        raise AssertionError("\n".join([str(outcome[0]), *said])) \
            from outcome[0]
    assert outcome == [0]
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
               for r in range(4)]
    for u in _updates():      # the one-process references
        refs[u[0]] = next(res[f"{u[0]}_one"] for res in results[2:]
                          if f"{u[0]}_one" in res)
    refs["tmp"] = tmp
    refs["resume"] = {s: CheckpointManager(str(tmp / f"resume_{s}" /
                                               "checkpoints"))
                      .restore("final_model") for s in (1, 2)}
    return results, refs


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("kind", LAYERS)
def test_split_layer_grads_match_jax(spawned, kind, size):
    """Σ out·cot over each rank's rows of the 3×3 SAME conv, the 4×4
    stride-2 down conv (halo rows; and from 8 rows, whose output of 4 is
    computed whole from the gathered input) and the transposed up conv,
    their input's rows split over 2 and 4 ranks: the input's gradient
    summed over the ranks (each rank's zero outside its rows: ``slice``'s
    transpose, with the halo rows' gradients sent back to their owners
    and the gathered input's summed over the group) and the weights'
    summed over the ranks, against the vjp of the JAX module on the whole
    input. f32: the input's 1e-5 abs + rel; the weights' (sums of
    B·H·W products, up to ~40 here, in other orders) 1e-6 of the
    largest + 1e-5 rel."""
    results, refs = spawned
    want_x, want_w = refs["layers"][kind]
    got = [results[r][f"layer_{kind}_{size}"] for r in range(size)]
    np.testing.assert_allclose(sum(g["x"] for g in got).numpy(),
                               want_x.numpy(), atol=1e-5, rtol=1e-5)
    for name, w in want_w.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            sum(g["weights"][name] for g in got).numpy(), w, err_msg=name,
            atol=1e-6 * np.abs(w).max(), rtol=1e-5)


def _hold_state(got, want, names):
    for key, tol in (("mu", MU_TOL), ("nu", dict(rtol=1e-3, atol=1e-12))):
        for n, a, b in zip(names, got[key], want[key]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=n,
                                       **tol)


@pytest.mark.parametrize("case", [u[0] for u in _updates()])
def test_update_matches_one_process(spawned, case):
    """An update on the ranks (each a data group's rows of the global
    batch, its images' rows split over a spatial group) against one
    process of the port on the same weights and batch: the loss, the
    global and per-layer gradient norms, and Adam's moments after it, on
    every rank. DDPM with remat and dropout 0.1 at S=2 and 4 (the
    group's whole masks replayed by the recompute), at D=2 × S=2, without
    remat over two micro-batches; the σ-UNet (score family); the
    EnergyNet, whose S ranks compute the whole gradient (counted once);
    a chunk of ``scan_steps: 2`` (eager on the CPU: its two losses)."""
    results, refs = spawned
    want = refs[case]
    world = next(u[4] for u in _updates() if u[0] == case)
    for r in range(world):
        got = results[r][case]
        np.testing.assert_allclose(got["loss"].numpy(), want["loss"].numpy(),
                                   rtol=LOSS_RTOL)
        if "grad_norm" in want:
            np.testing.assert_allclose(float(got["grad_norm"]),
                                       float(want["grad_norm"]), **NORM_TOL)
            np.testing.assert_allclose(got["layer_grad_norms"].numpy(),
                                       want["layer_grad_norms"].numpy(),
                                       **NORM_TOL)
        _hold_state(got, want, want["names"])


def test_train_resume_matches_one_process(spawned):
    """``train``'s rank body at S=2 for an epoch of two updates with its
    checkpoint and sample grid (drawn by both ranks of the group), then
    resumed from it for a second (lr 1e-6): the final checkpoint rank 0
    writes (step, parameters, EMA, Adam's moments) against one
    process's (``train``'s ``run``), and the grids alike."""
    _, refs = spawned
    got, want = refs["resume"][2], refs["resume"][1]
    for epoch in (0, 1):
        grids = [decode_png((refs["tmp"] / f"resume_{s}" / "samples" /
                             f"epoch_{epoch}.png").read_bytes())
                 for s in (2, 1)]
        assert np.abs(grids[0].astype(int) - grids[1].astype(int)).max() \
            <= 1
    assert got["step"] == want["step"] == 4
    assert got["epoch"] == want["epoch"] == 1
    for key in ("params", "ema_params"):
        for n, v in want[key].items():
            np.testing.assert_allclose(got[key][n].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=n)
    _hold_state(got["opt_state"], want["opt_state"], list(want["params"]))


def test_update_matches_jax_trainer(spawned):
    """One S=2 update of the port (each rank its rows of every image)
    against JAX's ``DDPMTrainer.step`` under ``make_mesh(jax.devices()[:2],
    spatial_parallel=2)`` on the same weights, batch and the t and noise
    JAX draws from its step key, with
    ``test_training_step_matches_jax_trainer``'s tolerances: loss rtol
    1e-5, gradient norms rtol 1e-4, μ and ν rtol 1e-3, the update p1 − p0
    and the EMA's move 1e-3·lr where |g| > 1e-5 and 2·lr elsewhere."""
    results, refs = spawned
    jm, state, p0 = (refs["jax"][k] for k in ("metrics", "state", "params"))
    net = MODEL_REGISTRY["ddpm"](JAX_CFG, device="cpu", seed=3).net
    leaves = jax.tree_util.tree_leaves

    def adam(name):
        return [np.asarray(leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(state.opt_state)[0]
                if any(getattr(k, "name", None) == name for k in path)]

    for r in (0, 1):
        got = results[r]["jax_s2"]

        def tree(tensors):
            return state_dict_to_jax(net, dict(zip(got["names"], tensors)))
        np.testing.assert_allclose(float(got["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        norms = tree([torch.full(p.shape, float(v)) for p, v in
                      zip(got["params"], got["layer_grad_norms"])])
        np.testing.assert_allclose(
            [a.flat[0] for a in leaves(norms)],
            [float(v) for v in leaves(jm["layer_grad_norms"])],
            rtol=1e-4, atol=1e-8)
        for name, atol in (("mu", 1e-7), ("nu", 1e-12)):
            ours, theirs = leaves(tree(got[name])), adam(name)
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                np.testing.assert_allclose(a, b, rtol=1e-3, atol=atol)
        mu = adam("mu")
        for ours, theirs in ((got["params"], state.params),
                             (got["ema"], state.ema_params)):
            for a, b, a0, g in zip(leaves(tree(ours)), leaves(theirs),
                                   leaves(p0), mu):
                np.testing.assert_allclose(a, b, atol=2 * LR, rtol=0)
                sure = np.abs(g) / (1 - 0.9) > 1e-5
                np.testing.assert_allclose((a - a0)[sure], (b - a0)[sure],
                                           atol=1e-3 * LR, rtol=0)
