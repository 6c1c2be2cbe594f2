"""The port's training math against the JAX package, on the CPU, in f32,
at a small size (C=32, 32², T=8, B=4).

The loss, the prediction targets, the LR schedules and Adam (with clip
and the non-finite skip) are held against the JAX package's own on the
same inputs; one whole training step is held against a JAX
``DDPMTrainer.step`` on the same weights, batch and key-derived t and
noise. Dropout is 0 and remat off wherever the two packages are compared;
remat is held against no remat within the port.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.models import schedules as jsched
from diffusion_model_universal_tpu.parallel.mesh import make_mesh
from diffusion_model_universal_tpu.trainers import DDPMTrainer as JaxTrainer
from diffusion_model_universal_tpu.trainers.optim import \
    make_lr_schedule as jax_lr_schedule
from diffusion_model_universal_tpu.trainers.optim import \
    make_optimizer as jax_make_optimizer
from diffusion_model_universal_tpu.utils.losses import \
    DiffusionLoss as JaxLoss
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models import schedules as tsched
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.ops import attention as attn_ops
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.trainers import optim as topt
from diffusion_model_universal_torch.utils.losses import DiffusionLoss

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
C, T, B = 32, 8, 4
MODEL_CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
             "in_channels": 3, "compute_dtype": "float32", "remat": False,
             "dropout": 0.0}


def _perturb(tree, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(p.shape).astype(np.float32), tree)


# -- loss ---------------------------------------------------------------

_LOSS_CFG = {"huber_delta": 0.5,
             "hybrid_weights": {"mse": 1.0, "l1": 0.5, "huber": 0.25},
             "time_weight_params": {"min_weight": 0.2, "max_weight": 0.9,
                                    "gamma": 4.0}}


@pytest.mark.parametrize("weight,prediction_type", [
    ("snr", "epsilon"), ("linear", "epsilon"), ("inverse", "epsilon"),
    ("min_snr", "epsilon"), ("min_snr", "v"), ("min_snr", "x0"),
    (None, "epsilon")])
@pytest.mark.parametrize("loss_type", ["mse", "l1", "huber", "hybrid"])
def test_diffusion_loss_matches_jax(loss_type, weight, prediction_type):
    """Every loss type × time weight (None: no weighting) against JAX's
    DiffusionLoss, SNR from a linear ᾱ over T=50. f32, rtol 1e-6
    (measured: equal to f32 rounding)."""
    cfg = dict(_LOSS_CFG, use_time_weighting=weight is not None,
               time_weight_type=weight or "snr")
    ac = jsched.make_noise_schedule(1e-4, 2e-2, 50).alphas_cumprod
    rng = np.random.default_rng(0)
    pred, target = (rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
                    for _ in range(2))
    t = np.array([0, 7, 23, 49])
    want = JaxLoss(loss_type, cfg, 50, ac, prediction_type)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(t))
    got = DiffusionLoss(loss_type, cfg, 50,
                        torch.from_numpy(np.asarray(ac)), prediction_type)(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(t))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_perceptual_loss_is_not_ported():
    """The name is from when ``perceptual_weight > 0`` was refused; the
    term is ported now (``tests/test_torch_extractors.py`` holds it
    against JAX), so the loss adds weight × the VGG distance."""
    loss = DiffusionLoss("mse", {"perceptual_weight": 0.1,
                                 "use_time_weighting": False})
    gen = torch.Generator().manual_seed(0)
    x, y = (torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1
            for _ in range(2))
    want = ((x - y) ** 2).mean() + 0.1 * loss._perceptual(x, y)
    torch.testing.assert_close(loss(x, y), want)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v", "x0"])
def test_prediction_target_matches_jax(prediction_type):
    """The training target of each parameterization (1e-6 abs + rel: f32
    rounding of a·ε − s·x₀; measured 5e-7), and its round trip through
    prediction_to_eps back to ε."""
    js = jsched.make_noise_schedule(1e-4, 2e-2, T)
    ts = tsched.make_noise_schedule(1e-4, 2e-2, T, device="cpu")
    rng = np.random.default_rng(1)
    x0, noise = (rng.normal(size=(B, 4, 4, 3)).astype(np.float32)
                 for _ in range(2))
    t = np.array([0, 3, 5, 7])
    want = jsched.prediction_target(js, jnp.asarray(x0), jnp.asarray(noise),
                                    jnp.asarray(t), prediction_type)
    tx0, tn, tt = (torch.from_numpy(a) for a in (x0, noise, t))
    got = tsched.prediction_target(ts, tx0, tn, tt, prediction_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    xt = tsched.q_sample(ts, tx0, tt, tn)
    eps = tsched.prediction_to_eps(ts, got, xt, tt, prediction_type)
    np.testing.assert_allclose(eps.numpy(), noise, atol=2e-4)
    with pytest.raises(ValueError):
        tsched.prediction_target(ts, tx0, tn, tt, "score")


# -- optimizer ----------------------------------------------------------

@pytest.mark.parametrize("sched", [
    {"type": "cosine", "min_lr": 1e-6},
    {"type": "linear", "warmup_steps": 10, "min_lr": 1e-5},
    {"type": "step", "step_size": 3, "gamma": 0.5},
    {"type": "exponential", "gamma": 0.9},
    {"type": "one_cycle", "pct_start": 0.25},
    {"type": "constant"}])
def test_lr_schedules_match_optax(sched):
    """The LR at several steps (10 steps per epoch, 10 epochs): rtol 1e-5
    and atol 2e-9, f32 rounding at the LR's scale (optax evaluates in
    f32, the port in Python floats; measured 2.8e-11 at the cosine's
    tail)."""
    cfg = {"learning_rate": 2e-3, "scheduler": sched}
    ours = topt.make_lr_schedule(cfg, 10, 10)
    theirs = jax_lr_schedule(cfg, 10, 10)
    for step in (0, 1, 5, 10, 24, 25, 37, 60, 99, 100, 150):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-5, atol=2e-9,
                                   err_msg=f"step {step}")


def _adam_leaves(state, name):
    """The leaves of optax state fields called ``name`` (mu, nu)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if any(getattr(k, "name", None) == name for k in path):
            out.append(np.asarray(leaf))
    return out


@pytest.mark.parametrize("grad_clip,skip", [(None, 0), (0.5, 0), (100.0, 0),
                                            (0.5, 2)])
def test_adam_clip_and_skip_match_optax(grad_clip, skip):
    """Four updates (the third with a NaN gradient when skipping) from the
    same gradients: parameters and both moments equal optax's chain of
    clip_by_global_norm, adam and apply_if_finite to rtol 1e-5."""
    cfg = {"learning_rate": 1e-2, "beta1": 0.8, "beta2": 0.95,
           "scheduler": {"type": "cosine", "min_lr": 1e-4},
           "grad_clip": grad_clip, "skip_nonfinite_updates": skip}
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt, _ = topt.make_optimizer(tparams, cfg, 4, 2)
    jopt, _ = jax_make_optimizer(cfg, 4, 2)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for i in range(4):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        if skip and i == 2:
            grads["b"][1] = np.nan
        tg = [torch.from_numpy(grads[k].copy()) for k in shapes]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tg)))
        applied = opt.step(tg, norm)
        assert applied == (not (skip and i == 2))
        updates, jstate = jopt.update({k: jnp.asarray(v)
                                       for k, v in grads.items()},
                                      jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-7)
        for name, ours in (("mu", opt.mu), ("nu", opt.nu)):
            for a, b in zip(ours, _adam_leaves(jstate, name)):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-9)
    assert opt.count == (3 if skip else 4)
    assert opt.total_notfinite == (1 if skip else 0)


def test_adam_mu_dtype_is_not_ported():
    with pytest.raises(ValueError, match="not yet ported"):
        topt.make_optimizer([torch.zeros(2)], {"adam_mu_dtype": "bfloat16"},
                            1, 1)


# -- the model under autograd ---------------------------------------------

def _trainable(remat: bool, dropout: float = 0.0) -> DDPM:
    return DDPM(dict(MODEL_CFG, remat=remat, dropout=dropout), device="cpu",
                seed=3, trainable=True)


def _batch(seed: int = 4):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(size=(B, 32, 32, 3)), -1, 1).astype(np.float32)
    return (torch.from_numpy(x), torch.tensor([0, 2, 5, 7]),
            torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)))


def test_remat_gives_the_gradients_of_no_remat():
    """Checkpointing the down/up stages (with dropout 0.1, whose masks the
    recompute replays from the saved RNG state) gives the gradients of the
    plain backward. Tolerance 1e-6 abs + 1e-5 rel; measured: identical."""
    a, b = _trainable(True, 0.1), _trainable(False, 0.1)
    b.net.load_state_dict(a.net.state_dict())
    x, t, noise = _batch()
    grads = []
    for m in (a, b):
        torch.manual_seed(5)
        loss = m.loss_function(x, t, noise)
        grads.append(torch.autograd.grad(loss, list(m.net.parameters())))
    for ga, gb in zip(*grads):
        np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-6,
                                   rtol=1e-5)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", [True, False])
def test_kernel_dispatches_per_training_step(remat, monkeypatch):
    """One training step's dispatches of the GroupNorm forward (K1),
    backward (K2) and attention (K3): with remat, 53 + 47 K1 (the
    down/up stages recomputed in the backward), 53 K2 and 5 + 4 K3, the
    counts ``chip_smoke.py`` holds the card's launch counters to."""
    calls = {"gn": 0, "gn_bwd": 0, "mha": 0}

    def counting(kind, fn):
        def wrapped(*a):
            calls[kind] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(gn_ops, "_gn_fwd", counting("gn", gn_ops._gn_fwd))
    monkeypatch.setattr(gn_ops, "_gn_bwd", counting("gn_bwd",
                                                    gn_ops._gn_bwd))
    monkeypatch.setattr(attn_ops, "_mha_fwd", counting("mha",
                                                       attn_ops._mha_fwd))
    m = _trainable(remat)
    x, t, noise = _batch()
    torch.autograd.grad(m.loss_function(x, t, noise),
                        list(m.net.parameters()))
    if remat:
        assert calls == _load_chip_smoke().LAUNCHES_PER_STEP
    else:
        assert calls == {"gn": 53, "gn_bwd": 53, "mha": 5}


def test_trainable_model_keeps_f32_weights_and_autocasts():
    """A model built for training keeps f32 parameters and computes under
    autocast in its compute dtype; the serving build casts the conv and
    Linear weights instead."""
    m = DDPM(dict(MODEL_CFG, compute_dtype="bfloat16"), device="cpu",
             trainable=True)
    assert {p.dtype for p in m.net.parameters()} == {torch.float32}
    assert m.autocast
    x, t, noise = _batch()
    loss = m.loss_function(x, t, noise)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    serve = DDPM(dict(MODEL_CFG, compute_dtype="bfloat16"), device="cpu")
    assert serve.net.initial_conv.weight.dtype == torch.bfloat16
    assert not serve.autocast


# -- one training step against JAX ------------------------------------------

def test_training_step_matches_jax_trainer(tmp_path):
    """One DDPMTrainer step (SNR-weighted MSE, clip 1.0, the non-finite
    skip, cosine LR, EMA with warmup) on the same weights, batch and the
    t/noise JAX derives from its step key. Tolerances: loss rtol 1e-5;
    per-layer gradient norms rtol 1e-4; Adam moments (the gradients) rtol
    1e-3 + atol 1e-7 (μ) / 1e-12 (ν), f32 sums in another order; the
    update p1 − p0 and the EMA's move ema − p0 atol 1e-3·lr where
    |g| > 1e-5, and 2·lr elsewhere, because Adam's first step moves each
    weight by about ±lr·sign(g) and a gradient near zero may flip sign."""
    lr = 1e-3
    cfg = {"model_name": "DDPM", "model_config": MODEL_CFG,
           "training": {"num_epochs": 2, "batch_size": B,
                        "learning_rate": lr, "ema_decay": 0.999,
                        "grad_clip": 1.0, "skip_nonfinite_updates": 3,
                        "scheduler": {"type": "cosine", "min_lr": 1e-6}},
           "logging": {"log_interval": 1},
           "output": {"output_dir": str(tmp_path / "jax")}}
    # Both trainers start from the port's initial weights, perturbed (the
    # JAX trainer takes them from init_params, which skips flax's eager
    # init; the train step is the one JAX compile).
    params = _perturb(unet_params_to_jax(_trainable(False).net), 1)
    jmodel = JaxDDPM(MODEL_CFG)
    jmodel.init_params = lambda rng: jax.tree_util.tree_map(jnp.asarray,
                                                            params)
    jtr = JaxTrainer(jmodel, [None] * 5, None, None, cfg,
                     mesh=make_mesh(jax.devices()[:1]), seed=0)
    x, _, _ = _batch(6)
    kt, kn, _ = jax.random.split(jtr._step_key(0), 3)
    t = np.asarray(jax.random.randint(kt, (B,), 0, T))
    noise = np.asarray(jax.random.normal(kn, x.shape, jnp.float32))
    jm = jtr.step(jnp.asarray(x.numpy()))

    model = DDPM(MODEL_CFG, device="cpu", seed=0, trainable=True)
    model.net.load_state_dict(unet_state_dict_from_jax(params))
    tr = DDPMTrainer(model, [None] * 5, None, None,
                     dict(cfg, output={"output_dir": str(tmp_path / "pt")}),
                     seed=0)
    m = tr.step(x, t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    tr.cleanup()

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert tr.step_count == int(jtr.state.step) == 1

    def tree(tensors):
        return state_dict_to_jax(model.net,
                                 dict(zip(tr.param_names, tensors)))

    norms = tree([torch.full(p.shape, float(v)) for p, v in
                  zip(tr.params, m["layer_grad_norms"].values())])
    got_norms = [a.flat[0] for a in jax.tree_util.tree_leaves(norms)]
    np.testing.assert_allclose(
        got_norms, [float(v) for v in
                    jax.tree_util.tree_leaves(jm["layer_grad_norms"])],
        rtol=1e-4, atol=1e-8)
    state = jax.device_get(jtr.state)
    for name, ours, atol in (("mu", tr.optimizer.mu, 1e-7),
                             ("nu", tr.optimizer.nu, 1e-12)):
        got = jax.tree_util.tree_leaves(tree(ours))
        want = _adam_leaves(state.opt_state, name)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=atol)
    # The update each side applied, p1 − p0, and the EMA's move, ema − p0,
    # held at 1e-3·lr wherever JAX's clipped gradient g = μ/(1 − b1) has
    # |g| > 1e-5: there the two gradients agree closely enough that Adam's
    # step −lr·g/(|g| + 1e-8) agrees to f32 rounding of p (measured 1.2e-7
    # for the update, 2.4e-7 for the EMA, i.e. ≤ 2.4e-4·lr). A missing
    # update, a flipped sign, or a wrong warmup decay (d = 0.1 at step 0)
    # moves them by ~0.1·lr or more. Everywhere, within 2·lr (one Adam
    # step). The held elements are 47% of all: the 3×3 convs at 1² and 2²
    # get no gradient outside their centre tap.
    p0 = jax.tree_util.tree_leaves(params)
    mu = _adam_leaves(state.opt_state, "mu")
    masked = 0
    for ours, theirs in ((tr.params, state.params),
                         (tr.ema, state.ema_params)):
        for a, b, a0, g in zip(jax.tree_util.tree_leaves(tree(ours)),
                               jax.tree_util.tree_leaves(theirs), p0, mu):
            np.testing.assert_allclose(a, b, atol=2 * lr, rtol=0)
            sure = np.abs(g) / (1 - 0.9) > 1e-5
            masked += int(sure.sum())
            np.testing.assert_allclose((a - a0)[sure], (b - a0)[sure],
                                       atol=1e-3 * lr, rtol=0)
    assert masked > 0.4 * 2 * sum(p.size for p in p0)
