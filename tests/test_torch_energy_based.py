"""The port's energy-based family against the JAX package, on the CPU, in
f32, at a small size (C=16, 32², B=2).

* the EnergyNet's energy and ∇ₓE, with and without time conditioning;
* the training objectives on the reference's own ``loss_function``: CD
  with the gradient penalty (second order in the parameters), the
  energy-parameterized DSM, and a ``DiffusionLoss`` type on the energies,
  each with its parameter gradients;
* both samplers (the CD sweep with Langevin steps and re-injection, and
  the ancestral chain on ε̂) at T = 10 with 2 Langevin steps, on an
  analytic energy;
* the bridge and checkpoints, the trainer and the CLIs.

Weights are made by the port and crossed to JAX through
``models/convert.py``; the JAX draws are rebuilt from the reference's own
key splitting and fed to the port.
"""

import io
import json
import pickle
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusion_model_universal_tpu.models.energy_based import \
    EnergyBasedDiffusion as JaxEnergy
from diffusion_model_universal_tpu.utils import losses as jlosses
from diffusion_model_universal_torch.models import (MODEL_REGISTRY,
                                                    EnergyBasedDiffusion)
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.scripts.serve import (build_argparser,
                                                           make_server)
from diffusion_model_universal_torch.trainers import (TRAINER_REGISTRY,
                                                      EnergyBasedTrainer)
from diffusion_model_universal_torch.utils import losses as tlosses

torch.set_num_threads(2)

C, B = 16, 2
#: A Langevin step of 0.1 moves the negatives far enough from the data
#: that E(real) − E(fake) is not a difference of near-equal numbers.
CFG = {"model_channels": C, "image_size": 32, "in_channels": 3,
       "compute_dtype": "float32", "langevin_steps": 2,
       "langevin_step_size": 0.1, "regularization_weight": 0.5}
#: The objectives held: CD + GP, energy DSM, a DiffusionLoss on energies.
OBJECTIVES = {"cd_gp": {}, "dsm": {"training_objective": "dsm"},
              "huber": {"loss_type": "huber",
                        "loss_config": {"huber_delta": 0.5}}}


def _perturb(tree, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(p.shape).astype(np.float32), tree)


def _params(time_conditioning=True):
    return _perturb(unet_params_to_jax(EnergyBasedDiffusion(
        dict(CFG, use_time_conditioning=time_conditioning),
        device="cpu").net), 3)


def _port(params, **cfg):
    tm = EnergyBasedDiffusion(dict(CFG, **cfg), device="cpu")
    tm.load_params(params)
    return tm


def _images(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (B, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    return _params()


# -- the network ------------------------------------------------------------

@pytest.mark.parametrize("time_conditioning", [True, False])
def test_energy_and_its_gradient_match_jax(time_conditioning):
    """E(x, t) [B] and ∇ₓΣE: 1e-5 + 1e-5·|ref|. The plain GroupNorm runs
    (no K1 dispatch)."""
    params = _params(time_conditioning)
    cfg = dict(CFG, use_time_conditioning=time_conditioning)
    jm = JaxEnergy(cfg)
    x, t = _images(1), np.array([0, 731], np.int32)
    energy, grad = jax.jit(lambda z: (jm.apply(params, z, t), jax.grad(
        lambda y: jnp.sum(jm.apply(params, y, t)))(z)))(x)
    tm = _port(params, use_time_conditioning=time_conditioning)
    calls = []
    gn = gn_ops.group_norm_silu
    gn_ops.group_norm_silu = lambda *a, **k: calls.append(1) or gn(*a, **k)
    try:
        xt, tt = torch.from_numpy(x), torch.from_numpy(t).long()
        got = tm.apply(xt, tt)
        got_grad = tm.energy_grad(xt, tt)
    finally:
        gn_ops.group_norm_silu = gn
    assert not calls and got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), energy, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), grad, atol=1e-5,
                               rtol=1e-5)


def test_energy_based_loss_matches_jax_on_an_analytic_energy():
    """CD + GP of E(z) = Σ z²/2 + Σ z (∇E = z + 1), as its formula:
    rtol 1e-6; the per-sample form averages to it."""
    rng = np.random.default_rng(2)
    real, fake = (rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
                  for _ in range(2))
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))

    def energy(z):
        return 0.5 * (z ** 2).sum(axis=(1, 2, 3)) + z.sum(axis=(1, 2, 3))

    want = float(jlosses.energy_based_loss(energy, jnp.asarray(real),
                                           jnp.asarray(fake), key, 0.3))
    args = [torch.from_numpy(a) for a in (real, fake, alpha)]
    got = tlosses.energy_based_loss(energy, *args, 0.3)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    per = tlosses.energy_based_loss(energy, *args, 0.3, per_sample=True)
    assert per.shape == (3,)
    np.testing.assert_allclose(float(per.mean()), want, rtol=1e-6)


# -- the training objectives ------------------------------------------------

@pytest.fixture(scope="module")
def objectives(params):
    """JAX's ``value_and_grad(loss_function)`` of each objective on one
    key, with the draws its own splitting makes (``kt, kn, kl, kg =
    split(rng, 4)``: t, ε, the Langevin keys, α)."""
    x, rng = _images(4), jax.random.PRNGKey(5)
    kt, kn, kl, kg = jax.random.split(rng, 4)
    draws = {
        "t": np.asarray(jax.random.randint(kt, (B,), 0, 1000)),
        "noise": np.asarray(jax.random.normal(kn, x.shape, jnp.float32)),
        "langevin_noise": [np.asarray(jax.random.normal(k, x.shape))
                           for k in jax.random.split(kl, 2)],
        "alpha": np.asarray(jax.random.uniform(kg, (B, 1, 1, 1)))}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    out = {}
    for name, keys in OBJECTIVES.items():
        jm = JaxEnergy(dict(CFG, **keys))
        out[name] = jax.device_get(jax.jit(jax.value_and_grad(
            jm.loss_function))(p, x, rng))
    return x, draws, out


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_objective_and_gradients_match_jax(params, objectives, objective):
    """The loss rtol 1e-5 (1e-4 for the ``DiffusionLoss``: a function of
    E(real) − E(fake), two near-equal energies of the mean-pooled net,
    whose difference keeps only their f32 rounding's relative precision;
    measured 3.6e-5); the parameter gradients (second order for CD + GP
    and DSM: through ∇ₓE) each leaf's norm rtol 1e-4, each element within
    1e-3·|ref| + 1e-5·G (G the largest gradient of all)."""
    x, draws, out = objectives
    tm = _port(params, **OBJECTIVES[objective])
    kw = {"t": torch.from_numpy(draws["t"]).long(),
          "noise": torch.from_numpy(draws["noise"])}
    if objective != "dsm":
        kw["langevin_noise"] = [torch.from_numpy(a)
                                for a in draws["langevin_noise"]]
    if objective == "cd_gp":
        kw["alpha"] = torch.from_numpy(draws["alpha"])
    names, ps = zip(*tm.net.named_parameters())
    loss = tm.loss_function(torch.from_numpy(x), **kw)
    want_loss, want = out[objective]
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=1e-4 if objective == "huber" else 1e-5)
    got = state_dict_to_jax(tm.net, dict(zip(names, torch.autograd.grad(
        loss, ps, allow_unused=True, materialize_grads=True))))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
    big = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5 * big)
    np.testing.assert_allclose([np.linalg.norm(g) for g in got],
                               [np.linalg.norm(w) for w in want],
                               rtol=1e-4, atol=1e-6 * big)


def test_loss_draws_from_generator_and_eval_without_grad(params):
    """The draws come from the generator; under ``no_grad`` (evaluation)
    the penalty still takes ∇ₓE and the loss equals the training one."""
    tm = _port(params)
    x = torch.from_numpy(_images(6))
    a = tm.loss_function(x, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        b = tm.loss_function(x, generator=torch.Generator().manual_seed(1))
        per = tm.loss_function(x, generator=torch.Generator().manual_seed(1),
                               per_sample=True)
    assert a.requires_grad and not b.requires_grad
    np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    np.testing.assert_allclose(float(per.mean()), float(a), rtol=1e-5)
    with pytest.raises(ValueError, match="training_objective"):
        EnergyBasedDiffusion(dict(CFG, training_objective="nce"),
                             device="cpu")


# -- the samplers -----------------------------------------------------------

def _analytic_energy(x, t):
    """E(x, t) = Σ (1 + t/4)·x²/2 + 0.05·Σ x, ∇ₓE = (1 + t/4)·x + 0.05."""
    a = 1.0 + t[:, None, None, None] * 0.25
    return (0.5 * a * x * x + 0.05 * x).sum(axis=(1, 2, 3))


class _JaxAnalyticEnergy(JaxEnergy):
    def apply(self, params, x, t=None, train=False, rng=None):
        return _analytic_energy(x, t.astype(x.dtype))


class _PortAnalyticEnergy(EnergyBasedDiffusion):
    def apply(self, x, t=None):
        return _analytic_energy(x, t.to(x.dtype))


SHAPE = (B, 8, 8, 3)


def _sweep_draws(rng, steps: int):
    """x_T and each level's draws as the CD sweep makes them: (k_init,
    k_loop) = split(rng), level keys = split(k_loop, T), (k_lang, k_noise)
    = split(level key), Langevin draws from split(k_lang, steps), then
    the re-injection draw from k_noise."""
    k_init, k_loop = jax.random.split(rng)

    def level(key):
        k_lang, k_noise = jax.random.split(key)
        return jnp.concatenate([
            jax.vmap(lambda k: jax.random.normal(k, SHAPE))(
                jax.random.split(k_lang, steps)),
            jax.random.normal(k_noise, SHAPE)[None]])

    d = jax.vmap(level)(jax.random.split(k_loop, 10))
    return jnp.concatenate([jax.random.normal(k_init, SHAPE)[None],
                            d.reshape(-1, *SHAPE)])


def _ancestral_draws(rng):
    """x_T, then one draw a step from split(k_loop, T)."""
    k_init, k_loop = jax.random.split(rng)
    d = jax.vmap(lambda k: jax.random.normal(k, SHAPE))(
        jax.random.split(k_loop, 10))
    return jnp.concatenate([jax.random.normal(k_init, SHAPE)[None], d])


@pytest.fixture(scope="module")
def samplers():
    """JAX's two samplers on the analytic energy at T = 10 (2 Langevin
    steps a level) and their draws: one compiled module."""
    cfg = dict(CFG, num_timesteps=10, image_size=8)
    cd, dsm = (_JaxAnalyticEnergy(dict(cfg, training_objective=o))
               for o in ("cd", "dsm"))

    @jax.jit
    def run(rng):
        return {"cd": (cd.generate_samples({}, rng, B),
                       _sweep_draws(rng, 2)),
                "dsm": (dsm.generate_samples({}, rng, B),
                        _ancestral_draws(rng))}

    return jax.device_get(run(jax.random.PRNGKey(9)))


@pytest.mark.parametrize("objective", ["cd", "dsm"])
def test_sampler_matches_jax(samplers, objective):
    """T = 10 levels of Langevin with re-injection (CD) or the ancestral
    chain on ε̂ = √(1−ᾱ)·∇ₓE (DSM), on the analytic energy (the network's
    E and ∇ₓE are held above), the same draws: 1e-5·max|x| +
    1e-5·|ref|."""
    want, draws = samplers[objective]
    tm = _PortAnalyticEnergy(dict(CFG, num_timesteps=10, image_size=8,
                                  model_channels=4,
                                  training_objective=objective),
                             device="cpu")
    got = tm.generate_samples(B, noise=list(torch.from_numpy(draws)))
    assert not got.requires_grad
    bound = 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)
    assert np.all(np.abs(got.numpy() - want) <= bound)


def test_samplers_under_inference_mode_and_intermediates(params):
    """Sampling turns autograd on locally, also inside ``no_grad``; under
    ``inference_mode`` (whose tensors cannot be saved for a backward) it
    raises rather than sampling without ∇ₓE."""
    tm = _port(params, num_timesteps=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        a = tm.generate_samples(2, gen.manual_seed(4))
    frames = tm.generate_samples_with_intermediates(2, gen.manual_seed(4),
                                                    save_interval=2)
    assert len(frames) == 3 and torch.equal(frames[-1], a)
    with torch.inference_mode(), pytest.raises(RuntimeError):
        tm.generate_samples(2, gen.manual_seed(4))


# -- bridge and checkpoints ---------------------------------------------------

def test_bridge_roundtrip_and_checkpoint_through_jax(params, tmp_path):
    """The EnergyNet tree (top-level ``norm1_scale``… leaves, which the
    bridge must not rename) strict-loads and comes back bit for bit; a
    port checkpoint loads in JAX and a JAX checkpoint back in the port."""
    assert params["norm1_scale"].shape == (C,)
    assert params["conv1"]["kernel"].shape == (3, 3, 3 + C, C)
    sd = unet_state_dict_from_jax(params)
    assert {"norm1_scale", "norm2_bias", "dense.weight"} <= set(sd)
    tm = _port(params)
    back = unet_params_to_jax(tm.net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)))
    path = str(tmp_path / "port.ckpt")
    tm.save(path)
    jm, jparams = JaxEnergy.load_with_config(path)
    assert jm.config["model_channels"] == C and jm.langevin_steps == 2
    jpath = str(tmp_path / "jax.ckpt")
    jm.save(jpath, jparams)
    with open(jpath, "rb") as f:
        assert isinstance(pickle.load(f)["model_state_dict"], dict)
    again = EnergyBasedDiffusion.load_with_config(jpath, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(unet_params_to_jax(again.net)),
        jax.tree_util.tree_leaves(params)))


# -- trainer and CLIs -------------------------------------------------------

TINY = dict(CFG, model_channels=8, num_timesteps=3)


def test_trainer_logs_and_steps(tmp_path):
    model = MODEL_REGISTRY["energy_based"](TINY, device="cpu",
                                           trainable=True)
    cfg = {"training": {"learning_rate": 1e-3, "batch_size": 2},
           "output": {"output_dir": str(tmp_path)}}
    tr = TRAINER_REGISTRY["energy_based"](model, [None], None, None, cfg)
    assert isinstance(tr, EnergyBasedTrainer)
    x = torch.from_numpy(_images(7))
    draws = {"t": torch.tensor([0, 2]), "noise": torch.randn(x.shape),
             "langevin_noise": [torch.randn(x.shape) for _ in range(2)],
             "alpha": torch.rand(2, 1, 1, 1)}
    want = model.loss_function(x, **draws).item()
    m = tr.step(x, **draws)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-6)
    assert tr.step_count == 1 and torch.isfinite(m["grad_norm"])
    assert tr.generate_samples(0).endswith("epoch_0.png")
    tr.cleanup()
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(d.get("energy/scale") == 1.0 and
               d.get("energy/regularization_weight") == 0.5 and
               d.get("energy/langevin_step_size") == 0.1 and
               d.get("energy/langevin_steps") == 2 for d in logged)
    assert any("diffusion/beta/mean" in d for d in logged)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --model_type energy_based`` for one epoch of 2 steps at a
    tiny config on the CPU; its config and final checkpoint."""
    tmp = tmp_path_factory.mktemp("energy_cli")
    cfg = {"model_name": "EnergyBasedDiffusion", "model_config": TINY,
           "training": {"num_epochs": 1, "batch_size": 4,
                        "learning_rate": 1e-3, "ema_decay": 0.99,
                        "val_interval": 100, "sample_interval": 1,
                        "checkpoint_interval": 10},
           "data": {"dataset": "synthetic", "data_dir": "unused",
                    "num_samples": 8},
           "output": {"output_dir": str(tmp / "run")}}
    path = tmp / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config", str(path), "--model_type",
                           "energy_based", "--device", "cpu"]) == 0
    assert (tmp / "run" / "samples" / "epoch_0.png").is_file()
    return tmp, str(path), str(tmp / "run" / "checkpoints" / "final_model")


def test_train_generate_serve_cli(trained):
    tmp, cfg, ckpt = trained
    out = tmp / "gen"
    assert gen_cli.main(["--config", cfg, "--model_type", "energy_based",
                         "--checkpoint", ckpt, "--ema", "--device", "cpu",
                         "--num_samples", "2", "--output_dir",
                         str(out)]) == 0
    assert (out / "samples_grid.png").is_file()
    srv = make_server(build_argparser().parse_args([
        "--config", cfg, "--model_type", "energy_based", "--checkpoint",
        ckpt, "--ema", "--port", "0", "--serve_batch", "2", "--device",
        "cpu"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    try:
        def post(body):
            req = urllib.request.Request(
                f"http://{host}:{port}/generate",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=60)

        with post({"num_samples": 2, "format": "npy"}) as r:
            arr = np.load(io.BytesIO(r.read()))
        assert arr.shape == (2, 32, 32, 3) and np.isfinite(arr).all()
        for body, fragment in (
                ({"class_id": 1}, "class_id unsupported"),
                ({"sampler": "strided"}, "needs an ε-prediction model")):
            with pytest.raises(urllib.error.HTTPError) as e:
                post(dict(body, num_samples=1))
            assert e.value.code == 400
            assert fragment in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("extra,fragment", [
    (["--class_id", "1"], "--class_id unsupported for energy_based models"),
    (["--inpaint_image", "x.npy"],
     "--inpaint_image unsupported for energy_based models (ddpm/ddim only)"),
    (["--sampler", "dpm++"],
     "--sampler dpm++ needs an ε-prediction model (ddpm/ddim), got "
     "energy_based")])
def test_generate_refuses_what_the_reference_refuses(trained, extra,
                                                     fragment):
    _, cfg, ckpt = trained
    with pytest.raises(SystemExit) as e:
        gen_cli.main(["--config", cfg, "--model_type", "energy_based",
                      "--checkpoint", ckpt, "--device", "cpu"] + extra)
    assert fragment in str(e.value)
