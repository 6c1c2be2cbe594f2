"""The port's score-based family against the JAX package, on the CPU, in
f32, at a small size (C=32, 32², B=2 or 3).

* the σ ladder, the geometric σ map and the DSM loss formulas;
* the σ-conditioned UNet (both score parameterizations, and with
  ``split_skip_convs: false``), the DSM loss (both weightings and a
  ``DiffusionLoss`` type) and its parameter gradients, on weights made by
  the port and crossed to JAX through ``models/convert.py``;
* annealed Langevin at the published ladder (1000 levels × 10 steps, σ
  0.01–50, β 1) on an analytic score, and 2 levels × 2 steps through the
  real UNet;
* the bridge and checkpoints, the trainer and the CLIs.

The JAX draws are rebuilt from the reference's own key splitting and fed
to the port. JAX compiles the UNet twice: one gradient of the loss (for
every variant and the forward), and a 4-step sampler; nothing at full
width.
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

from diffusion_model_universal_tpu.models import schedules as jsched
from diffusion_model_universal_tpu.models.score_based import \
    ScoreBasedDiffusion as JaxScore
from diffusion_model_universal_tpu.utils import losses as jlosses
from diffusion_model_universal_torch.models import (MODEL_REGISTRY,
                                                    ScoreBasedDiffusion)
from diffusion_model_universal_torch.models import schedules as tsched
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.scripts.serve import (build_argparser,
                                                           make_server)
from diffusion_model_universal_torch.trainers import (TRAINER_REGISTRY,
                                                      ScoreBasedTrainer)
from diffusion_model_universal_torch.utils import losses as tlosses

torch.set_num_threads(2)

C = 32
CFG = {"model_channels": C, "image_size": 32, "in_channels": 3,
       "compute_dtype": "float32", "remat": False, "dropout": 0.0}
#: The score-matching losses held: both DSM weightings and a
#: DiffusionLoss type on (score, −ε/σ).
VARIANTS = {"dsm_none": {}, "dsm_sigma2": {"dsm_weighting": "sigma2"},
            "huber": {"loss_type": "huber",
                      "loss_config": {"huber_delta": 0.5}}}


def _perturb(tree, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(p.shape).astype(np.float32), tree)


def _port(params, **cfg):
    tm = ScoreBasedDiffusion(dict(CFG, **cfg), device="cpu")
    tm.load_params(params)
    return tm


@pytest.fixture(scope="module")
def params():
    """The port's initial weights, every leaf perturbed (so the zero
    ``conv2``/``time_proj`` leaves contribute), as a flax tree."""
    return _perturb(unet_params_to_jax(
        ScoreBasedDiffusion(CFG, device="cpu").net), 3)


# -- formulas ---------------------------------------------------------------

@pytest.mark.parametrize("num_scales", [2, 10, 1000])
def test_sigma_ladder_matches_jax(num_scales):
    """exp(linspace(ln 50, ln 0.01, n)) in f32: rtol 1e-6 (measured
    within 2 ulp)."""
    want = np.asarray(jsched.sigma_ladder(0.01, 50.0, num_scales))
    got = tsched.sigma_ladder(0.01, 50.0, num_scales)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(50.0, rel=1e-6)
    assert got[-1] == pytest.approx(0.01, rel=1e-6)


def test_continuous_sigma_matches_jax():
    u = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    want = np.asarray(jsched.continuous_sigma(0.01, 50.0, jnp.asarray(u)))
    got = tsched.continuous_sigma(0.01, 50.0, torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("weighting", ["none", "sigma2"])
def test_score_matching_loss_matches_jax(weighting):
    """rtol 1e-6; the per-sample form averages to the batch loss."""
    rng = np.random.default_rng(1)
    score, noise = (rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
                    for _ in range(2))
    sigma = np.array([0.01, 1.0, 50.0], np.float32)
    want = float(jlosses.score_matching_loss(
        jnp.asarray(score), jnp.asarray(noise), jnp.asarray(sigma),
        weighting))
    args = [torch.from_numpy(a) for a in (score, noise, sigma)]
    got = tlosses.score_matching_loss(*args, weighting)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    per = tlosses.score_matching_loss(*args, weighting, per_sample=True)
    assert per.shape == (3,)
    np.testing.assert_allclose(float(per.mean()), want, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown DSM weighting"):
        tlosses.score_matching_loss(*args, "sigma")


# -- the σ-conditioned UNet and the DSM loss --------------------------------

B = 3
SIGMAS = np.array([0.01, 1.0, 50.0], np.float32)   # the ladder's ends, 1


def _variant_loss(m, score, noise, sigma):
    """The tail of the reference's ``loss_function`` for model ``m``."""
    if m.loss_fn is None:
        return jlosses.score_matching_loss(score, noise, sigma,
                                           m.dsm_weighting)
    return m.loss_fn(score, -noise / sigma[:, None, None, None])


@pytest.fixture(scope="module")
def reference(params):
    """JAX through one compiled module, the gradient of the body of the
    reference's ``loss_function`` (x + σ·ε, the network with dropout on,
    the variant's loss on its score) with the variant picked by runtime
    one-hot weights, the network's output as an aux value:

    * ``forward``: the raw score of x at σ 0.01, 1 and 50 (ε = 0);
    * ``dsm``: each variant's loss and parameter gradient on the draws
      the reference's own key splitting makes (``ku, kn, kd =
      split(rng, 3)``; u → σ, ε, the dropout key).
    """
    models = [JaxScore(dict(CFG, **v)) for v in VARIANTS.values()]
    raw = models[0]

    def loss(p, x, sigma, noise, kd, onehot):
        s4 = sigma[:, None, None, None]
        score = raw.apply(p, x + s4 * noise, sigma, train=True, rng=kd)
        return sum(w * _variant_loss(m, score, noise, sigma)
                   for w, m in zip(onehot, models)), score

    run = jax.jit(jax.value_and_grad(loss, has_aux=True))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    onehot = np.eye(len(VARIANTS), dtype=np.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    (_, score), _ = run(p, x, SIGMAS, np.zeros_like(x),
                        jax.random.PRNGKey(0), onehot[0])
    forward = {"x": x, "raw": np.asarray(score)}
    x = rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    ku, kn, kd = jax.random.split(jax.random.PRNGKey(5), 3)
    sigma = np.asarray(jsched.continuous_sigma(
        0.01, 50.0, jax.random.uniform(ku, (B,))))
    noise = np.asarray(jax.random.normal(kn, x.shape, jnp.float32))
    dsm = {"x": x, "sigma": sigma, "noise": noise, "losses": {},
           "grads": {}}
    for k, w in zip(VARIANTS, onehot):
        (value, _), grads = jax.device_get(run(p, x, sigma, noise, kd, w))
        dsm["losses"][k], dsm["grads"][k] = value, grads
    return forward, dsm


@pytest.mark.parametrize("parameterization", ["raw", "sigma"])
def test_sigma_unet_matches_jax(params, reference, parameterization):
    """The score at σ 0.01, 1 and 50. Tolerance 1e-4 + 1e-4·|ref| (the
    whole-UNet bound). ``sigma`` is the reference's ``out / σ`` of the
    same network output (taken here in numpy); its absolute part is
    1e-4/σ, as the division scales the network's f32 rounding by 1/σ."""
    fwd = reference[0]
    tm = _port(params, score_parameterization=parameterization)
    assert tm.net.continuous_sigma
    with torch.no_grad():
        got = tm.apply(torch.from_numpy(fwd["x"]), torch.from_numpy(SIGMAS))
    s4 = SIGMAS[:, None, None, None]
    want = fwd["raw"] if parameterization == "raw" else fwd["raw"] / s4
    atol = 1e-4 if parameterization == "raw" else 1e-4 / s4
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= atol + 1e-4 * np.abs(want))


def test_sigma_unet_split_skip_convs_false_matches_jax(params, reference):
    """``split_skip_convs: false`` (the skips concatenated first) on the
    score UNet, against the reference's score UNet (whose split GN/convs
    are the same math as the concat in f32): 1e-4 + 1e-4·|ref|; the
    GroupNorm count of a forward drops from 53 to 50. The DDPM UNet's
    concat path is held against flax's ``split_skip_convs=False`` in
    tests/test_torch_model.py."""
    from diffusion_model_universal_torch.models import UNet
    from diffusion_model_universal_torch.ops import group_norm as gn_ops
    fwd = reference[0]
    net = UNet(model_channels=C, continuous_sigma=True,
               split_skip_convs=False)
    net.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    net = net.to(memory_format=torch.channels_last).eval()
    calls = []
    gn = gn_ops.group_norm_silu
    gn_ops.group_norm_silu = lambda *a, **k: calls.append(1) or gn(*a, **k)
    try:
        with torch.no_grad():
            got = net(torch.from_numpy(fwd["x"]), torch.from_numpy(SIGMAS))
    finally:
        gn_ops.group_norm_silu = gn
    assert len(calls) == 50
    np.testing.assert_allclose(got.numpy(), fwd["raw"], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dsm_loss_and_gradients_match_jax(params, reference, variant):
    """The loss at the injected σ and ε: rtol 1e-5. The parameter
    gradients as tests/test_torch_train.py holds a training step's: each
    leaf's norm rtol 1e-4 (absolute part 1e-5·G, G the largest gradient
    of all: leaves whose true gradient is zero, such as the attention key
    bias, are f32 rounding noise); each element within 1e-3·|ref| +
    1e-4·G (f32 sums in another order; measured below 2.5e-5·G)."""
    dsm = reference[1]
    tm = _port(params, **VARIANTS[variant])
    names, ps = zip(*tm.net.named_parameters())
    loss = tm.loss_function(torch.from_numpy(dsm["x"]),
                            sigma=torch.from_numpy(dsm["sigma"]),
                            noise=torch.from_numpy(dsm["noise"]))
    np.testing.assert_allclose(loss.item(), float(dsm["losses"][variant]),
                               rtol=1e-5)
    got = state_dict_to_jax(tm.net, dict(zip(
        names, torch.autograd.grad(loss, ps))))
    want = dsm["grads"][variant]
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    got, want = (jax.tree_util.tree_leaves(t) for t in (got, want))
    big = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * big)
    np.testing.assert_allclose([np.linalg.norm(g) for g in got],
                               [np.linalg.norm(w) for w in want],
                               rtol=1e-4, atol=1e-5 * big)


def test_loss_draws_from_generator_and_per_sample(params):
    tm = _port(params)
    x = torch.zeros(2, 32, 32, 3)
    a = tm.loss_function(x, generator=torch.Generator().manual_seed(1))
    b = tm.loss_function(x, generator=torch.Generator().manual_seed(1))
    per = tm.loss_function(x, generator=torch.Generator().manual_seed(1),
                           per_sample=True)
    assert float(a) == float(b) and per.shape == (2,)
    np.testing.assert_allclose(float(per.mean()), float(a), rtol=1e-5)
    with pytest.raises(ValueError, match="score_parameterization"):
        ScoreBasedDiffusion(dict(CFG, score_parameterization="eps"),
                            device="cpu")


# -- annealed Langevin ------------------------------------------------------

SHAPE = (2, 8, 8, 3)
LADDER = {"sigma_min": 0.01, "sigma_max": 50.0, "num_scales": 1000,
          "langevin_steps": 10, "beta": 1.0, "image_size": 8,
          "in_channels": 3}


def _analytic_score(x, sigma):
    """s = −x/(1 + σ²): the score of N(0, (1 + σ²)·I)."""
    return -x / (1.0 + sigma[:, None, None, None] ** 2)


class _JaxAnalyticScore(JaxScore):
    def apply(self, params, x, sigma, train=False, rng=None):
        return _analytic_score(x, sigma)


def _langevin_draws(rng, num_scales, steps, shape):
    """x_init and every step's draw as the reference's sampler makes them:
    (k_init, k_loop) = split(rng), x_init ~ k_init, level keys =
    split(k_loop, num_scales), step keys = split(level key, steps).
    Returns a traceable [1 + num_scales·steps, *shape] array."""
    k_init, k_loop = jax.random.split(rng)
    d = jax.vmap(lambda key: jax.vmap(
        lambda k: jax.random.normal(k, shape))(jax.random.split(key, steps)))(
        jax.random.split(k_loop, num_scales))
    return jnp.concatenate([jax.random.normal(k_init, shape)[None],
                            d.reshape(num_scales * steps, *shape)])


@pytest.fixture(scope="module")
def published_ladder():
    """JAX's sampler on the analytic score, without and with the final
    denoise, and its draws: one compiled module."""
    models = [_JaxAnalyticScore(dict(LADDER, model_channels=32,
                                     final_denoise=f)) for f in (0, 1)]

    @jax.jit
    def run(rng):
        return ([m.generate_samples({}, rng, SHAPE[0]) for m in models],
                _langevin_draws(rng, 1000, 10, SHAPE))

    samples, draws = jax.device_get(run(jax.random.PRNGKey(7)))
    return samples, list(torch.from_numpy(draws))


@pytest.mark.parametrize("final_denoise", [False, True])
def test_annealed_langevin_published_ladder_matches_jax(published_ladder,
                                                        final_denoise):
    """1000 levels × 10 steps on the analytic score, the same draws:
    within 1e-5·max|x| + 1e-5·|ref| (the top of the ladder takes steps of
    (σβ)²·2 = 5000, so the iterate's scale sets the absolute part)."""
    samples, draws = published_ladder
    want = samples[final_denoise]
    tm = ScoreBasedDiffusion(dict(LADDER, model_channels=8,
                                  final_denoise=final_denoise),
                             device="cpu")
    calls = []

    def score(x, sigma):
        calls.append(1)
        return _analytic_score(x, sigma)

    got = tm.generate_samples(SHAPE[0], noise=draws, score_fn=score).numpy()
    assert len(calls) == 10000 + final_denoise
    bound = 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


def test_langevin_through_the_unet_matches_jax(params):
    """2 levels × 2 steps through the C=32 UNet (σ 50 then 0.01):
    within 1e-4·max|x| + 1e-4·|ref|; the first level's steps of 5000
    multiply the network's f32 rounding."""
    jm = JaxScore(dict(CFG, num_scales=2, langevin_steps=2))
    want, draws = jax.device_get(jax.jit(lambda p, rng: (
        jm.generate_samples(p, rng, 2),
        _langevin_draws(rng, 2, 2, (2, 32, 32, 3))))(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.random.PRNGKey(8)))
    tm = _port(params, num_scales=2, langevin_steps=2)
    got = tm.generate_samples(2, noise=list(torch.from_numpy(draws))
                              ).numpy()
    bound = 1e-4 * np.abs(want).max() + 1e-4 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


def test_sampler_draws_and_intermediates():
    tm = ScoreBasedDiffusion(dict(CFG, model_channels=8, num_scales=3,
                                  langevin_steps=2), device="cpu")
    a = tm.generate_samples(2, torch.Generator().manual_seed(3))
    b = tm.generate_samples(2, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    frames = tm.generate_samples_with_intermediates(
        2, torch.Generator().manual_seed(3), save_interval=2)
    assert len(frames) == 3 and torch.equal(frames[-1], a)
    with pytest.raises(ValueError, match="initial noise has shape"):
        tm.generate_samples(2, noise=[torch.zeros(1, 32, 32, 3)])


# -- bridge and checkpoints ---------------------------------------------------

def test_bridge_roundtrip_and_checkpoint_through_jax(params, tmp_path):
    """The σ-UNet tree strict-loads and comes back bit for bit; a port
    checkpoint loads in JAX's ``load_with_config`` and a JAX checkpoint
    back in the port."""
    tm = _port(params)
    assert set(params["time_embedding"]) == {"dense1", "dense2"}
    assert params["time_embedding"]["dense1"]["kernel"].shape == (1, C)
    back = unet_params_to_jax(tm.net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)))
    path = str(tmp_path / "port.ckpt")
    tm.save(path)
    jm, jparams = JaxScore.load_with_config(path)
    assert jm.num_scales == 1000 and jm.config["model_channels"] == C
    jpath = str(tmp_path / "jax.ckpt")
    jm.save(jpath, jparams)
    with open(jpath, "rb") as f:
        assert isinstance(pickle.load(f)["model_state_dict"], dict)
    again = ScoreBasedDiffusion.load_with_config(jpath, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(unet_params_to_jax(again.net)),
        jax.tree_util.tree_leaves(params)))


# -- trainer and CLIs -------------------------------------------------------

TINY = {"model_channels": 8, "image_size": 32, "in_channels": 3,
        "compute_dtype": "float32", "num_scales": 2, "langevin_steps": 2,
        "dropout": 0.0}


def test_trainer_logs_and_steps(tmp_path):
    model = MODEL_REGISTRY["score_based"](TINY, device="cpu",
                                          trainable=True)
    cfg = {"training": {"learning_rate": 1e-3, "batch_size": 2},
           "output": {"output_dir": str(tmp_path)}}
    tr = TRAINER_REGISTRY["score_based"](model, [None], None, None, cfg)
    assert isinstance(tr, ScoreBasedTrainer)
    x = torch.zeros(2, 32, 32, 3)
    sigma, noise = torch.tensor([0.5, 20.0]), torch.randn(2, 32, 32, 3)
    want = model.loss_function(x, sigma=sigma, noise=noise).item()
    m = tr.step(x, sigma=sigma, noise=noise)
    assert float(m["loss"]) == pytest.approx(want, rel=1e-6)
    assert tr.step_count == 1 and torch.isfinite(m["grad_norm"])
    assert tr.generate_samples(0).endswith("epoch_0.png")
    tr.cleanup()
    logged = [json.loads(line) for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert any(d.get("score/sigma_min") == 0.01 and
               d.get("score/sigma_max") == 50.0 and d.get("score/beta") ==
               1.0 and d.get("score/num_scales") == 2 for d in logged)
    assert not any("diffusion/beta" in d for d in logged)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --model_type score_based`` for one epoch of 2 steps at a
    tiny config on the CPU; its config and final checkpoint."""
    tmp = tmp_path_factory.mktemp("score_cli")
    cfg = {"model_name": "ScoreBasedDiffusion", "model_config": TINY,
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
                           "score_based", "--device", "cpu"]) == 0
    assert (tmp / "run" / "samples" / "epoch_0.png").is_file()
    return tmp, str(path), str(tmp / "run" / "checkpoints" / "final_model")


def test_train_generate_serve_cli(trained):
    tmp, cfg, ckpt = trained
    out = tmp / "gen"
    assert gen_cli.main(["--config", cfg, "--model_type", "score_based",
                         "--checkpoint", ckpt, "--ema", "--device", "cpu",
                         "--num_samples", "2", "--output_dir",
                         str(out)]) == 0
    assert (out / "samples_grid.png").is_file()
    srv = make_server(build_argparser().parse_args([
        "--config", cfg, "--model_type", "score_based", "--checkpoint",
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
                ({"sampler": "dpm++"}, "needs an ε-prediction model")):
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
    (["--class_id", "1"], "--class_id unsupported for score_based models"),
    (["--inpaint_image", "x.npy"],
     "--inpaint_image unsupported for score_based models (ddpm/ddim only)"),
    (["--sampler", "heun"],
     "--sampler heun needs an ε-prediction model (ddpm/ddim), got "
     "score_based")])
def test_generate_refuses_what_the_reference_refuses(trained, extra,
                                                     fragment):
    _, cfg, ckpt = trained
    with pytest.raises(SystemExit) as e:
        gen_cli.main(["--config", cfg, "--model_type", "score_based",
                      "--checkpoint", ckpt, "--device", "cpu"] + extra)
    assert fragment in str(e.value)
