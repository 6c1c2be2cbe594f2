"""The port's DDIM, fast samplers, classifier-free guidance, inpainting and
learned variance against the JAX package, on the CPU.

* whole trajectories at T = 1000 on an analytic ε-model (the one of
  ``tests/test_models.py``), the same x_T and draws fed to both packages:
  DDIM-50, DPM++-20, Heun-18, strided-100, CFG ancestral, inpainting and
  the learned-variance step; tolerance 1e-4 absolute + 1e-4 relative;
* a real UNet at C=32 through ``models/convert.py``: DDIM S=4, DPM++ S=4,
  CFG ``eps_fn`` at scale 3, the learned posterior step, the hybrid loss
  and its gradient norm, and ``nll_bits_per_dim`` at T=10;
* the serving and CLI surfaces: the request fields and the reference's
  error messages.

The JAX draws are made with the reference's own key splitting; no
full-width JAX model is compiled. The schedule tables and ``ddim_step``
are held in ``tests/test_torch_sampler_tables.py``.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusion_model_universal_tpu.models import DDIM as JaxDDIM
from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_torch.models import DDIM, DDPM, MODEL_REGISTRY
from diffusion_model_universal_torch.models.convert import unet_params_to_jax
from diffusion_model_universal_torch.scripts import generate as gen_cli
from diffusion_model_universal_torch.scripts import train as train_cli
from diffusion_model_universal_torch.scripts.serve import (build_argparser,
                                                           make_server)
from diffusion_model_universal_torch.trainers import TRAINER_REGISTRY

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)
SHAPE = (2, 8, 8, 3)


# -- whole trajectories on an analytic ε-model -------------------------------

def _analytic_eps(x, t, y):
    """ε̂ = 0.3·x + 0.01·(t+1) (+ 0.02·y), as tests/test_models.py."""
    tb = t.astype(x.dtype)[:, None, None, None] if hasattr(t, "astype") \
        else t.to(x.dtype)[:, None, None, None]
    eps = 0.3 * x + 0.01 * (tb + 1.0)
    if y is not None:
        yy = y.astype(x.dtype) if hasattr(y, "astype") else y.to(x.dtype)
        eps = eps + 0.02 * yy[:, None, None, None]
    return eps


class _JaxAnalytic:
    def apply(self, params, x, t, train=False, rng=None, y=None):
        eps = _analytic_eps(x, t, y)
        if self.learn_sigma:   # a variance head: tanh of the same ε̂
            return jnp.concatenate([eps, jnp.tanh(eps)], axis=-1)
        return eps


class _PortAnalytic:
    def apply(self, x, t, y=None, train=False):
        eps = _analytic_eps(x, t, y)
        if self.learn_sigma:
            return torch.cat([eps, torch.tanh(eps)], dim=-1)
        return eps


class JaxAnalyticDDPM(_JaxAnalytic, JaxDDPM):
    pass


class JaxAnalyticDDIM(_JaxAnalytic, JaxDDIM):
    pass


class PortAnalyticDDPM(_PortAnalytic, DDPM):
    pass


class PortAnalyticDDIM(_PortAnalytic, DDIM):
    pass


ANALYTIC = {"num_timesteps": 1000, "image_size": 8, "in_channels": 3,
            "model_channels": 32, "num_classes": 10}


def _analytic(cls_j, cls_t, **cfg):
    cfg = dict(ANALYTIC, **cfg)
    return cls_j(cfg), cls_t(dict(cfg, model_channels=8), device="cpu")


def _jax_draws(rng, steps: int, per_step: int = 1):
    """x_T and every step's draws as the reference's samplers make them:
    (k_init, k_loop) = split(rng), x_T ~ k_init, then per step key, k… =
    split(key, 1 + per_step), one normal per k."""
    k_init, key = jax.random.split(rng)

    def body(key, _):
        keys = jax.random.split(key, 1 + per_step)
        return keys[0], jnp.stack([jax.random.normal(k, SHAPE)
                                   for k in keys[1:]])

    _, d = jax.lax.scan(body, key, None, length=steps)
    d = np.asarray(d).reshape(steps * per_step, *SHAPE)
    return [torch.from_numpy(np.asarray(jax.random.normal(k_init, SHAPE)))] \
        + [torch.from_numpy(a) for a in d]


def _labels():
    return np.array([3, 7], np.int32)


@pytest.mark.parametrize("name", ["ddim50", "ddim50_eta", "dpm20", "heun18",
                                  "strided100", "cfg_ancestral",
                                  "ddim_cfg", "strided_learned"])
def test_trajectory_matches_jax_on_analytic_model(name):
    rng = jax.random.PRNGKey(11)
    y = _labels()
    if name.startswith("ddim"):
        eta = 0.5 if name == "ddim50_eta" else 0.0
        jm, tm = _analytic(JaxAnalyticDDIM, PortAnalyticDDIM, eta=eta,
                           ddim_sampling_steps=50)
        draws = _jax_draws(rng, 50)
        if name == "ddim_cfg":
            want = jm.generate_samples_cfg({}, rng, 2, jnp.asarray(y), 3.0)
            got = tm.generate_samples_cfg(2, torch.from_numpy(y).long(), 3.0,
                                          noise=draws[:1])
        else:
            want = jm.generate_samples({}, rng, 2)
            got = tm.generate_samples(2, noise=draws if eta else draws[:1])
    elif name == "dpm20":
        jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM)
        want = jm.generate_samples_dpm({}, rng, 2, 20)
        got = tm.generate_samples_dpm(2, 20, noise=_jax_draws(rng, 0))
    elif name == "heun18":
        jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM)
        want = jm.generate_samples_heun({}, rng, 2, 18)
        got = tm.generate_samples_heun(2, 18, noise=_jax_draws(rng, 0))
    elif name.startswith("strided"):
        learned = name == "strided_learned"
        jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM,
                           learn_sigma=learned)
        want = jm.generate_samples_strided({}, rng, 2, 100)
        got = tm.generate_samples_strided(2, 100,
                                          noise=_jax_draws(rng, 100))
    else:   # CFG through the 1000-step ancestral sampler
        jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM)
        want = jm.generate_samples_cfg({}, rng, 2, jnp.asarray(y), 3.0)
        got = tm.generate_samples_cfg(2, torch.from_numpy(y).long(), 3.0,
                                      noise=_jax_draws(rng, 1000))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("learned", [False, True])
def test_inpainting_matches_jax_on_analytic_model(learned):
    rng = jax.random.PRNGKey(12)
    jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM,
                       learn_sigma=learned)
    r = np.random.default_rng(3)
    image = np.clip(r.standard_normal(SHAPE), -1, 1).astype(np.float32)
    mask = np.zeros((1, 8, 8, 1), np.float32)
    mask[:, :, :4] = 1.0
    y = _labels()
    want = jm.generate_samples_inpaint({}, rng, jnp.asarray(image),
                                       jnp.asarray(mask), jnp.asarray(y), 2.0)
    got = tm.generate_samples_inpaint(
        torch.from_numpy(image), torch.from_numpy(mask),
        torch.from_numpy(y).long(), 2.0,
        noise=_jax_draws(rng, 1000, per_step=2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[:, :, :4], image[:, :, :4])


def test_learned_variance_ancestral_matches_jax_on_analytic_model():
    rng = jax.random.PRNGKey(13)
    jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM, learn_sigma=True)
    want = jm.generate_samples({}, rng, 2)
    got = tm.generate_samples(2, noise=_jax_draws(rng, 1000))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sampler_argument_errors_match_jax():
    jm, tm = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM)
    ju, tu = _analytic(JaxAnalyticDDPM, PortAnalyticDDPM, num_classes=0)

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    cases = [
        (lambda: jm.generate_samples_dpm({}, jax.random.PRNGKey(0), 2, 1),
         lambda: tm.generate_samples_dpm(2, 1)),
        (lambda: jm.generate_samples_heun({}, jax.random.PRNGKey(0), 2,
                                          1001),
         lambda: tm.generate_samples_heun(2, 1001)),
        (lambda: jm.generate_samples_strided({}, jax.random.PRNGKey(0), 2,
                                             1),
         lambda: tm.generate_samples_strided(2, 1)),
        (lambda: jm.make_class_labels(10, 2),
         lambda: tm.make_class_labels(10, 2)),
        (lambda: ju.make_class_labels(0, 2),
         lambda: tu.make_class_labels(0, 2)),
        (lambda: ju.eps_fn({}, jnp.zeros(2, jnp.int32)),
         lambda: tu.eps_fn(torch.zeros(2).long())),
        (lambda: jm.eps_fn({}, None, 2.0), lambda: tm.eps_fn(None, 2.0)),
        (lambda: jm.mean_var_fn({}), lambda: tm.mean_var_fn()),
    ]
    for jfn, tfn in cases:
        assert message(tfn) == message(jfn)


# -- a real UNet at C=32 ------------------------------------------------------

C32 = {"model_channels": 32, "num_timesteps": 10, "image_size": 32,
       "in_channels": 3, "compute_dtype": "float32", "remat": False,
       "dropout": 0.0, "ddim_sampling_steps": 4, "num_classes": 10}
UNET_SHAPE = (2, 32, 32, 3)


@pytest.fixture(scope="module")
def unet_params():
    """Seeded port weights (every leaf, the zero-initialized ones too) as
    the flax tree both packages load."""
    m = DDPM(dict(C32, learn_sigma=True), device="cpu", seed=3)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in m.net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return unet_params_to_jax(m.net)


def _real(cls_j, cls_t, params, **cfg):
    cfg = dict(C32, **cfg)
    params = dict(params)
    if not cfg.get("learn_sigma"):
        params["output_conv"] = {k: v[..., :3] for k, v in
                                 params["output_conv"].items()}
    if not cfg.get("num_classes"):
        del params["label_embedding"]
    tm = cls_t(cfg, device="cpu")
    tm.load_params(params)
    return cls_j(cfg), params, tm


def _unet_draws(rng, steps):
    k_init, key = jax.random.split(rng)
    out = [jax.random.normal(k_init, UNET_SHAPE)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(jax.random.normal(k, UNET_SHAPE))
    return [torch.from_numpy(np.asarray(a)) for a in out]


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_fast_samplers_match_jax_on_a_real_unet(unet_params, sampler):
    rng = jax.random.PRNGKey(21)
    if sampler == "ddim":
        jm, p, tm = _real(JaxDDIM, DDIM, unet_params, eta=0.5)
        want = jm.generate_samples(p, rng, 2)
        got = tm.generate_samples(2, noise=_unet_draws(rng, 4))
    else:
        jm, p, tm = _real(JaxDDPM, DDPM, unet_params)
        want = jm.generate_samples_dpm(p, rng, 2, 4)
        got = tm.generate_samples_dpm(2, 4, noise=_unet_draws(rng, 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cfg_eps_and_learned_step_match_jax_on_a_real_unet(unet_params):
    jm, p, tm = _real(JaxDDPM, DDPM, unet_params, learn_sigma=True,
                      prediction_type="v")
    r = np.random.default_rng(22)
    x = r.standard_normal(UNET_SHAPE).astype(np.float32)
    noise = r.standard_normal(UNET_SHAPE).astype(np.float32)
    t = np.array([9, 4], np.int32)
    y = _labels()
    want_eps, want_step = jax.jit(lambda p, x, t, y, n: (
        jm.eps_fn(p, y, 3.0)(x, t),
        jm.posterior_step_fn(p, y, 3.0)(x, t, n)))(
            p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
            jnp.asarray(noise))
    args = (torch.from_numpy(x), torch.from_numpy(t).long())
    yy = torch.from_numpy(y).long()
    with torch.no_grad():
        got_eps = tm.eps_fn(yy, 3.0)(*args)
        got_step = tm.posterior_step_fn(yy, 3.0)(*args,
                                                 torch.from_numpy(noise))
    np.testing.assert_allclose(got_eps.numpy(), np.asarray(want_eps), **TOL)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step),
                               **TOL)


def _loss_draws(rng, b, T, shape):
    """(t, ε) as the reference's loss_function draws them."""
    kt, kn, _ = jax.random.split(rng, 3)
    return (torch.from_numpy(np.asarray(jax.random.randint(kt, (b,), 0, T))
                             ).long(),
            torch.from_numpy(np.asarray(jax.random.normal(kn, shape))))


def test_hybrid_loss_matches_jax_on_a_real_unet(unet_params):
    cfg = dict(C32, learn_sigma=True, num_classes=0, vlb_weight=0.1)
    jm, p, _ = _real(JaxDDPM, DDPM, unet_params, **cfg)
    tm = DDPM(dict(C32, **cfg), device="cpu", trainable=True)
    tm.load_params(p)
    x = np.clip(np.random.default_rng(23).standard_normal(UNET_SHAPE), -1,
                1).astype(np.float32)
    rng = jax.random.PRNGKey(24)
    want = jax.jit(jm.loss_function)(p, jnp.asarray(x), rng)
    with torch.no_grad():
        got = tm.loss_function(torch.from_numpy(x),
                               *_loss_draws(rng, 2, 10, UNET_SHAPE))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


class _JaxOut(JaxDDPM):
    """The network's output is the parameter itself: gradients of the
    loss with respect to the raw output."""

    def apply(self, params, x, t, train=False, rng=None, y=None):
        return params["out"] + 0.0 * x[..., :1]


class _PortOut(DDPM):
    def apply(self, x, t, y=None, train=False):
        return self.out + 0.0 * x[..., :1]


@pytest.mark.parametrize("prediction_type", ["epsilon", "v"])
def test_hybrid_loss_gradient_matches_jax(prediction_type):
    """The hybrid loss and its gradient with respect to the network's
    2C-channel output: the VLB half reaches only the variance channels
    (the mean it sees is detached), the prediction half only the simple
    loss's."""
    cfg = dict(C32, model_channels=8, learn_sigma=True, num_classes=0,
               vlb_weight=0.5, prediction_type=prediction_type,
               num_timesteps=10)
    r = np.random.default_rng(27)
    out = r.standard_normal((2, 32, 32, 6)).astype(np.float32)
    x = np.clip(r.standard_normal(UNET_SHAPE), -1, 1).astype(np.float32)
    rng = jax.random.PRNGKey(28)
    jm = _JaxOut(cfg)
    loss, grad = jax.value_and_grad(
        lambda o: jm.loss_function({"out": o}, jnp.asarray(x), rng))(
            jnp.asarray(out))
    tm = _PortOut(cfg, device="cpu")
    tm.out = torch.from_numpy(out).requires_grad_()
    got = tm.loss_function(torch.from_numpy(x),
                           *_loss_draws(rng, 2, 10, UNET_SHAPE))
    (tgrad,) = torch.autograd.grad(got, [tm.out])
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(grad), rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(float(tgrad.norm()),
                               float(jnp.linalg.norm(grad)), rtol=1e-5)
    simple = _PortOut(dict(cfg, vlb_weight=0.0), device="cpu")
    simple.out = tm.out
    (sgrad,) = torch.autograd.grad(simple.loss_function(
        torch.from_numpy(x), *_loss_draws(rng, 2, 10, UNET_SHAPE)),
        [tm.out])
    np.testing.assert_array_equal(tgrad[..., :3].numpy(),
                                  sgrad[..., :3].numpy())
    assert not torch.equal(tgrad[..., 3:], sgrad[..., 3:])


@pytest.mark.parametrize("learned", [False, True])
def test_nll_bits_per_dim_matches_jax(unet_params, learned):
    jm, p, tm = _real(JaxDDPM, DDPM, unet_params, learn_sigma=learned,
                      num_classes=0)
    r = np.random.default_rng(25)
    x = np.clip(r.standard_normal(UNET_SHAPE) * 0.5, -1, 1).astype(
        np.float32)
    rng = jax.random.PRNGKey(26)
    want = jm.nll_bits_per_dim(p, jnp.asarray(x), rng)
    draws, key = [], rng
    for _ in range(10):
        key, k = jax.random.split(key)
        draws.append(torch.from_numpy(np.asarray(
            jax.random.normal(k, UNET_SHAPE))))
    got = tm.nll_bits_per_dim(torch.from_numpy(x), noise=draws)
    assert got.shape == (2,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)


def test_ddim_intermediates_one_frame_per_saved_position():
    m = DDIM(dict(C32, model_channels=8, num_classes=0,
                  ddim_sampling_steps=5), device="cpu")
    frames = m.generate_samples_with_intermediates(
        1, torch.Generator().manual_seed(0))
    # x_T, then after positions 4, 2 and 0.
    assert len(frames) == 4
    assert all(f.shape == (1, 32, 32, 3) for f in frames)


# -- serving and the CLIs ----------------------------------------------------

TINY = {"num_timesteps": 10, "image_size": 32, "in_channels": 3,
        "model_channels": 8, "compute_dtype": "float32",
        "ddim_sampling_steps": 4}


@pytest.fixture(scope="module")
def ddim_files(tmp_path_factory):
    """A conditional and an unconditional DDIM checkpoint, and a config."""
    tmp = tmp_path_factory.mktemp("ddim")
    cond, uncond = str(tmp / "cond.ckpt"), str(tmp / "uncond.ckpt")
    for path, cfg, seed in ((cond, dict(TINY, num_classes=10), 1),
                            (uncond, TINY, 2)):
        m = DDIM(cfg, device="cpu", seed=seed)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():   # the zero-initialized head too
            for p in m.net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        m.save(path)
    cfg_path = tmp / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"model_config": TINY}))
    return str(cfg_path), cond, uncond, tmp


def _serve(cfg_path, ckpt):
    import threading
    srv = make_server(build_argparser().parse_args([
        "--config", cfg_path, "--model_type", "ddim", "--checkpoint", ckpt,
        "--port", "0", "--serve_batch", "2", "--device", "cpu"]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _request(srv, body):
    host, port = srv.server_address[:2]
    req = urllib.request.Request(
        f"http://{host}:{port}/generate",
        data=json.dumps(dict(body, format="npy")).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            import io
            return 200, np.load(io.BytesIO(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]


@pytest.fixture(scope="module")
def servers(ddim_files):
    cfg_path, cond, uncond, _ = ddim_files
    pairs = [_serve(cfg_path, cond), _serve(cfg_path, uncond)]
    yield pairs[0][0], pairs[1][0]
    for srv, thread in pairs:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def test_server_runs_every_sampler_and_cfg(servers):
    cond, _ = servers
    model = cond.service.model
    outs = {}
    for name, body in {
            "default": {},
            "dpm++": {"sampler": "dpm++", "sampler_steps": 3},
            "heun": {"sampler": "heun", "sampler_steps": 3},
            "strided": {"sampler": "strided", "sampler_steps": 4},
            "cfg": {"class_id": 3, "guidance_scale": 3.0},
            "cfg_dpm": {"class_id": 3, "sampler": "dpm++",
                        "sampler_steps": 3}}.items():
        code, arr = _request(cond, dict(body, num_samples=2, seed=5))
        assert code == 200 and arr.shape == (2, 32, 32, 3), (name, arr)
        assert np.isfinite(arr).all()
        outs[name] = arr
    # Each request is the model's own sampler on a generator seeded 5.
    gen = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(outs["dpm++"], model.generate_samples_dpm(
        2, 3, generator=gen).numpy())
    gen = torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(outs["cfg"], model.generate_samples_cfg(
        2, model.make_class_labels(3, 2), 3.0, generator=gen).numpy())
    assert len({a.tobytes() for a in outs.values()}) == len(outs)


def test_server_errors_match_the_reference(servers):
    cond, uncond = servers
    jm = JaxDDIM(dict(TINY, num_classes=10))
    ju = JaxDDIM(TINY)

    def jax_error(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    for srv, body, want in [
            (cond, {"sampler": "euler"},
             "sampler must be one of ('default', 'dpm++', 'heun', "
             "'strided') (got 'euler')"),
            (cond, {"sampler": "dpm++", "sampler_steps": 1},
             jax_error(lambda: jm.generate_samples_dpm(
                 {}, jax.random.PRNGKey(0), 2, 1))),
            (cond, {"sampler": "heun", "sampler_steps": 11},
             jax_error(lambda: jm.generate_samples_heun(
                 {}, jax.random.PRNGKey(0), 2, 11))),
            (cond, {"class_id": 10},
             jax_error(lambda: jm.make_class_labels(10, 2))),
            (uncond, {"class_id": 0},
             jax_error(lambda: ju.make_class_labels(0, 2))),
            (cond, {"class_id": 1, "guidance_scale": "x"},
             "could not convert string to float: 'x'")]:
        assert _request(srv, dict(body, num_samples=2)) == (400, want)


def test_ddim_generate_cli_samplers_cfg_and_inpainting(ddim_files, capsys):
    cfg_path, cond, uncond, tmp = ddim_files
    base = ["--config", cfg_path, "--model_type", "ddim", "--device", "cpu",
            "--num_samples", "2", "--grid_only"]
    runs = {"default": [], "dpm": ["--sampler", "dpm++",
                                   "--sampler_steps", "3"],
            "heun": ["--sampler", "heun", "--sampler_steps", "3"],
            "strided": ["--sampler", "strided", "--sampler_steps", "4"],
            "cfg": ["--class_id", "3", "--guidance_scale", "2.0"]}
    for name, extra in runs.items():
        out = tmp / name
        ckpt = cond if name == "cfg" else uncond
        assert gen_cli.main(base + ["--checkpoint", ckpt, "--output_dir",
                                    str(out)] + extra) == 0
        assert (out / "samples_grid.png").is_file()
    image = np.zeros((32, 32, 3), np.float32)
    image[:, :16] = 0.5
    mask = np.zeros((32, 32), np.float32)
    mask[:, :16] = 1.0
    np.save(tmp / "image.npy", image)
    np.save(tmp / "mask.npy", mask)
    inpaint = ["--inpaint_image", str(tmp / "image.npy"), "--inpaint_mask",
               str(tmp / "mask.npy")]
    assert gen_cli.main(base + ["--checkpoint", cond, "--class_id", "1",
                                "--output_dir", str(tmp / "inp")]
                        + inpaint) == 0
    capsys.readouterr()
    for extra, fragment in [
            (["--inpaint_image", str(tmp / "image.npy")],
             "--inpaint_image requires --inpaint_mask"),
            (inpaint + ["--sampler", "dpm++"],
             "--inpaint_image uses the ancestral sampler; drop --sampler"),
            (["--class_id", "0"], "--class_id: model is unconditional"),
            (["--sampler", "dpm++", "--sampler_steps", "1"],
             "--sampler dpm++: num_steps must be in [2, 10]"),
            # --num_devices > 1, once refused, now spawns the ranks
            # (tests/test_torch_parallel.py samples over two), after the
            # refusals that need no model.
            (["--num_devices", "2", "--inpaint_image",
              str(tmp / "image.npy")],
             "--inpaint_image requires --inpaint_mask")]:
        with pytest.raises(SystemExit) as e:
            gen_cli.main(base + ["--checkpoint", uncond] + extra)
        assert fragment in str(e.value)


def test_ddim_train_cli_logs_its_sampler_and_draws_ddim_grids(tmp_path):
    cfg = {"model_name": "DDIM",
           "model_config": dict(TINY, model_channels=32,
                                ddim_sampling_steps=5),
           "training": {"num_epochs": 1, "batch_size": 4,
                        "learning_rate": 1e-3, "ema_decay": 0.99,
                        "val_interval": 100, "sample_interval": 1,
                        "checkpoint_interval": 10},
           "data": {"dataset": "synthetic", "data_dir": "unused",
                    "num_samples": 8},
           "output": {"output_dir": str(tmp_path / "run")}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config", str(path), "--model_type", "ddim",
                           "--device", "cpu"]) == 0
    assert TRAINER_REGISTRY["ddim"].__name__ == "DDIMTrainer"
    assert MODEL_REGISTRY["ddim"] is DDIM
    logged = [json.loads(line) for line in (tmp_path / "run" /
                                             "metrics.jsonl").read_text()
              .splitlines()]
    assert any(d.get("ddim/sampling_steps") == 5 and d.get("ddim/eta") == 0.0
               for d in logged)
    from diffusion_model_universal_torch.utils.images import decode_png
    grid = decode_png((tmp_path / "run" / "samples" / "epoch_0.png")
                      .read_bytes())
    # 4 samples a row; x_T and positions 4, 2, 0: four columns.
    assert grid.shape == (4 * 34 + 2, 4 * 34 + 2, 3)


def test_learn_sigma_trains_through_the_cli(tmp_path):
    cfg = {"model_config": dict(TINY, learn_sigma=True),
           "training": {"num_epochs": 1, "batch_size": 4,
                        "learning_rate": 1e-3, "val_interval": 100,
                        "sample_interval": 0, "checkpoint_interval": 10},
           "data": {"dataset": "synthetic", "data_dir": "unused",
                    "num_samples": 8},
           "output": {"output_dir": str(tmp_path / "run")}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config", str(path), "--model_type", "ddpm",
                           "--device", "cpu"]) == 0
    losses = [json.loads(line)["train/loss"] for line in
              (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
              if "train/loss" in line]
    assert len(losses) >= 1 and np.isfinite(losses).all()
