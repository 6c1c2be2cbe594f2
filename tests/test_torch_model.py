"""The port's layers, UNet, DDPM and weight bridge against the JAX
package, on the CPU, in f32, at a small size (C=32, 32², T=8, B=2).

The blocks' weights are made by the JAX initializers (each init and
apply one compiled program), the whole UNet's by the port's (JAX's
compiled init of the UNet alone costs about 13 s of CPU); then every leaf
gets seeded noise (so zero-initialized ``conv2``/``time_proj``
contribute), and they cross between the packages through
``models/convert.py``. Inputs and sampler noise are made with numpy and
fed to both packages.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import noop_context_fn

from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.models.layers import attention as jattn
from diffusion_model_universal_tpu.models.layers import resnet as jresnet
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models.convert import (
    unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.models.layers import (
    AttentionUpBlock, ConvUpBlock, ResidualBlock, SelfAttentionBlock)
from diffusion_model_universal_torch.ops import attention as attn_ops
from diffusion_model_universal_torch.ops import group_norm as gn_ops

torch.set_num_threads(2)

C, T, B = 32, 8, 2
CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
       "in_channels": 3, "compute_dtype": "float32", "remat": False}


def _perturb(tree, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.standard_normal(p.shape).astype(np.float32), tree)


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy → NCHW torch view in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _tree_equal(a, b) -> bool:
    if jax.tree_util.tree_structure(a) != jax.tree_util.tree_structure(b):
        return False
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
               zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


# -- layers -------------------------------------------------------------

def _block_case(name):
    """(jax module, port module, x channels, skip channels)."""
    if name == "residual":
        return (jresnet.ResidualBlock(64), ResidualBlock(32, 64, 4 * C),
                32, 0)
    if name == "up_split":        # 64 % (128 // 32) == 0: split GN/convs
        return (jresnet.ConvUpBlock(64),
                ConvUpBlock(64, 64, 4 * C, skip_channels=64), 64, 64)
    if name == "up_concat":       # 64 % (96 // 32) != 0: real concat
        return (jresnet.ConvUpBlock(32),
                ConvUpBlock(64, 32, 4 * C, skip_channels=32), 64, 32)
    if name == "attn_up_concat":  # up1's case: 128 % (192 // 32) != 0
        return (jresnet.AttentionUpBlock(64, num_att_heads=4),
                AttentionUpBlock(128, 64, 4 * C, num_att_heads=4,
                                 skip_channels=64), 128, 64)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["residual", "up_split", "up_concat",
                                  "attn_up_concat"])
def test_blocks_match_jax(name):
    jmod, tmod, cx, cs = _block_case(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 4, 4, cx)).astype(np.float32)
    temb = rng.standard_normal((B, 4 * C)).astype(np.float32)
    skip = (rng.standard_normal((B, 4, 4, cs)).astype(np.float32)
            if cs else None)
    args = (jnp.asarray(x), jnp.asarray(temb)) + (
        (jnp.asarray(skip),) if cs else ())

    def init(key, x, temb, *skip):
        return jmod.init(key, x, temb, True, *skip)

    def apply(p, x, temb, *skip):
        return jmod.apply({"params": p}, x, temb, True, *skip)

    params = _perturb(jax.jit(init)(jax.random.PRNGKey(0), *args)["params"],
                      2)
    ref = np.asarray(jax.jit(apply)(params, *args))
    tmod.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = tmod(_nchw(x), torch.from_numpy(temb),
                   *((_nchw(skip),) if cs else ()))
    if cs:
        assert tmod.res0.split == (name == "up_split")
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4, rtol=1e-4)


def test_self_attention_block_matches_jax():
    jmod = jattn.SelfAttentionBlock(64, num_heads=4)
    x = np.random.default_rng(3).standard_normal((B, 4, 4, 64)).astype(
        np.float32)
    params = _perturb(jax.jit(jmod.init)(jax.random.PRNGKey(1),
                                         jnp.asarray(x))["params"], 4)
    ref = np.asarray(jax.jit(lambda p, x: jmod.apply({"params": p}, x))(
        params, jnp.asarray(x)))
    tmod = SelfAttentionBlock(64, num_heads=4)
    tmod.load_state_dict(unet_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        out = tmod(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-4, rtol=1e-4)


# -- whole model ----------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(jax DDPM, the port's initial weights perturbed as the flax tree,
    port DDPM with those weights)."""
    jm = JaxDDPM(CFG)
    tm = DDPM(CFG, device="cpu")
    params = _perturb(unet_params_to_jax(tm.net), 0)
    tm.load_params(params)
    return jm, params, tm


def test_unet_tree_matches_jax_init(models):
    """The flax tree the port's UNet crosses to (the fixture's weights)
    has the leaves and shapes of JAX's own ``init_params`` tree
    (``jax.eval_shape``: nothing compiled)."""
    jm, params, _ = models

    def shapes(tree):
        return {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf
                in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = shapes(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)))
    assert shapes(params) == want and len(want) > 100


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            np.array([0, 5], np.int32))


def test_ddpm_apply_matches_jax(models):
    jm, params, tm = models
    x, t = _inputs()
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(x), torch.from_numpy(t).long())
    assert out.dtype == torch.float32 and out.shape == (B, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_split_skip_convs_false_matches_jax(models):
    """``split_skip_convs: false``: every up stage takes the real concat
    of its skip into one GroupNorm and conv, against the reference's UNet
    with the same flag, on the same parameter tree: 1e-4 + 1e-4·|ref|.
    A forward then calls the GroupNorm op 50 times (no split halves)."""
    _, params, _ = models
    cfg = dict(CFG, split_skip_convs=False)
    jm = JaxDDPM(cfg)
    x, t = _inputs(7)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(t)))
    tm = DDPM(cfg, device="cpu")
    tm.load_params(params)
    assert not any(getattr(m, "split", False) for m in tm.net.modules())
    calls = []
    gn = gn_ops.group_norm_silu
    gn_ops.group_norm_silu = lambda *a, **k: calls.append(1) or gn(*a, **k)
    try:
        with torch.no_grad():
            out = tm.apply(torch.from_numpy(x), torch.from_numpy(t).long())
    finally:
        gn_ops.group_norm_silu = gn
    assert len(calls) == 50
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v", "x0"])
def test_eps_fn_matches_jax_for_each_prediction_type(models,
                                                     prediction_type):
    _, params, _ = models
    cfg = dict(CFG, prediction_type=prediction_type)
    jm = JaxDDPM(cfg)
    tm = DDPM(cfg, device="cpu")
    tm.load_params(params)
    x, t = _inputs(2)
    ref = np.asarray(jax.jit(lambda p, x, t: jm.eps_fn(p)(x, t))(
        params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = tm.eps_fn()(torch.from_numpy(x), torch.from_numpy(t).long())
    # x0: ε̂ = (x − √ᾱ·out)/√(1−ᾱ) scales the network's f32 rounding by
    # 1/√(1−ᾱ_t), which is 1/√β₀ = 100 at t = 0.
    tol = 1e-4
    if prediction_type == "x0":
        tol /= float(tm.schedule.sqrt_one_minus_alphas_cumprod[
            torch.from_numpy(t).long()].min())
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_step(models):
    """The JAX model's posterior step, compiled once for the module."""
    jm = models[0]
    return jax.jit(lambda p, x, t, n: jm.posterior_step_fn(p)(x, t, n))


def test_posterior_step_matches_jax(models, jax_step):
    jm, params, tm = models
    x, t = _inputs(3)
    noise = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    ref = np.asarray(jax_step(params, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(noise)))
    with torch.no_grad():
        out = tm.posterior_step_fn()(torch.from_numpy(x),
                                     torch.from_numpy(t).long(),
                                     torch.from_numpy(noise))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_sampler_matches_jax_on_injected_noise(models, jax_step):
    """All T=8 ancestral steps, the same draws fed to both packages."""
    jm, params, tm = models
    rng = np.random.default_rng(5)
    draws = [rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
             for _ in range(T + 1)]
    step = jax_step
    x = jnp.asarray(draws[0])
    for i, t in enumerate(range(T - 1, -1, -1)):
        x = step(params, x, jnp.full((B,), t, jnp.int32),
                 jnp.asarray(draws[i + 1]))
    out = tm.generate_samples(B, noise=[torch.from_numpy(d) for d in draws])
    assert out.shape == (B, 32, 32, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(x), atol=1e-4,
                               rtol=1e-4)


def test_sampler_draws_from_generator_deterministically():
    cfg = dict(CFG, model_channels=8, num_timesteps=3)
    tm = DDPM(cfg, device="cpu")
    a = tm.generate_samples(2, torch.Generator().manual_seed(7))
    b = tm.generate_samples(2, torch.Generator().manual_seed(7))
    c = tm.generate_samples(2, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


def test_launches_per_forward(models, monkeypatch):
    """One UNet forward calls the GroupNorm op 53 times (44 in the 22
    ResidualBlocks, 3 more for the split skip halves at up0/up2/up4, 5
    after attention, 1 in the output head) and attention 5 times."""
    _, _, tm = models
    calls = {"gn": 0, "mha": 0}
    gn, mha = gn_ops.group_norm_silu, attn_ops.multi_head_attention

    def count_gn(*a, **k):
        calls["gn"] += 1
        return gn(*a, **k)

    def count_mha(*a, **k):
        calls["mha"] += 1
        return mha(*a, **k)

    monkeypatch.setattr(gn_ops, "group_norm_silu", count_gn)
    monkeypatch.setattr(attn_ops, "multi_head_attention", count_mha)
    x, t = _inputs()
    with torch.no_grad():
        tm.apply(torch.from_numpy(x), torch.from_numpy(t).long())
    assert calls == {"gn": 53, "mha": 5}


def test_unet_rejects_small_images(models):
    with pytest.raises(ValueError, match="≥ 32"):
        models[2].apply(torch.zeros(1, 16, 16, 3), torch.zeros(1).long())


# -- weight bridge and checkpoints -----------------------------------------

@pytest.mark.parametrize("num_classes", [0, 3])
def test_bridge_roundtrip_and_strict_load(models, num_classes):
    """The JAX tree strict-loads into the port and comes back bit for bit;
    a conditional tree adds flax's ``label_embedding.embedding`` leaf."""
    jm, params, _ = models
    params = dict(params)
    if num_classes:
        params["label_embedding"] = {"embedding": np.random.default_rng(
            6).standard_normal((num_classes + 1, 4 * C)).astype(np.float32)}
    tm = DDPM(dict(CFG, num_classes=num_classes), device="cpu")
    missing, unexpected = tm.net.load_state_dict(
        unet_state_dict_from_jax(params), strict=True)
    assert not missing and not unexpected
    assert _tree_equal(unet_params_to_jax(tm.net), params)


def test_port_checkpoint_loads_in_jax_and_back(models, tmp_path):
    jm, params, tm = models
    path = str(tmp_path / "port.ckpt")
    tm.save(path)
    jmodel, jparams = JaxDDPM.load_with_config(path)
    assert jmodel.config["model_channels"] == C
    assert _tree_equal(jax.tree_util.tree_map(np.asarray, jparams), params)

    jpath = str(tmp_path / "jax.ckpt")
    jm.save(jpath, params)
    with open(jpath, "rb") as f:
        assert isinstance(pickle.load(f)["model_state_dict"], dict)
    back = DDPM.load_with_config(jpath, device="cpu")
    assert _tree_equal(unet_params_to_jax(back.net), params)


def test_compute_dtype_keeps_group_norm_params_f32():
    tm = DDPM(dict(CFG, model_channels=8, compute_dtype="bfloat16"),
              device="cpu")
    assert tm.net.initial_conv.weight.dtype == torch.bfloat16
    assert tm.net.down0.res0.conv1.weight.dtype == torch.bfloat16
    assert tm.net.mid_attn.query.weight.dtype == torch.bfloat16
    assert tm.net.down0.res0.norm1.weight.dtype == torch.float32
    assert tm.net.mid_attn.norm_scale.dtype == torch.float32
    assert DDPM(dict(CFG, compute_dtype=None, model_channels=8),
                device="cpu").compute_dtype == torch.float32
    with torch.no_grad():
        out = tm.apply(torch.zeros(1, 32, 32, 3), torch.zeros(1).long())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_cuda_is_the_default_and_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DDPM(dict(CFG, model_channels=8))


def test_not_ported_options_raise():
    """learn_sigma runs (its learned posterior step is held against JAX in
    tests/test_torch_samplers.py); remat_policy: save_convout, once
    refused here, builds a rematted UNet with a selective checkpoint
    (tests/test_torch_train_options.py holds its gradients), and an
    unknown policy raises."""
    tm = DDPM(dict(CFG, model_channels=8, learn_sigma=True), device="cpu")
    x = torch.zeros(1, 32, 32, 3)
    with torch.no_grad():
        out = tm.posterior_step_fn()(x, torch.ones(1).long(), x)
    assert out.shape == x.shape and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="requires learn_sigma=true"):
        DDPM(dict(CFG, model_channels=8), device="cpu").mean_var_fn()
    net = DDPM(dict(CFG, model_channels=8, remat=False,
                    remat_policy="save_convout"), device="cpu").net
    assert net.remat and net._remat_context is not noop_context_fn
    with pytest.raises(ValueError, match="must be 'full' or 'save_convout'"):
        DDPM(dict(CFG, remat_policy="save_everything"), device="cpu")
