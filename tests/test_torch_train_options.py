"""The port's trainer options against the JAX package, on the CPU, in f32,
at a small size (C=32, 32², T=8): gradient accumulation, the bf16 EMA
and Adam first moment, ``remat_policy: save_convout``, gradient and
weight histograms, and the profiler's step timer (``train --profile``
writing a trace is ``tests/test_torch_trainer.py``'s converted
``--profile`` cases).

One accumulated update (A=2, bf16 μ and EMA) is held against JAX's
``DDPMTrainer.accum_step`` on the same weights, micro-batches and the
t/noise JAX folds per micro-batch; this is the file's one JAX trainer
compile. The bf16 μ and EMA are also held against optax's and the
reference's formulas on their own, without a model.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffusion_model_universal_tpu.models import DDPM as JaxDDPM
from diffusion_model_universal_tpu.parallel.mesh import make_mesh
from diffusion_model_universal_tpu.trainers import DDPMTrainer as JaxTrainer
from diffusion_model_universal_torch.datasets import get_dataset
from diffusion_model_universal_torch.models import DDPM
from diffusion_model_universal_torch.models.convert import (
    state_dict_to_jax, unet_params_to_jax, unet_state_dict_from_jax)
from diffusion_model_universal_torch.ops import attention as attn_ops
from diffusion_model_universal_torch.ops import group_norm as gn_ops
from diffusion_model_universal_torch.trainers import DDPMTrainer
from diffusion_model_universal_torch.trainers import optim as topt
from diffusion_model_universal_torch.utils.checkpoint import read_state
from diffusion_model_universal_torch.utils.profiling import StepTimer

torch.set_num_threads(2)

C, T, B = 32, 8, 2
MODEL_CFG = {"model_channels": C, "num_timesteps": T, "image_size": 32,
             "in_channels": 3, "compute_dtype": "float32", "remat": False,
             "dropout": 0.0}
BF16_ULP = 2.0 ** -7      # one bf16 ulp, relative to the value's binade


def _adam_leaves(state, name):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        if any(getattr(k, "name", None) == name for k in path):
            out.append(np.asarray(leaf))
    return out


def _within_bf16_ulp(got, want, what, atol=0.0):
    """|got − want| ≤ one bf16 ulp of max(|got|, |want|) + ``atol``: both
    are bf16 values rounded from f32 values that may straddle a rounding
    boundary, and that differ by ``atol``."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(
        mag, 1e-38))) - 7), 0.0)
    assert (np.abs(got - want) <= ulp + atol).all(), what


def _config(tmp_path, **training):
    return {
        "model_name": "DDPM", "model_config": dict(MODEL_CFG, dropout=0.1),
        "training": {"num_epochs": 1, "batch_size": 2,
                     "learning_rate": 1e-3, "ema_decay": 0.99,
                     "scheduler": {"type": "cosine", "min_lr": 1e-6},
                     "val_interval": 0, "sample_interval": 0,
                     "checkpoint_interval": 0, **training},
        "data": {"dataset": "synthetic", "data_dir": "unused",
                 "num_samples": 13},
        "logging": {"log_interval": 1, "gradient_logging_freq": 2},
        "output": {"output_dir": str(tmp_path / "run")},
    }


def _trainer(cfg, seed=0):
    model = DDPM(cfg["model_config"], device="cpu", seed=3, trainable=True)
    loaders = get_dataset(cfg, device="cpu")
    return DDPMTrainer(model, *loaders, cfg, seed=seed)


# -- the bf16 first moment and EMA, against the reference's formulas ---------

def test_adam_mu_bf16_matches_optax():
    """Three updates from the same gradients with ``adam_mu_dtype:
    bfloat16``: μ is bf16 and equal bit for bit to the compiled optax
    update's, which the JAX trainer runs (bf16(b1)·μ + (1−b1)·g in f32,
    then rounded; eager optax rounds bf16(b1)·μ to bf16 first); ν and the
    parameters to rtol 1e-6 (the update reads the f32 moment before its
    rounding)."""
    cfg = {"learning_rate": 1e-2, "beta1": 0.8, "beta2": 0.95,
           "adam_mu_dtype": "bfloat16"}
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt, _ = topt.make_optimizer(tparams, cfg, 4, 2)
    jopt = optax.adam(1e-2, b1=0.8, b2=0.95, mu_dtype=jnp.bfloat16)
    update = jax.jit(jopt.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        tg = [torch.from_numpy(grads[k].copy()) for k in shapes]
        opt.step(tg, torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(tg))))
        updates, jstate = update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert {m.dtype for m in opt.mu} == {torch.bfloat16}
    for a, b in zip(opt.mu, _adam_leaves(jstate, "mu")):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    for a, b in zip(opt.nu, _adam_leaves(jstate, "nu")):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
    for k, p in zip(shapes, tparams):
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        topt.make_optimizer(tparams, {"adam_mu_dtype": "float16"}, 1, 1)


def test_ema_bf16_matches_the_reference_formula(tmp_path):
    """Three EMA updates with ``ema_dtype: bfloat16`` and warmup: each is
    (e·d + (1−d)·p) in f32 from the stored bf16 e, then rounded, as the
    reference's ``_update``; held within one bf16 ulp (d is a Python
    float in the port, an f32 in JAX)."""
    tr = _trainer(_config(tmp_path, ema_dtype="bfloat16", ema_decay=0.9))
    assert {e.dtype for e in tr.ema} == {torch.bfloat16}

    def flat(tensors):
        return np.concatenate([t.detach().float().numpy().ravel()
                               for t in tensors])

    want = jnp.asarray(flat(tr.params), jnp.bfloat16)
    gen = torch.Generator().manual_seed(1)
    for step in range(3):
        with torch.no_grad():
            for p in tr.params:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        tr._update_ema()
        tr.step_count += 1
        t = jnp.float32(step)
        d = jnp.minimum(jnp.float32(0.9), (1.0 + t) / (10.0 + t))
        want = (want.astype(jnp.float32) * d
                + (1.0 - d) * jnp.asarray(flat(tr.params))).astype(
                    jnp.bfloat16)
    _within_bf16_ulp(flat(tr.ema), want, "EMA")
    tr.cleanup()


def test_bf16_state_round_trips_a_checkpoint(tmp_path):
    """A step with bf16 μ and EMA, saved and restored into a new trainer:
    both stay bf16 and equal bit for bit, and the next step matches."""
    cfg = _config(tmp_path, ema_dtype="bfloat16", adam_mu_dtype="bfloat16")
    a = _trainer(cfg)
    batch = next(iter(a.train_loader))
    a.step(batch)
    a.save_checkpoint("ck", 0)
    state = read_state(str(tmp_path / "run" / "checkpoints" / "ck"))
    assert {v.dtype for v in state["ema_params"].values()} == {torch.bfloat16}
    b = _trainer(cfg, seed=0)
    b.load_checkpoint("ck")
    for x, y in zip(a.ema + a.optimizer.mu, b.ema + b.optimizer.mu):
        assert x.dtype == y.dtype == torch.bfloat16 and torch.equal(x, y)
    torch.manual_seed(7)
    ma = a.step(batch)
    torch.manual_seed(7)
    mb = b.step(batch)
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y)
    a.cleanup()
    b.cleanup()


# -- gradient accumulation against JAX's DDPMTrainer.accum_step -------------

def test_accum_step_matches_jax_trainer(tmp_path):
    """One update from two micro-batches of 2 (``grad_accum_steps: 2``,
    bf16 μ and EMA, clip 1.0, cosine LR) on the same weights, each
    micro-batch with the t and noise JAX derives from fold_in(step key,
    i). Tolerances as ``test_torch_train.py``'s single step: loss rtol
    1e-5, gradient norms rtol 1e-4, ν rtol 1e-3; μ within 1e-3 rel + one
    bf16 ulp (the two f32 moments round to bf16 apart when they straddle
    a boundary) + 1e-7 abs (measured 3e-8 on moments near 1e-7); the
    update p1 − p0 at 1e-3·lr where |g| > 1e-5 and 2·lr
    everywhere; the bf16 EMA, 0.1·p0 + 0.9·p1 in f32 then rounded,
    within one bf16 ulp + 1e-3·lr (the updates' own difference) where
    |g| > 1e-5, and 2·lr + one ulp everywhere. Both count ceil(5 / 2) = 3 updates an
    epoch."""
    lr = 1e-3
    cfg = {"model_name": "DDPM", "model_config": MODEL_CFG,
           "training": {"num_epochs": 2, "batch_size": B,
                        "learning_rate": lr, "ema_decay": 0.999,
                        "grad_clip": 1.0, "grad_accum_steps": 2,
                        "adam_mu_dtype": "bfloat16",
                        "ema_dtype": "bfloat16",
                        "scheduler": {"type": "cosine", "min_lr": 1e-6}},
           "logging": {"log_interval": 1},
           "output": {"output_dir": str(tmp_path / "jax")}}
    rng = np.random.default_rng(1)
    seed_model = DDPM(MODEL_CFG, device="cpu", seed=3, trainable=True)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        unet_params_to_jax(seed_model.net))
    jmodel = JaxDDPM(MODEL_CFG)
    jmodel.init_params = lambda key: jax.tree_util.tree_map(jnp.asarray,
                                                            params)
    jtr = JaxTrainer(jmodel, [None] * 5, None, None, cfg,
                     mesh=make_mesh(jax.devices()[:1]), seed=0)
    xs = [np.clip(rng.normal(size=(B, 32, 32, 3)), -1, 1).astype(np.float32)
          for _ in range(2)]
    draws = []
    for i in range(2):
        kt, kn, _ = jax.random.split(
            jax.random.fold_in(jtr._step_key(0), i), 3)
        draws.append({"t": torch.from_numpy(np.array(
                          jax.random.randint(kt, (B,), 0, T))),
                      "noise": torch.from_numpy(np.array(
                          jax.random.normal(kn, xs[i].shape, jnp.float32)))})
    jm = jtr.accum_step([jnp.asarray(x) for x in xs])

    model = DDPM(MODEL_CFG, device="cpu", seed=0, trainable=True)
    model.net.load_state_dict(unet_state_dict_from_jax(params))
    tr = DDPMTrainer(model, [None] * 5, None, None,
                     dict(cfg, output={"output_dir": str(tmp_path / "pt")}),
                     seed=0)
    assert tr.steps_per_epoch == jtr.steps_per_epoch == 3
    m = tr.accum_step([torch.from_numpy(x) for x in xs], draws)
    tr.cleanup()
    assert tr.step_count == int(jtr.state.step) == 1

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)

    def tree(tensors):
        return jax.tree_util.tree_leaves(state_dict_to_jax(
            model.net, dict(zip(tr.param_names, tensors))))

    norms = tree([torch.full(p.shape, float(v)) for p, v in
                  zip(tr.params, m["layer_grad_norms"].values())])
    np.testing.assert_allclose(
        [a.flat[0] for a in norms],
        [float(v) for v in jax.tree_util.tree_leaves(
            jm["layer_grad_norms"])], rtol=1e-4, atol=1e-8)
    state = jax.device_get(jtr.state)
    mu = _adam_leaves(state.opt_state, "mu")
    assert {a.dtype for a in mu} == {jnp.dtype(jnp.bfloat16)}
    for a, b in zip(tree(tr.optimizer.mu), mu):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        slack = np.abs(b) * (1e-3 + BF16_ULP) + 1e-7
        assert (np.abs(a - b) <= slack).all()
    for a, b in zip(tree(tr.optimizer.nu), _adam_leaves(state.opt_state,
                                                        "nu")):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-12)
    p0 = jax.tree_util.tree_leaves(params)
    for a, b, a0, g in zip(tree(tr.params),
                           jax.tree_util.tree_leaves(state.params), p0, mu):
        sure = np.abs(np.asarray(g, np.float32)) / (1 - 0.9) > 1e-5
        np.testing.assert_allclose(a, b, atol=2 * lr, rtol=0)
        np.testing.assert_allclose((a - a0)[sure], (b - a0)[sure],
                                   atol=1e-3 * lr, rtol=0)
    for n, a, b, g in zip(tr.param_names, tree(tr.ema),
                          jax.tree_util.tree_leaves(state.ema_params), mu):
        assert b.dtype == jnp.bfloat16 and tr.ema[0].dtype == torch.bfloat16
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        sure = np.abs(np.asarray(g, np.float32)) / (1 - 0.9) > 1e-5
        _within_bf16_ulp(a[sure], b[sure], n, atol=1e-3 * lr)
        assert (np.abs(a - b) <= 2 * lr + np.abs(b) * BF16_ULP).all(), n


def test_accumulated_update_is_the_mean_of_its_micro_batches(tmp_path):
    """With A=2 over 5 batches an epoch has 3 updates, the last over the
    ragged tail, and the LR schedule counts updates (cosine over 3 · 2);
    an update's loss is the mean of its micro-batches' losses, micro-batch
    i drawing from its own generator (seed, step, i)."""
    tr = _trainer(_config(tmp_path, grad_accum_steps=2, num_epochs=2))
    assert len(tr.train_loader) == 5 and tr.steps_per_epoch == 3
    chunks = list(tr._updates(tr.train_loader))
    assert [len(c) for c in chunks] == [2, 2, 1]
    assert tr.lr_schedule(6) == pytest.approx(1e-6)
    tr.model.net.eval()   # no dropout: the losses below are replayable
    with torch.no_grad():
        losses = [tr.model.loss_function(
            b, generator=tr._generator(0, micro=i)) for i, b in
            enumerate(chunks[0])]
    assert not torch.equal(losses[0], losses[1])
    m = tr.accum_step(chunks[0])
    torch.testing.assert_close(m["loss"], (losses[0] + losses[1]) * 0.5)
    tr.cleanup()


# -- remat_policy: save_convout ---------------------------------------------

class _ConvolutionCount(TorchDispatchMode):
    """Counts the convolutions computed under it: a selective checkpoint
    answers a saved op in the recompute without passing it on."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def test_save_convout_gradients_equal_full_and_no_remat(monkeypatch):
    """With dropout 0.1 (the masks replayed from the saved RNG state),
    ``remat_policy: save_convout`` gives the gradients of full remat and
    of no remat (1e-6 abs + 1e-5 rel; measured identical), recomputes K1
    and K3 as full remat does (100 K1, 53 K2 and 9 K3 dispatches a step
    against no remat's 53, 53 and 5), and keeps the conv outputs: it
    computes as many convolutions as no remat, fewer than full remat."""
    calls = {}

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
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.clip(rng.normal(size=(2, 32, 32, 3)), -1,
                                 1).astype(np.float32))
    t = torch.tensor([2, 7])
    noise = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    grads, counts, convs = {}, {}, {}
    for name, kw in (("none", {"remat": False}), ("full", {"remat": True}),
                     ("save_convout", {"remat_policy": "save_convout"})):
        m = DDPM(dict(MODEL_CFG, dropout=0.1, **kw), device="cpu", seed=3,
                 trainable=True)
        calls.update(gn=0, gn_bwd=0, mha=0)
        torch.manual_seed(5)
        with _ConvolutionCount() as computed:
            loss = m.loss_function(x, t, noise)
            grads[name] = torch.autograd.grad(loss, list(m.net.parameters()))
        counts[name] = dict(calls)
        convs[name] = computed.count
    assert counts["none"] == {"gn": 53, "gn_bwd": 53, "mha": 5}
    assert counts["save_convout"] == counts["full"] == {
        "gn": 100, "gn_bwd": 53, "mha": 9}
    assert convs["save_convout"] == convs["none"] < convs["full"]
    for other in ("full", "none"):
        for a, b in zip(grads["save_convout"], grads[other]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-5)


# -- histograms, the profile ------------------------------------------------

def test_histograms_are_taken_at_post_update_weights(tmp_path):
    """An epoch with A=2 over 3 batches runs and logs 2 updates.
    ``track_histograms`` at ``gradient_logging_freq`` (2) logs every
    weight after the update and the gradients of the same micro-batches,
    draws and dropout masks at those weights (not the update's own
    gradients), and β/α/ᾱ; the JSONL gets each one's mean and std."""
    cfg = _config(tmp_path, grad_accum_steps=2)
    cfg["data"]["num_samples"] = 8      # 6 train images: 3 batches
    cfg["logging"].update(track_histograms=True, gradient_logging_freq=2)
    tr = _trainer(cfg)
    logged = []
    log = tr.logger.log
    tr.logger.log = lambda metrics, step: (logged.append((step, metrics)),
                                           log(metrics, step))[1]
    chunk = next(tr._updates(tr.train_loader))
    rng = tr._rng_state()
    pre = tr._loss_and_grads(chunk, 0)[1]
    torch.set_rng_state(rng[0])
    tr.train(1)
    assert tr.step_count == 2
    assert [s for s, m in logged if "train/loss" in m] == [0, 1]
    hist = [m for s, m in logged if any(k.endswith("_hist") for k in m)]
    assert [s for s, m in logged
            if any(k.endswith("_hist") for k in m)] == [0]
    first = hist[0]
    assert {"diffusion/beta", "diffusion/alpha_cumprod"} <= set(first)
    names = [n.replace(".", "/") for n in tr.param_names]
    assert len([k for k in first if k.endswith("_hist")]) == 2 * len(names)
    # Replay update 0 on a fresh trainer, then take the gradients again.
    ref = _trainer(cfg)
    torch.set_rng_state(rng[0])
    ref.accum_step(chunk)
    torch.set_rng_state(rng[0])
    post = ref._loss_and_grads(chunk, 0)[1]
    for n, p, g_post, g_pre in zip(names, ref.params, post, pre):
        np.testing.assert_array_equal(first[f"gradients/{n}_hist"],
                                      g_post.numpy().ravel())
        np.testing.assert_array_equal(first[f"weights/{n}_hist"],
                                      p.detach().numpy().ravel())
    assert any(not torch.equal(a, b) for a, b in zip(post, pre))
    row = json.loads((tmp_path / "run" / "metrics.jsonl").read_text()
                     .splitlines()[1])
    assert row["step"] == 0
    w = first[f"weights/{names[0]}_hist"]
    assert row[f"weights/{names[0]}_hist/mean"] == pytest.approx(
        float(w.mean()), rel=1e-6)
    tr.cleanup()
    ref.cleanup()


def test_step_timer_skips_the_first_steps():
    timer = StepTimer(skip_first=1, window=2)
    for _ in range(4):
        timer.start()
        assert timer.stop() >= 0.0
    assert len(timer.times) == 2 and timer.mean >= 0.0
    assert timer.stop() is None
