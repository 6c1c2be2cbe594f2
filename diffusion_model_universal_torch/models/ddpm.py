"""DDPM — Denoising Diffusion Probabilistic Model (Ho et al. 2020), the
sampling and training slice (counterpart of the reference's
``models/ddpm.py``).

The reference's 1000-step ancestral sampler is one ``lax.scan``; here it
is a Python loop over one step function. The sampler state x and the
posterior step stay f32; the UNet runs in the compute dtype and its output
is cast to f32.

Two constructions of one model:

* serving (the default): conv, Linear and embedding weights are cast to
  the compute dtype in place, the network in ``eval()``;
* ``trainable=True``: f32 master weights, as the reference keeps f32
  params, and the network runs under ``torch.autocast`` in the compute
  dtype when that is bf16. Adam and the EMA then see f32 weights.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Union

import torch

from .. import NOT_PORTED
from ..utils.losses import DiffusionLoss
from .base import BaseDiffusionModel
from .schedules import (PREDICTION_TYPES, ddpm_posterior_step,
                        make_noise_schedule, prediction_target,
                        prediction_to_eps, q_sample)
from .unet import UNet, cast_compute_dtype_, init_unet_


class DDPM(BaseDiffusionModel):
    """DDPM model family.

    Config keys (canonical, with the reference-YAML aliases accepted):
    beta_start, beta_end, num_timesteps (alias time_steps), schedule_type,
    in_channels (alias image_channels), model_channels (alias
    hidden_channels), image_size, dropout, prediction_type, num_classes,
    conv_bias, compute_dtype, remat, loss_type, loss_config,
    cfg_drop_prob.

    Args:
        config: the model config.
        device: ``cuda`` unless given; raises if CUDA is missing.
        seed: seed of the CPU generator that draws the initial weights,
            with the reference's initializers.
        trainable: keep f32 weights and compute under autocast (training),
            instead of casting the weights (serving).
    """

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, trainable: bool = False):
        super().__init__(config, device)
        cfg = self.config
        if cfg.get("split_skip_convs", True) is False:
            raise ValueError(f"split_skip_convs: false is {NOT_PORTED}")
        remat_policy = cfg.get("remat_policy")
        if remat_policy not in (None, "full"):
            raise ValueError(f"remat_policy: {remat_policy} is {NOT_PORTED}")
        self.num_timesteps = int(cfg.get("num_timesteps", 1000))
        self.schedule = make_noise_schedule(
            cfg.get("beta_start", 1e-4), cfg.get("beta_end", 2e-2),
            self.num_timesteps, cfg.get("schedule_type", "linear"),
            device=self.device)
        self.prediction_type = cfg.get("prediction_type", "epsilon")
        if self.prediction_type not in PREDICTION_TYPES:
            raise ValueError(
                f"model_config.prediction_type must be one of "
                f"{PREDICTION_TYPES}, got {self.prediction_type!r}")
        self.learn_sigma = bool(cfg.get("learn_sigma", False))
        self.num_classes = int(cfg.get("num_classes", 0))
        self.cfg_drop_prob = float(cfg.get("cfg_drop_prob", 0.1))
        in_ch = cfg.get("in_channels", 3)
        net = UNet(in_channels=in_ch,
                   model_channels=cfg.get("model_channels", 64),
                   out_channels=in_ch * (2 if self.learn_sigma else 1),
                   dropout=cfg.get("dropout", 0.0),
                   num_classes=self.num_classes,
                   conv_bias=cfg.get("conv_bias", False),
                   remat=bool(cfg.get("remat", True))
                   or remat_policy is not None)
        init_unet_(net, torch.Generator().manual_seed(seed))
        # Conv weights in the activations' channels_last layout, so a conv
        # does not copy its weight into that layout on every call.
        net = net.to(self.device, memory_format=torch.channels_last)
        self.trainable = trainable
        self.autocast = trainable and self.compute_dtype != torch.float32
        if not trainable:
            net = cast_compute_dtype_(net, self.compute_dtype)
        self.net = net.eval()
        self.loss_fn = DiffusionLoss(
            loss_type=cfg.get("loss_type", "mse"),
            loss_config=cfg.get("loss_config", {}),
            num_timesteps=self.num_timesteps,
            alphas_cumprod=self.schedule.alphas_cumprod,
            prediction_type=self.prediction_type)

    def apply(self, x: torch.Tensor, t: torch.Tensor,
              y: Optional[torch.Tensor] = None,
              train: bool = False) -> torch.Tensor:
        """The network's raw prediction for noisy NHWC ``x`` at [B]
        timesteps ``t`` (f32, NHWC); ``train`` turns dropout on."""
        if self.net.training != train:
            self.net.train(train)
        with torch.autocast(self.device.type, dtype=self.compute_dtype,
                            enabled=self.autocast):
            return self.net(x, t, y)

    def loss_function(self, x: torch.Tensor,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      y: Optional[torch.Tensor] = None,
                      per_sample: bool = False) -> torch.Tensor:
        """Training loss of NHWC images ``x``: t ~ U[0, T), ε ~ N(0, I),
        x_t = q_sample(x, t, ε), the network (dropout on) against the
        parameterization's target. ``t`` and ``noise`` may be given, so a
        test can feed the reference's draws; otherwise they come from
        ``generator``. Conditional models replace a ``cfg_drop_prob``
        fraction of the labels ``y`` by the NULL token.

        ``per_sample``: return [B] losses, each as the loss of a batch of
        one (how the reference's eval weights samples)."""
        if self.learn_sigma:
            raise NotImplementedError(
                f"learn_sigma (the hybrid VLB objective) is {NOT_PORTED}")
        b = x.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,),
                              generator=generator, device=x.device)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator,
                                device=x.device, dtype=x.dtype)
        noisy_x = q_sample(self.schedule, x, t, noise)
        if y is not None and self.num_classes > 0:
            drop = torch.rand((b,), generator=generator,
                              device=x.device) < self.cfg_drop_prob
            y = torch.where(drop, torch.full_like(y, self.num_classes), y)
        pred = self.apply(noisy_x, t, y, train=True)
        target = prediction_target(self.schedule, x, noise, t,
                                   self.prediction_type)
        if per_sample:
            return self.loss_fn.per_sample(pred, target, t)
        return self.loss_fn(pred, target, t)

    def eps_fn(self) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """``eps(x, t_b)``: ε̂ in any prediction type (unconditional)."""
        c = self.image_channels

        def eps(x, t_b):
            out = self.apply(x, t_b)[..., :c]   # drop a variance head
            return prediction_to_eps(self.schedule, out, x, t_b,
                                     self.prediction_type)
        return eps

    def posterior_step_fn(self):
        """One ancestral reverse step ``(x, t_b, noise) -> x_{t−1}`` with
        the fixed posterior variance."""
        if self.learn_sigma:
            raise NotImplementedError(
                f"learn_sigma (learned reverse variance) is {NOT_PORTED}")
        eps = self.eps_fn()
        return lambda x, t_b, noise: ddpm_posterior_step(
            self.schedule, x, t_b, eps(x, t_b), noise)

    # -- sampling ---------------------------------------------------------
    def _init_noise(self, batch_size: int,
                    draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        x = draw()
        if tuple(x.shape) != self.sample_shape(batch_size):
            raise ValueError(f"initial noise has shape {tuple(x.shape)}, "
                             f"expected {self.sample_shape(batch_size)}")
        return x

    def _denoise_range(self, x: torch.Tensor, t_hi: int, t_lo: int,
                       draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        """Reverse diffusion from t_hi−1 down to t_lo, one noise draw per
        step (the t = 0 draw is masked out, as in the reference)."""
        step = self.posterior_step_fn()
        b = x.shape[0]
        for t in range(t_hi - 1, t_lo - 1, -1):
            t_b = torch.full((b,), t, dtype=torch.long, device=self.device)
            x = step(x, t_b, draw())
        return x

    @torch.inference_mode()
    def generate_samples(self, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Iterable[torch.Tensor]] = None
                         ) -> torch.Tensor:
        """Full T-step ancestral sampler. Returns f32 NHWC samples.

        Noise comes from ``generator`` (a ``torch.Generator`` on the
        model's device), or from ``noise``: x_T first, then one tensor per
        step from t = T−1 down to 0, so a test can feed the reference the
        same draws.
        """
        shape = self.sample_shape(batch_size)
        if noise is not None:
            it = iter(noise)

            def draw():
                return next(it).to(self.device, torch.float32)
        else:
            def draw():
                return torch.randn(shape, generator=generator,
                                   device=self.device, dtype=torch.float32)
        x = self._init_noise(batch_size, draw)
        return self._denoise_range(x, self.num_timesteps, 0, draw)

    @torch.inference_mode()
    def generate_samples_with_intermediates(
            self, batch_size: int,
            generator: Optional[torch.Generator] = None,
            save_interval: int = 100) -> List[torch.Tensor]:
        """The ancestral sampler, also returning intermediate frames: x_T,
        then x after each step with t % save_interval == 0 (t = 0 always
        included), as the reference's ``ddpm.py:609``."""
        def draw():
            return torch.randn(self.sample_shape(batch_size),
                               generator=generator, device=self.device,
                               dtype=torch.float32)
        x = self._init_noise(batch_size, draw)
        frames = [x]
        save_ts = sorted(set(range(0, self.num_timesteps, save_interval))
                         | {0}, reverse=True)
        t_hi = self.num_timesteps
        for t_save in save_ts:
            x = self._denoise_range(x, t_hi, t_save, draw)
            frames.append(x)
            t_hi = t_save
        return frames
