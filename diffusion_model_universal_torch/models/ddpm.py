"""DDPM — Denoising Diffusion Probabilistic Model (Ho et al. 2020), the
sampling and training slice (counterpart of the reference's
``models/ddpm.py``).

The reference's samplers are each one ``lax.scan``; here each is a Python
loop over one step function. The sampler state x and every schedule and
solver coefficient stay f32; the UNet runs in the compute dtype and its
output is cast to f32.

Samplers: the T-step ancestral one (plain or classifier-free guided),
DPM-Solver++(2M), Karras-spaced Heun, the strided (respaced) ancestral
one, RePaint-style inpainting, and the VLB in bits/dim. ``learn_sigma``
models emit 2C channels, the second half a learned variance, trained by
the hybrid loss. Every sampler takes a ``torch.Generator`` or an injected
``noise`` iterable (x_T first, then each step's draws in order), so a test
can feed the reference's draws.

Two constructions of one model:

* serving (the default): conv, Linear and embedding weights are cast to
  the compute dtype in place, the network in ``eval()``;
* ``trainable=True``: f32 master weights, as the reference keeps f32
  params, and the network runs under ``torch.autocast`` in the compute
  dtype when that is bf16. Adam and the EMA then see f32 weights.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from ..utils.losses import DiffusionLoss
from .base import (BaseDiffusionModel, Draw, Noise, Rows, cut_rows,
                   row_draws)
from .schedules import (PREDICTION_TYPES, ddpm_posterior_step,
                        ddpm_posterior_step_learned,
                        learned_range_log_variance, make_dpm_solver_params,
                        make_karras_heun_params, make_noise_schedule,
                        normal_kl, posterior_log_variance_clipped,
                        prediction_target, prediction_to_eps, q_sample,
                        respace_timesteps, respaced_schedule, vlb_term_bits)
from .unet import UNet, cast_compute_dtype_, init_unet_, remat_from_config


class DDPM(BaseDiffusionModel):
    """DDPM model family.

    Config keys (canonical, with the reference-YAML aliases accepted):
    beta_start, beta_end, num_timesteps (alias time_steps), schedule_type,
    in_channels (alias image_channels), model_channels (alias
    hidden_channels), image_size, dropout, prediction_type, num_classes,
    conv_bias, compute_dtype, remat, split_skip_convs, loss_type,
    loss_config, cfg_drop_prob, learn_sigma, vlb_weight.

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
        self.vlb_weight = float(cfg.get("vlb_weight", 1e-3))
        self.num_classes = int(cfg.get("num_classes", 0))
        self.cfg_drop_prob = float(cfg.get("cfg_drop_prob", 0.1))
        in_ch = cfg.get("in_channels", 3)
        net = UNet(in_channels=in_ch,
                   model_channels=cfg.get("model_channels", 64),
                   out_channels=in_ch * (2 if self.learn_sigma else 1),
                   dropout=cfg.get("dropout", 0.0),
                   num_classes=self.num_classes,
                   conv_bias=cfg.get("conv_bias", False),
                   **remat_from_config(cfg),
                   split_skip_convs=bool(cfg.get("split_skip_convs", True)))
        self._install_net(net, init_unet_, seed, trainable,
                          cast_compute_dtype_)
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
        return self._run_net(train, x, t, y)

    def loss_draws(self, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   y: Optional[torch.Tensor] = None, rows: Rows = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   cfg_u: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """The random inputs of :meth:`loss_function` on ``x`` (the global
        batch's under ``rows``): those given, the others drawn from
        ``generator`` in the loss's order (t, ε, then for a conditional
        model with labels the uniform ``cfg_u`` of the label drop)."""
        n, _ = row_draws(x.shape[0], rows)
        if t is None:
            t = torch.randint(0, self.num_timesteps, (n,),
                              generator=generator, device=x.device)
        if noise is None:
            noise = torch.randn((n, *x.shape[1:]), generator=generator,
                                device=x.device, dtype=x.dtype)
        draws = {"t": t, "noise": noise}
        if y is not None and self.num_classes > 0:
            draws["cfg_u"] = (cfg_u if cfg_u is not None else torch.rand(
                (n,), generator=generator, device=x.device))
        return draws

    def loss_function(self, x: torch.Tensor,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      y: Optional[torch.Tensor] = None,
                      per_sample: bool = False,
                      rows: Rows = None,
                      cfg_u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training loss of NHWC images ``x``: t ~ U[0, T), ε ~ N(0, I),
        x_t = q_sample(x, t, ε), the network (dropout on) against the
        parameterization's target. ``t`` and ``noise`` may be given, so a
        test can feed the reference's draws; otherwise they come from
        ``generator`` (:meth:`loss_draws`). Conditional models replace a
        ``cfg_drop_prob`` fraction of the labels ``y`` by the NULL token
        (where the uniform draw ``cfg_u`` is below it).

        ``per_sample``: return [B] losses, each as the loss of a batch of
        one (how the reference's eval weights samples). ``rows``: ``x``
        is those rows of a global batch, and ``t`` and ``noise``, drawn
        or given, are the global batch's (:func:`.base.row_draws`).

        ``learn_sigma`` models train the hybrid objective: the loss on the
        prediction half plus ``vlb_weight`` × the VLB in bits/dim, whose
        model mean is detached so that it trains only the variance
        half."""
        _, keep = row_draws(x.shape[0], rows)
        draws = self.loss_draws(x, generator, y, rows, t, noise, cfg_u)
        t, noise = draws["t"], draws["noise"]
        t_all, t, noise = t, t[keep], noise[keep]
        noisy_x = q_sample(self.schedule, x, t, noise)
        if "cfg_u" in draws:
            drop = draws["cfg_u"][keep] < self.cfg_drop_prob
            y = torch.where(drop, torch.full_like(y, self.num_classes), y)
        pred = self.apply(noisy_x, t, y, train=True)
        target = prediction_target(self.schedule, x, noise, t,
                                   self.prediction_type)
        def loss(out):
            if per_sample:
                return self.loss_fn.per_sample(out, target, t)
            return self.loss_fn(out, target, t_all, keep)

        if not self.learn_sigma:
            return loss(pred)
        mean_out, v_out = self._split_output(pred)
        eps_hat = prediction_to_eps(self.schedule, mean_out.detach(),
                                    noisy_x, t, self.prediction_type)
        log_var = learned_range_log_variance(self.schedule, v_out, t)
        vlb = vlb_term_bits(self.schedule, x, noisy_x, t, eps_hat, log_var)
        return loss(mean_out) + self.vlb_weight * (
            vlb if per_sample else vlb.mean())

    def _split_output(self, out: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(prediction, variance head) halves of a raw network output;
        (out, None) for fixed-variance models."""
        if not self.learn_sigma:
            return out, None
        c = self.image_channels
        return out[..., :c], out[..., c:]

    def make_class_labels(self, class_id: int,
                          batch_size: int) -> torch.Tensor:
        """Validate ``class_id`` and build [batch_size] labels on the
        model's device. Raises ValueError on unconditional models and for
        ids out of range (shared by the generate CLI and the server)."""
        if self.num_classes <= 0:
            raise ValueError("model is unconditional "
                             "(model_config.num_classes == 0)")
        if not 0 <= int(class_id) < self.num_classes:
            raise ValueError(f"class_id must be in [0, {self.num_classes}) "
                             f"(0-based), got {class_id}")
        return torch.full((batch_size,), int(class_id), dtype=torch.long,
                          device=self.device)

    # -- ε-prediction closures (shared by all samplers) -------------------
    def _check_conditioning(self, y, guidance_scale: float) -> None:
        if y is not None and self.num_classes <= 0:
            raise ValueError(
                "labels passed to an unconditional model "
                "(model_config.num_classes == 0)")
        if y is None and guidance_scale != 1.0:
            raise ValueError(
                "guidance_scale requires labels (CFG needs a class "
                "to guide towards)")

    def _guided_fn(self, y: Optional[torch.Tensor], guidance_scale: float):
        """``(x, t_b) -> (guided, conditional)`` raw outputs: with labels
        and a scale other than 1, o_u + s·(o_c − o_u) with o_u at the NULL
        label (two UNet calls), else the one output twice."""
        self._check_conditioning(y, guidance_scale)
        if y is None or guidance_scale == 1.0:
            def plain(x, t_b):
                out = self.apply(x, t_b, y)
                return out, out
            return plain
        y_null = torch.full_like(y, self.num_classes)

        def guided(x, t_b):
            o_c = self.apply(x, t_b, y)
            o_u = self.apply(x, t_b, y_null)
            return o_u + guidance_scale * (o_c - o_u), o_c
        return guided

    def _to_eps(self, out, x, t_b):
        """ε̂ from the prediction half of a raw output."""
        return prediction_to_eps(self.schedule, self._split_output(out)[0],
                                 x, t_b, self.prediction_type)

    def eps_fn(self, y: Optional[torch.Tensor] = None,
               guidance_scale: float = 1.0
               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """``eps(x, t_b)``: ε̂ plain, conditional or CFG-guided (ε_u +
        s·(ε_c − ε_u)), in any prediction type. Guidance acts on the raw
        outputs, which are then converted once (the conversions are affine
        in the output with a shared offset, so this is ε-space guidance);
        a variance head is dropped. Misuse raises."""
        fn = self._guided_fn(y, guidance_scale)
        return lambda x, t_b: self._to_eps(fn(x, t_b)[0], x, t_b)

    def mean_var_fn(self, y: Optional[torch.Tensor] = None,
                    guidance_scale: float = 1.0):
        """``(x, t_b) -> (ε̂, log σ²)`` of a learned-variance model: ε̂ as
        :meth:`eps_fn`, the variance from the conditional output's head
        (guidance moves the mean, not the uncertainty)."""
        if not self.learn_sigma:
            raise ValueError("mean_var_fn requires learn_sigma=true")
        fn = self._guided_fn(y, guidance_scale)

        def mean_var(x, t_b):
            out, o_c = fn(x, t_b)
            log_var = learned_range_log_variance(
                self.schedule, self._split_output(o_c)[1], t_b)
            return self._to_eps(out, x, t_b), log_var
        return mean_var

    def posterior_step_fn(self, y: Optional[torch.Tensor] = None,
                          guidance_scale: float = 1.0):
        """One ancestral reverse step ``(x, t_b, noise) -> x_{t−1}``: the
        learned variance for learn_sigma models, else the fixed
        posterior variance."""
        if self.learn_sigma:
            mv = self.mean_var_fn(y, guidance_scale)

            def learned(x, t_b, noise):
                e, log_var = mv(x, t_b)
                return ddpm_posterior_step_learned(self.schedule, x, t_b, e,
                                                   log_var, noise)
            return learned
        eps = self.eps_fn(y, guidance_scale)
        return lambda x, t_b, noise: ddpm_posterior_step(
            self.schedule, x, t_b, eps(x, t_b), noise)

    # -- sampling ---------------------------------------------------------
    def _check_steps(self, num_steps: int) -> None:
        if not 2 <= num_steps <= self.num_timesteps:
            raise ValueError(
                f"num_steps must be in [2, {self.num_timesteps}] (got "
                f"{num_steps}): 1 step runs no updates (returns raw "
                "noise); more steps than T duplicates grid points")

    def _denoise_range(self, x: torch.Tensor, t_hi: int, t_lo: int,
                       draw: Draw, y: Optional[torch.Tensor] = None,
                       guidance_scale: float = 1.0) -> torch.Tensor:
        """Reverse diffusion from t_hi−1 down to t_lo, one noise draw per
        step (the t = 0 draw is masked out, as in the reference);
        ``y``/``guidance_scale`` as in :meth:`eps_fn`."""
        step = self.posterior_step_fn(y, guidance_scale)
        b = x.shape[0]
        for t in range(t_hi - 1, t_lo - 1, -1):
            x = step(x, self._t(b, t), draw())
        return x

    @torch.inference_mode()
    def generate_samples(self, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Noise = None,
                         rows: Rows = None) -> torch.Tensor:
        """Full T-step ancestral sampler. Returns f32 NHWC samples.

        Noise comes from ``generator`` (a ``torch.Generator`` on the
        model's device), or from ``noise``: x_T first, then one tensor per
        step from t = T−1 down to 0. ``rows`` (lo, hi, ``batch_size``):
        return rows [lo, hi) of the batch, the draws made for all of it
        (every sampler takes it; :meth:`.base.BaseDiffusionModel._start`).
        """
        x, draw, _ = self._start(batch_size, generator, noise, rows)
        return self._denoise_range(x, self.num_timesteps, 0, draw)

    @torch.inference_mode()
    def generate_samples_cfg(self, batch_size: int, labels: torch.Tensor,
                             guidance_scale: float = 3.0,
                             generator: Optional[torch.Generator] = None,
                             noise: Noise = None,
                             rows: Rows = None) -> torch.Tensor:
        """Class-conditional ancestral sampling with classifier-free
        guidance; ``labels`` [batch_size], scale 1.0 = plain conditional.
        Draws and ``rows`` as :meth:`generate_samples`."""
        x, draw, keep = self._start(batch_size, generator, noise, rows)
        return self._denoise_range(x, self.num_timesteps, 0, draw,
                                   cut_rows(labels, keep), guidance_scale)

    @torch.inference_mode()
    def generate_samples_dpm(self, batch_size: int, num_steps: int = 20,
                             labels: Optional[torch.Tensor] = None,
                             guidance_scale: float = 1.0,
                             generator: Optional[torch.Generator] = None,
                             noise: Noise = None,
                             rows: Rows = None) -> torch.Tensor:
        """DPM-Solver++(2M) (Lu et al. 2022): a second-order multistep ODE
        solver in x₀, one ε̂ a step, S−1 updates over the half-log-SNR
        grid, x̂₀ clipped to [−1, 1]. The first update (h_prev = 0) is
        first order. Draws: x_T only."""
        self._check_steps(num_steps)
        p = make_dpm_solver_params(self.schedule, num_steps)
        ts = p.timesteps.tolist()
        x, _, keep = self._start(batch_size, generator, noise, rows)
        batch_size = x.shape[0]
        eps_fn = self.eps_fn(cut_rows(labels, keep), guidance_scale)
        x0_prev = torch.zeros_like(x)
        h_prev = torch.zeros((), device=self.device)
        for j in range(1, num_steps):
            eps = eps_fn(x, self._t(batch_size, ts[j - 1]))
            x0 = torch.clamp((x - p.sigma[j - 1] * eps) / p.alpha[j - 1],
                             -1.0, 1.0)
            h = p.lam[j] - p.lam[j - 1]
            # D = (1+c)·x0 − c·x0_prev, c = h/(2·h_prev); c = 0 first.
            c = torch.where(h_prev > 0.0, h / (2.0 * h_prev),
                            torch.zeros_like(h))
            d = (1.0 + c) * x0 - c * x0_prev
            x = (p.sigma[j] / p.sigma[j - 1]) * x \
                - p.alpha[j] * torch.expm1(-h) * d
            x0_prev, h_prev = x0, h
        return x

    @torch.inference_mode()
    def generate_samples_heun(self, batch_size: int, num_steps: int = 18,
                              rho: float = 7.0,
                              labels: Optional[torch.Tensor] = None,
                              guidance_scale: float = 1.0,
                              generator: Optional[torch.Generator] = None,
                              noise: Noise = None,
                              rows: Rows = None) -> torch.Tensor:
        """Karras-spaced Heun (EDM, Karras et al. 2022, Alg. 1): plain
        Heun on dx̂/dσ̂ = ε̂ in x̂ = x/α, σ̂ = σ/α over the ρ-spaced grid
        snapped to the schedule; two ε̂ an update, 2·(S−1) in all, no x̂₀
        clipping. Draws: x_T only."""
        self._check_steps(num_steps)
        p = make_karras_heun_params(self.schedule, num_steps, rho)
        ts = p.timesteps.tolist()
        x, _, keep = self._start(batch_size, generator, noise, rows)
        batch_size = x.shape[0]
        eps_fn = self.eps_fn(cut_rows(labels, keep), guidance_scale)
        for j in range(1, num_steps):
            dsig = p.sigma_hat[j] - p.sigma_hat[j - 1]      # < 0
            d_cur = eps_fn(x, self._t(batch_size, ts[j - 1]))
            x_hat = x / p.alpha[j - 1]
            x_eul = p.alpha[j] * (x_hat + dsig * d_cur)      # predictor
            d_nxt = eps_fn(x_eul, self._t(batch_size, ts[j]))
            x = p.alpha[j] * (x_hat + dsig * 0.5 * (d_cur + d_nxt))
        return x

    @torch.inference_mode()
    def generate_samples_strided(self, batch_size: int, num_steps: int = 100,
                                 labels: Optional[torch.Tensor] = None,
                                 guidance_scale: float = 1.0,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Noise = None,
                                 rows: Rows = None) -> torch.Tensor:
        """Respaced (strided) ancestral sampler (iDDPM §4): the stochastic
        reverse process over S evenly spaced timesteps with the coarse
        schedule, the model evaluated at the original timesteps; a learned
        variance is re-anchored to the coarse schedule (position j, not
        timestep ts[j]). One UNet call a step (two with CFG). Draws: x_T,
        then one a step."""
        ts_t = respace_timesteps(self.num_timesteps, num_steps)
        sub = respaced_schedule(self.schedule, ts_t)
        ts = ts_t.tolist()
        x, draw, keep = self._start(batch_size, generator, noise, rows)
        batch_size = x.shape[0]
        fn = self._guided_fn(cut_rows(labels, keep), guidance_scale)
        for j in range(num_steps - 1, -1, -1):
            t_b = self._t(batch_size, ts[j])          # the model's clock
            j_b = self._t(batch_size, j)              # the coarse clock
            out, o_c = fn(x, t_b)
            eps = self._to_eps(out, x, t_b)
            if self.learn_sigma:
                log_var = learned_range_log_variance(
                    sub, self._split_output(o_c)[1], j_b)
                x = ddpm_posterior_step_learned(sub, x, j_b, eps, log_var,
                                                draw())
            else:
                x = ddpm_posterior_step(sub, x, j_b, eps, draw())
        return x

    @torch.inference_mode()
    def generate_samples_inpaint(self, image: torch.Tensor,
                                 mask: torch.Tensor,
                                 labels: Optional[torch.Tensor] = None,
                                 guidance_scale: float = 1.0,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Noise = None,
                                 rows: Rows = None) -> torch.Tensor:
        """Inpainting by RePaint's replacement (Lugmayr et al. 2022, without
        its resampling): after every ancestral step the known region
        (``mask`` 1, broadcastable to ``image`` [B, H, W, C]) is replaced
        by ``image`` q-sampled to t−1; the output keeps the known pixels
        exactly. Draws: x_T, then two a step (the posterior noise, then
        the q-sample noise). ``rows`` cut the batch of ``image`` (and a
        per-sample mask and ``labels``)."""
        x, draw, keep = self._start(image.shape[0], generator, noise, rows)
        image = image[keep].to(self.device, torch.float32)
        b = image.shape[0]
        if mask.ndim == 4 and mask.shape[0] > 1:
            mask = mask[keep]
        step = self.posterior_step_fn(cut_rows(labels, keep), guidance_scale)
        mask = torch.broadcast_to(mask.to(self.device, torch.float32),
                                  image.shape)
        for t in range(self.num_timesteps - 1, -1, -1):
            t_b = self._t(b, t)
            x = step(x, t_b, draw())
            known = q_sample(self.schedule, image,
                             torch.clamp(t_b - 1, min=0), draw())
            x = mask * known + (1.0 - mask) * x
        return mask * image + (1.0 - mask) * x

    @torch.inference_mode()
    def nll_bits_per_dim(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         noise: Noise = None) -> torch.Tensor:
        """[B] variational bound in bits/dim of images ``x`` in [−1, 1]:
        Σ_t L_t, each term from one q-sample of x_t (t = 0 … T−1, one draw
        each, in that order), plus the closed-form prior term L_T.
        Fixed-variance models are scored with the clipped β̃, learn_sigma
        models with their learned variance."""
        x = x.to(self.device, torch.float32)
        b = x.shape[0]
        sched = self.schedule
        draw = self._drawer(tuple(x.shape), generator, noise)
        clipped = posterior_log_variance_clipped(sched)
        total = torch.zeros((b,), device=self.device)
        for t in range(self.num_timesteps):
            t_b = self._t(b, t)
            x_t = q_sample(sched, x, t_b, draw())
            pred, v = self._split_output(self.apply(x_t, t_b))
            eps = prediction_to_eps(sched, pred, x_t, t_b,
                                    self.prediction_type)
            if self.learn_sigma:
                log_var = learned_range_log_variance(sched, v, t_b)
            else:
                log_var = clipped[t_b][:, None, None, None].expand(x.shape)
            total = total + vlb_term_bits(sched, x, x_t, t_b, eps, log_var)
        a_T = sched.sqrt_alphas_cumprod[-1]
        lv_T = torch.log(1.0 - sched.alphas_cumprod[-1])
        kl_T = normal_kl(a_T * x, lv_T, torch.zeros_like(x),
                         torch.zeros_like(x))
        return total + kl_T.reshape(b, -1).mean(dim=1) / math.log(2.0)

    @torch.inference_mode()
    def generate_samples_with_intermediates(
            self, batch_size: int,
            generator: Optional[torch.Generator] = None,
            save_interval: int = 100) -> List[torch.Tensor]:
        """The ancestral sampler, also returning intermediate frames: x_T,
        then x after each step with t % save_interval == 0 (t = 0 always
        included), as the reference's ``ddpm.py:609``."""
        draw = self._drawer(self.sample_shape(batch_size), generator, None)
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
