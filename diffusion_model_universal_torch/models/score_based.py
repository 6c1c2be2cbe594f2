"""Score-based generative model (NCSN-style, Song & Ermon), the
counterpart of the reference's ``models/score_based.py``.

* The score network is the shared UNet conditioned on log σ
  (``continuous_sigma``), so on the card it runs K1 and K3 as the DDPM
  UNet does (and K2 in training).
* Training: σ = σ_min·(σ_max/σ_min)^u with u ~ U[0, 1), x + σ·ε, the
  predicted score against −ε/σ for the same ε (denoising score matching),
  or a ``DiffusionLoss`` of the config's ``loss_type`` on (score, −ε/σ).
* Sampling: annealed Langevin dynamics over the geometric σ ladder,
  ``num_scales`` levels × ``langevin_steps`` steps of
  x ← x + ε·s + √(2ε)·z with ε = (σ·β)²·2, then optionally one Tweedie
  step x + σ_min²·s (``final_denoise``). A Python loop over the UNet; the
  iterate and the step coefficients stay f32.

Every draw can be injected (``sigma=``/``noise=`` in the loss, ``noise=``
in the sampler: x_init first, then each step's draw in order), so a test
can feed the reference's draws.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..utils.losses import DiffusionLoss, score_matching_loss
from .base import BaseDiffusionModel, Draw, Noise, Rows, row_draws
from .schedules import continuous_sigma, sigma_ladder
from .unet import UNet, cast_compute_dtype_, init_unet_, remat_from_config

ScoreFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class ScoreBasedDiffusion(BaseDiffusionModel):
    """Score-based diffusion with annealed Langevin sampling.

    Config keys: sigma_min, sigma_max, num_scales, beta (sampling
    temperature), langevin_steps, final_denoise, in_channels,
    model_channels, image_size, dropout, compute_dtype, remat,
    dsm_weighting (none | sigma2), score_parameterization (raw | sigma),
    loss_type (score_matching, or a ``DiffusionLoss`` type), loss_config.

    Args: as :class:`..ddpm.DDPM`.
    """

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, trainable: bool = False):
        super().__init__(config, device)
        cfg = self.config
        self.sigma_min = cfg.get("sigma_min", 0.01)
        self.sigma_max = cfg.get("sigma_max", 50.0)
        self.num_scales = int(cfg.get("num_scales", 1000))
        self.beta = cfg.get("beta", 1.0)
        self.langevin_steps = int(cfg.get("langevin_steps", 10))
        self.final_denoise = bool(cfg.get("final_denoise", False))
        self.dsm_weighting = cfg.get("dsm_weighting", "none")
        self.score_parameterization = cfg.get("score_parameterization",
                                              "raw")
        if self.score_parameterization not in ("raw", "sigma"):
            raise ValueError(
                "score_parameterization must be 'raw' or 'sigma', got "
                f"{self.score_parameterization!r}")
        loss_type = cfg.get("loss_type", "score_matching")
        self.loss_fn = None if loss_type == "score_matching" else \
            DiffusionLoss(loss_type, cfg.get("loss_config", {}),
                          num_timesteps=self.num_scales)
        in_ch = cfg.get("in_channels", 3)
        net = UNet(in_channels=in_ch,
                   model_channels=cfg.get("model_channels", 64),
                   out_channels=in_ch, dropout=cfg.get("dropout", 0.0),
                   continuous_sigma=True, **remat_from_config(cfg))
        self._install_net(net, init_unet_, seed, trainable,
                          cast_compute_dtype_)
        # The ladder and each level's (σ, step, noise scale), in f32 as the
        # reference computes them.
        f = np.float32
        self.sigmas = sigma_ladder(self.sigma_min, self.sigma_max,
                                   self.num_scales)
        self._steps = []
        for sigma in self.sigmas:
            step = (sigma * f(self.beta)) ** 2 * f(2)
            self._steps.append((float(sigma), float(step),
                                float(np.sqrt(step * f(2)))))

    def apply(self, x: torch.Tensor, sigma: torch.Tensor,
              train: bool = False) -> torch.Tensor:
        """The predicted score ∇ₓ log p_σ(x) of NHWC ``x`` at [B] noise
        levels ``sigma`` (f32); divided by σ for
        ``score_parameterization: sigma``."""
        out = self._run_net(train, x, sigma)
        if self.score_parameterization == "sigma":
            out = out / sigma[:, None, None, None].to(out.dtype)
        return out

    def loss_draws(self, x: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   y: Optional[torch.Tensor] = None, rows: Rows = None,
                   sigma: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """The random inputs of :meth:`loss_function` on ``x`` (the global
        batch's under ``rows``): those given, the others drawn from
        ``generator`` in the loss's order (σ from u ~ U[0, 1), then ε)."""
        n, _ = row_draws(x.shape[0], rows)
        if sigma is None:
            u = torch.rand((n,), generator=generator, device=x.device)
            sigma = continuous_sigma(self.sigma_min, self.sigma_max, u)
        if noise is None:
            noise = torch.randn((n, *x.shape[1:]), generator=generator,
                                device=x.device, dtype=x.dtype)
        return {"sigma": sigma, "noise": noise}

    def loss_function(self, x: torch.Tensor,
                      sigma: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      y: Optional[torch.Tensor] = None,
                      per_sample: bool = False,
                      rows: Rows = None) -> torch.Tensor:
        """DSM loss of NHWC images ``x`` (labels ``y`` are ignored: the
        family is unconditional) at σ = continuous_sigma(u), u ~ U[0, 1),
        and ε ~ N(0, I); ``sigma``/``noise`` may be given, else they come
        from ``generator``. ``per_sample``: [B] losses. ``rows``: ``x``
        is those rows of a global batch, and ``sigma`` and ``noise``,
        drawn or given, are the global batch's (:func:`.base.row_draws`).
        """
        _, keep = row_draws(x.shape[0], rows)
        draws = self.loss_draws(x, generator, y, rows, sigma, noise)
        sigma, noise = draws["sigma"][keep], draws["noise"][keep]
        s = sigma[:, None, None, None]
        score = self.apply(x + s * noise, sigma, train=True)
        if self.loss_fn is None:
            return score_matching_loss(score, noise, sigma,
                                       self.dsm_weighting, per_sample)
        loss = self.loss_fn.per_sample if per_sample else self.loss_fn
        return loss(score, -noise / s)

    # -- sampling ---------------------------------------------------------
    def _sigma_b(self, b: int, sigma: float) -> torch.Tensor:
        return torch.full((b,), sigma, dtype=torch.float32,
                          device=self.device)

    def _run_levels(self, x: torch.Tensor, lo: int, hi: int, draw: Draw,
                    score_fn: ScoreFn) -> torch.Tensor:
        """Levels ``lo`` … ``hi``−1 of the ladder, ``langevin_steps``
        Langevin steps each, one draw a step."""
        b = x.shape[0]
        for sigma, step, noise_scale in self._steps[lo:hi]:
            sigma_b = self._sigma_b(b, sigma)
            for _ in range(self.langevin_steps):
                x = x + step * score_fn(x, sigma_b) + noise_scale * draw()
        return x

    def _maybe_final_denoise(self, x: torch.Tensor,
                             score_fn: ScoreFn) -> torch.Tensor:
        if not self.final_denoise:
            return x
        return x + self.sigma_min ** 2 * score_fn(
            x, self._sigma_b(x.shape[0], self.sigma_min))

    @torch.inference_mode()
    def generate_samples(self, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Noise = None,
                         score_fn: Optional[ScoreFn] = None,
                         rows: Rows = None) -> torch.Tensor:
        """Annealed Langevin sampling: ``num_scales`` × ``langevin_steps``
        score evaluations (one more with ``final_denoise``). Draws: x_init
        ~ N(0, I), then one a step. ``score_fn(x, sigma_b)`` replaces the
        network (a test's analytic score). ``rows`` (lo, hi,
        ``batch_size``): rows [lo, hi) of the batch, the draws made for all
        of it. Returns f32 NHWC samples."""
        score_fn = score_fn or self.apply
        x, draw, _ = self._start(batch_size, generator, noise, rows)
        x = self._run_levels(x, 0, self.num_scales, draw, score_fn)
        return self._maybe_final_denoise(x, score_fn)

    @torch.inference_mode()
    def generate_samples_with_intermediates(
            self, batch_size: int,
            generator: Optional[torch.Generator] = None,
            save_interval: int = 100) -> List[torch.Tensor]:
        """The sampler without the final denoise, also returning frames:
        x_init, then x after every ``save_interval`` σ-levels."""
        draw = self._drawer(self.sample_shape(batch_size), generator, None)
        x = self._init_noise(batch_size, draw)
        frames = [x]
        for start in range(0, self.num_scales, save_interval):
            end = min(start + save_interval, self.num_scales)
            x = self._run_levels(x, start, end, draw, self.apply)
            frames.append(x)
        return frames
