"""Energy-based diffusion model, the counterpart of the reference's
``models/energy_based.py``.

* :class:`EnergyNet`: three 3×3 convs (C, 2C, 4C) with GroupNorm(8)+SiLU
  after the first two and SiLU after the third, a spatial mean and a
  Linear to one scalar energy a sample; time conditioning concatenates a
  sinusoidal embedding of t as C extra input channels.
* Training (``training_objective``): "cd", contrastive divergence with
  Langevin negatives and a gradient penalty (or a ``DiffusionLoss`` of
  the config's ``loss_type`` on the real and fake energies); or "dsm",
  ε̂ = √(1−ᾱ_t)·∇ₓE regressed onto ε.
* Sampling: a reverse sweep over the T noise levels with Langevin steps
  at each and noise re-injected between levels ("cd"), or DDPM's
  ancestral chain on ε̂ ("dsm").

Langevin steps, ε̂ and the penalty need ∇ₓE inside sampling and
evaluation, so those paths turn autograd on locally
(``torch.enable_grad``) and are never run under ``inference_mode``,
whose tensors cannot be saved for a backward. Every draw can be injected
(``t=``, ``noise=``, ``langevin_noise=``, ``alpha=`` in the loss;
``noise=`` in the samplers), so a test can feed the reference's draws.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.group_norm import group_norm_silu_plain
from ..utils.losses import DiffusionLoss, energy_based_loss
from .base import BaseDiffusionModel, Draw, Noise, Rows, row_draws
from .layers import sinusoidal_embedding
from .layers.resnet import to_nchw, to_nhwc
from .schedules import ddpm_posterior_step, make_noise_schedule, q_sample
from .unet import _trunc_normal_, cast_compute_dtype_


class EnergyNet(nn.Module):
    """Scalar-energy CNN: NHWC ``x`` [B, H, W, C_in] (and [B] integer
    ``t``) → [B] f32 energies; lower energy, higher model probability.

    Parameters follow the reference's flax tree: ``conv1``…``conv3`` and
    ``dense`` with biases, and the GroupNorm affines as plain top-level
    parameters ``norm1_scale``, ``norm1_bias``, ``norm2_scale``,
    ``norm2_bias``.

    Its GroupNorm is ``group_norm_silu_plain`` on every device, the
    port's counterpart of ``group_norm_silu_xla``: the reference's
    EnergyNet calls ``group_norm_silu`` without ``use_pallas``
    (``diffusion_model_universal_tpu/models/energy_based.py:71``), which
    takes the XLA path (``diffusion_model_universal_tpu/ops/
    group_norm.py:375-383``), so there is no TPU kernel to port here.
    The plain version also differentiates twice, which the training
    losses need and K2 does not record.
    """

    def __init__(self, in_channels: int = 3, model_channels: int = 64,
                 time_conditioning: bool = True):
        super().__init__()
        c = model_channels
        self.model_channels = c
        self.time_conditioning = time_conditioning
        cin = in_channels + (c if time_conditioning else 0)
        self.conv1 = nn.Conv2d(cin, c, 3, padding=1)
        self.norm1_scale = nn.Parameter(torch.ones(c))
        self.norm1_bias = nn.Parameter(torch.zeros(c))
        self.conv2 = nn.Conv2d(c, 2 * c, 3, padding=1)
        self.norm2_scale = nn.Parameter(torch.ones(2 * c))
        self.norm2_bias = nn.Parameter(torch.zeros(2 * c))
        self.conv3 = nn.Conv2d(2 * c, 4 * c, 3, padding=1)
        self.dense = nn.Linear(4 * c, 1)

    @staticmethod
    def _gn(h: torch.Tensor, scale, bias) -> torch.Tensor:
        return to_nchw(group_norm_silu_plain(to_nhwc(h), scale, bias, 8))

    def forward(self, x: torch.Tensor,
                t: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        if self.time_conditioning and t is not None:
            t_emb = sinusoidal_embedding(t, self.model_channels)
            t_map = t_emb[:, None, None, :].expand(b, h, w, -1)
            x = torch.cat([x, t_map.to(x.dtype)], dim=-1)
        dtype = self.conv1.weight.dtype
        z = x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        h1 = self._gn(self.conv1(z), self.norm1_scale, self.norm1_bias)
        h2 = self._gn(self.conv2(h1), self.norm2_scale, self.norm2_bias)
        h3 = F.silu(self.conv3(h2))
        return self.dense(h3.mean(dim=(2, 3))).squeeze(-1).float()


@torch.no_grad()
def init_energy_net_(net: EnergyNet, generator: torch.Generator
                     ) -> EnergyNet:
    """The reference's flax defaults: LeCun-normal conv and Linear
    weights, zero biases, GroupNorm γ = 1 and β = 0."""
    for m in (net.conv1, net.conv2, net.conv3, net.dense):
        _trunc_normal_(m.weight, m.weight[0].numel(), 1.0, generator)
        m.bias.zero_()
    return net


class EnergyBasedDiffusion(BaseDiffusionModel):
    """Energy-based diffusion with Langevin MCMC training and sampling.

    Config keys: num_timesteps (or noise_schedule.timesteps), beta_start,
    beta_end, schedule_type (or noise_schedule.type / beta_start /
    beta_end), use_time_conditioning, in_channels, model_channels,
    image_size, compute_dtype, loss_type (energy_based, or a
    ``DiffusionLoss`` type), loss_config, energy_scale,
    regularization_weight, langevin_steps, langevin_step_size,
    training_objective (cd | dsm).

    Args: as :class:`..ddpm.DDPM`.
    """

    def __init__(self, config: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, trainable: bool = False):
        super().__init__(config, device)
        cfg = self.config
        noise_cfg = cfg.get("noise_schedule", {}) or {}
        self.num_timesteps = int(cfg.get(
            "num_timesteps", noise_cfg.get("timesteps", 1000)))
        self.schedule = make_noise_schedule(
            cfg.get("beta_start", noise_cfg.get("beta_start", 1e-4)),
            cfg.get("beta_end", noise_cfg.get("beta_end", 2e-2)),
            self.num_timesteps,
            noise_cfg.get("type", cfg.get("schedule_type", "linear")),
            device=self.device)
        self.use_time_conditioning = cfg.get("use_time_conditioning", True)
        self.energy_scale = cfg.get("energy_scale", 1.0)
        self.regularization_weight = cfg.get("regularization_weight", 0.1)
        loss_type = cfg.get("loss_type", "energy_based")
        self.loss_fn = None if loss_type == "energy_based" else \
            DiffusionLoss(loss_type, cfg.get("loss_config", {}),
                          num_timesteps=self.num_timesteps,
                          alphas_cumprod=self.schedule.alphas_cumprod)
        self.langevin_steps = int(cfg.get("langevin_steps", 10))
        self.langevin_step_size = cfg.get("langevin_step_size", 0.01)
        self.training_objective = cfg.get("training_objective", "cd")
        if self.training_objective not in ("cd", "dsm"):
            raise ValueError(
                "training_objective must be 'cd' or 'dsm', got "
                f"{self.training_objective!r}")
        net = EnergyNet(cfg.get("in_channels", 3),
                        cfg.get("model_channels", 64),
                        self.use_time_conditioning)
        self._install_net(net, init_energy_net_, seed, trainable,
                          cast_compute_dtype_)

    def apply(self, x: torch.Tensor,
              t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Energies E(x[, t]), [B] f32 (the net has no dropout)."""
        return self._run_net(False, x, t)

    def energy_grad(self, x: torch.Tensor, t: torch.Tensor,
                    create_graph: bool = False) -> torch.Tensor:
        """∇ₓ Σ_b E(x_b, t_b), with autograd on whatever the caller's
        grad mode (``create_graph`` keeps it differentiable)."""
        with torch.enable_grad():
            z = x if x.requires_grad else x.detach().requires_grad_()
            grad, = torch.autograd.grad(self.apply(z, t).sum(), z,
                                        create_graph=create_graph)
        return grad

    def _langevin(self, x: torch.Tensor, t: torch.Tensor,
                  draw: Draw) -> torch.Tensor:
        """``langevin_steps`` steps of x ← x − λ·∇ₓE + √(2λ)·z, one draw a
        step; the chain is detached (carries no parameter gradient)."""
        lam = self.langevin_step_size
        noise_scale = float(np.sqrt(np.float32(2.0 * lam)))   # as f32
        x = x.detach()
        for _ in range(self.langevin_steps):
            x = x - lam * self.energy_grad(x, t) + noise_scale * draw()
        return x.detach()

    def _eps_from_energy(self, x: torch.Tensor, t: torch.Tensor,
                         create_graph: bool = False) -> torch.Tensor:
        """ε̂ = √(1−ᾱ_t)·∇ₓE(x, t): the energy's score −∇ₓE matched to the
        Gaussian-perturbation score −ε/√(1−ᾱ_t), as a unit-scale ε."""
        sigma = torch.sqrt(1.0 - self.schedule.alphas_cumprod[t])
        return sigma[:, None, None, None] * self.energy_grad(x, t,
                                                             create_graph)

    def loss_function(self, x: torch.Tensor,
                      t: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      y: Optional[torch.Tensor] = None,
                      per_sample: bool = False,
                      langevin_noise: Optional[Sequence[torch.Tensor]] = None,
                      alpha: Optional[torch.Tensor] = None,
                      rows: Rows = None) -> torch.Tensor:
        """Training loss of NHWC images ``x`` (labels ``y`` are ignored):
        t ~ U[0, T), ε ~ N(0, I), x_t = q_sample(x, t, ε); then "dsm"
        regresses ε̂(x_t, t) onto ε, and "cd" runs Langevin from x_t to
        the negatives (``langevin_noise``: one draw a step) and takes CD
        + GP at interpolates α ~ U[0, 1) [B, 1, 1, 1] (``alpha``), or the
        ``DiffusionLoss`` on the energies. Undrawn inputs come from
        ``generator``. ``per_sample``: [B] losses. ``rows``: ``x`` is
        those rows of a global batch, and every draw, made or given, is
        the global batch's (:func:`.base.row_draws`)."""
        b = x.shape[0]
        n, keep = row_draws(b, rows)
        if t is None:
            t = torch.randint(0, self.num_timesteps, (n,),
                              generator=generator, device=x.device)
        if noise is None:
            noise = torch.randn((n, *x.shape[1:]), generator=generator,
                                device=x.device, dtype=x.dtype)
        t_all, t, noise = t, t[keep], noise[keep]
        x_noisy = q_sample(self.schedule, x, t, noise)
        if self.training_objective == "dsm":
            eps = self._eps_from_energy(x_noisy, t, torch.is_grad_enabled())
            err = (eps - noise) ** 2
            return err.reshape(b, -1).mean(dim=1) if per_sample \
                else err.mean()
        draw = self._drawer((n, *x.shape[1:]), generator, langevin_noise)
        x_fake = self._langevin(x_noisy, t, lambda: draw()[keep])

        def energy_fn(z):
            return self.energy_scale * self.apply(z, t)

        if self.loss_fn is None:
            if alpha is None:
                alpha = torch.rand((n, 1, 1, 1), generator=generator,
                                   device=x.device, dtype=x.dtype)
            return energy_based_loss(energy_fn, x, x_fake, alpha[keep],
                                     self.regularization_weight, per_sample)
        real, fake = energy_fn(x), energy_fn(x_fake)
        if per_sample:
            return self.loss_fn.per_sample(real, fake, t)
        return self.loss_fn(real, fake, t_all, keep)

    # -- sampling ---------------------------------------------------------
    def _ancestral_range(self, x: torch.Tensor, t_hi: int, t_lo: int,
                         draw: Draw) -> torch.Tensor:
        """DDPM's posterior steps t_hi−1 … t_lo on the energy's ε̂, one
        draw a step (masked at t = 0)."""
        b = x.shape[0]
        for t in range(t_hi - 1, t_lo - 1, -1):
            t_b = self._t(b, t)
            x = ddpm_posterior_step(self.schedule, x, t_b,
                                    self._eps_from_energy(x, t_b), draw())
        return x

    def _sweep_range(self, x: torch.Tensor, t_hi: int, t_lo: int,
                     draw: Draw) -> torch.Tensor:
        """Levels t_hi−1 … t_lo: Langevin at each, then noise re-injected
        towards level t−1 for t > 0. Draws: ``langevin_steps``, then one
        for the re-injection (drawn at t = 0 too, and unused there)."""
        b = x.shape[0]
        ac = self.schedule.alphas_cumprod
        for t in range(t_hi - 1, t_lo - 1, -1):
            x = self._langevin(x, self._t(b, t), draw)
            noise = draw()
            if t > 0:
                a, a_next = ac[t], ac[t - 1]
                sigma = torch.sqrt((1 - a_next) / (1 - a)) * torch.sqrt(
                    torch.clamp(1 - a / a_next, min=0.0))
                x = torch.sqrt(a_next / a) * x + sigma * noise
        return x

    def _sweep(self, x: torch.Tensor, t_hi: int, t_lo: int,
               draw: Draw) -> torch.Tensor:
        rng = self._ancestral_range if self.training_objective == "dsm" \
            else self._sweep_range
        return rng(x, t_hi, t_lo, draw)

    @torch.no_grad()
    def generate_samples(self, batch_size: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Noise = None) -> torch.Tensor:
        """The reverse sweep over all T levels ("cd"), or the T-step
        ancestral chain on ε̂ ("dsm"). Draws: x_T, then each level's in
        the order of :meth:`_sweep_range` or one a step. Returns f32 NHWC
        samples."""
        draw = self._drawer(self.sample_shape(batch_size), generator, noise)
        x = self._init_noise(batch_size, draw)
        return self._sweep(x, self.num_timesteps, 0, draw)

    @torch.no_grad()
    def generate_samples_with_intermediates(
            self, batch_size: int,
            generator: Optional[torch.Generator] = None,
            save_interval: int = 100) -> List[torch.Tensor]:
        """The sampler with frames: x_T, then x after each level t with
        t % save_interval == 0 (t = 0 always included)."""
        draw = self._drawer(self.sample_shape(batch_size), generator, None)
        x = self._init_noise(batch_size, draw)
        frames = [x]
        save_ts = sorted(set(range(0, self.num_timesteps, save_interval))
                         | {0}, reverse=True)
        t_hi = self.num_timesteps
        for t_save in save_ts:
            x = self._sweep(x, t_hi, t_save, draw)
            frames.append(x)
            t_hi = t_save
        return frames
