"""Noise schedules and the core diffusion math (counterpart of the
reference's ``models/schedules.py``, the DDPM sampling and training
slice).

Schedules are f32 tensors on the model's device; per-step math gathers
them with [B] integer timesteps and broadcasts to NHWC image rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Precomputed DDPM-style discrete noise schedule ([T] tensors)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]


def linear_beta_schedule(beta_start: float, beta_end: float,
                         num_timesteps: int) -> torch.Tensor:
    return torch.linspace(beta_start, beta_end, num_timesteps,
                          dtype=torch.float32)


def cosine_beta_schedule(num_timesteps: int, s: float = 0.008
                         ) -> torch.Tensor:
    """Cosine schedule (Nichol & Dhariwal 2021), built in float64 and
    stored in f32."""
    steps = np.arange(num_timesteps + 1, dtype=np.float64)
    f = np.cos(((steps / num_timesteps) + s) / (1 + s) * np.pi / 2) ** 2
    alphas_cumprod = f / f[0]
    betas = 1.0 - alphas_cumprod[1:] / alphas_cumprod[:-1]
    return torch.tensor(np.clip(betas, 0.0, 0.999), dtype=torch.float32)


def quadratic_beta_schedule(beta_start: float, beta_end: float,
                            num_timesteps: int) -> torch.Tensor:
    """Linspace in sqrt-β space, squared."""
    return torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                          dtype=torch.float32) ** 2


def make_noise_schedule(beta_start: float = 1e-4, beta_end: float = 2e-2,
                        num_timesteps: int = 1000,
                        schedule_type: str = "linear",
                        device="cpu") -> NoiseSchedule:
    if schedule_type == "linear":
        betas = linear_beta_schedule(beta_start, beta_end, num_timesteps)
    elif schedule_type == "cosine":
        betas = cosine_beta_schedule(num_timesteps)
    elif schedule_type == "quadratic":
        betas = quadratic_beta_schedule(beta_start, beta_end, num_timesteps)
    else:
        raise ValueError(f"Unknown schedule type: {schedule_type}")
    return schedule_from_betas(betas.to(device))


def schedule_from_betas(betas: torch.Tensor) -> NoiseSchedule:
    """Precompute every derived buffer from a β table."""
    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    alphas_cumprod_prev = torch.cat(
        [torch.ones(1, dtype=betas.dtype, device=betas.device),
         alphas_cumprod[:-1]])
    return NoiseSchedule(
        betas=betas,
        alphas=alphas,
        alphas_cumprod=alphas_cumprod,
        alphas_cumprod_prev=alphas_cumprod_prev,
        sqrt_alphas_cumprod=torch.sqrt(alphas_cumprod),
        sqrt_one_minus_alphas_cumprod=torch.sqrt(1.0 - alphas_cumprod),
        posterior_variance=((1.0 - alphas_cumprod_prev)
                            / (1.0 - alphas_cumprod) * betas),
    )


def _bcast(coef: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast to NHWC rank."""
    return coef[t][:, None, None, None]


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion: x_t = √ᾱ_t·x₀ + √(1-ᾱ_t)·ε."""
    return (_bcast(schedule.sqrt_alphas_cumprod, t) * x0
            + _bcast(schedule.sqrt_one_minus_alphas_cumprod, t) * noise)


PREDICTION_TYPES = ("epsilon", "v", "x0")


def prediction_to_eps(schedule: NoiseSchedule, pred: torch.Tensor,
                      x_t: torch.Tensor, t: torch.Tensor,
                      prediction_type: str) -> torch.Tensor:
    """Convert a network output in any supported parameterization to ε̂:

    * epsilon: ε̂ = out
    * v:       ε̂ = √ᾱ_t·out + √(1−ᾱ_t)·x_t
    * x0:      ε̂ = (x_t − √ᾱ_t·out) / √(1−ᾱ_t)
    """
    if prediction_type == "epsilon":
        return pred
    a = _bcast(schedule.sqrt_alphas_cumprod, t)
    s = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t)
    if prediction_type == "v":
        return a * pred + s * x_t
    if prediction_type == "x0":
        return (x_t - a * pred) / s
    raise ValueError(f"prediction_type must be one of {PREDICTION_TYPES}, "
                     f"got {prediction_type!r}")


def prediction_target(schedule: NoiseSchedule, x0: torch.Tensor,
                      noise: torch.Tensor, t: torch.Tensor,
                      prediction_type: str) -> torch.Tensor:
    """Training target of a parameterization at q-sampled (x₀, ε, t): the
    inverse of :func:`prediction_to_eps` at x_t = q_sample(x₀, t, ε).

    * epsilon: ε
    * x0:      x₀
    * v:       √ᾱ_t·ε − √(1−ᾱ_t)·x₀
    """
    if prediction_type == "epsilon":
        return noise
    if prediction_type == "x0":
        return x0
    if prediction_type == "v":
        a = _bcast(schedule.sqrt_alphas_cumprod, t)
        s = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t)
        return a * noise - s * x0
    raise ValueError(f"prediction_type must be one of {PREDICTION_TYPES}, "
                     f"got {prediction_type!r}")


def ddpm_posterior_step(schedule: NoiseSchedule, x: torch.Tensor,
                        t: torch.Tensor, eps_pred: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """One ancestral reverse step (Algorithm 2 of Ho et al.):
    μ = α_t^{-1/2}·(x − β_t/√(1-ᾱ_t)·ε̂), plus √β̃_t·z where t > 0."""
    beta_t = _bcast(schedule.betas, t)
    inv_sqrt_alpha_t = torch.rsqrt(_bcast(schedule.alphas, t))
    sqrt_one_minus_ac = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t)
    mean = inv_sqrt_alpha_t * (x - beta_t / sqrt_one_minus_ac * eps_pred)
    sigma = torch.sqrt(_bcast(schedule.posterior_variance, t))
    nonzero = (t > 0).to(x.dtype)[:, None, None, None]
    return mean + nonzero * sigma * noise
