"""Noise schedules and the core diffusion math (counterpart of the
reference's ``models/schedules.py``): the DDPM schedule and steps, the
learned-variance (VLB) terms, the tables of the DDIM, DPM-Solver++,
Karras-Heun and strided samplers, and the score family's σ ladder.

Schedules are f32 tensors on the model's device; per-step math gathers
them with [B] integer timesteps and broadcasts to NHWC image rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

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


def respace_timesteps(num_timesteps: int, num_sampling_steps: int
                      ) -> torch.Tensor:
    """Evenly respaced timestep subsequence for the strided ancestral
    sampler (iDDPM §4): S indices from 0 to T−1 inclusive, strictly
    increasing (int64, on the CPU)."""
    if not 2 <= num_sampling_steps <= num_timesteps:
        raise ValueError(
            f"num_steps must be in [2, {num_timesteps}] "
            f"(got {num_sampling_steps})")
    ts = np.round(np.linspace(0, num_timesteps - 1,
                              num_sampling_steps)).astype(np.int64)
    assert (np.diff(ts) > 0).all()  # spacing ≥ 1 ⇒ no duplicates
    return torch.from_numpy(ts)


def respaced_schedule(schedule: NoiseSchedule,
                      timesteps: torch.Tensor) -> NoiseSchedule:
    """The coarse schedule over a timestep subsequence: the marginals
    ᾱ_new[i] = ᾱ[ts[i]] kept, β_new[i] = 1 − ᾱ_new[i]/ᾱ_new[i−1] (with
    ᾱ_new[−1] := 1), every other buffer derived from β_new."""
    abar = schedule.alphas_cumprod[timesteps.to(
        schedule.alphas_cumprod.device)]
    abar_prev = torch.cat([torch.ones(1, dtype=abar.dtype,
                                      device=abar.device), abar[:-1]])
    return schedule_from_betas(1.0 - abar / abar_prev)


def posterior_log_variance_clipped(schedule: NoiseSchedule) -> torch.Tensor:
    """log β̃_t with β̃_0 (exactly 0) replaced by β̃_1: the lower end of
    the learned-range interpolation and the true posterior's
    log-variance in the VLB."""
    pv = schedule.posterior_variance
    return torch.log(torch.cat([pv[1:2], pv[1:]]))


def learned_range_log_variance(schedule: NoiseSchedule, v: torch.Tensor,
                               t: torch.Tensor) -> torch.Tensor:
    """iDDPM's learned-range variance (eq. 15): log σ²_t = f·log β_t +
    (1−f)·log β̃_t with f = (v+1)/2, ``v`` the raw variance head
    (unclamped), in f32."""
    min_log = _bcast(posterior_log_variance_clipped(schedule), t)
    max_log = _bcast(torch.log(schedule.betas), t)
    frac = (v.float() + 1.0) * 0.5
    return frac * max_log + (1.0 - frac) * min_log


def q_posterior_mean(schedule: NoiseSchedule, x0: torch.Tensor,
                     x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Mean of q(x_{t−1} | x_t, x₀):
    √ᾱ_{t−1}·β_t/(1−ᾱ_t)·x₀ + √α_t·(1−ᾱ_{t−1})/(1−ᾱ_t)·x_t."""
    c0 = (torch.sqrt(schedule.alphas_cumprod_prev) * schedule.betas
          / (1.0 - schedule.alphas_cumprod))
    ct = (torch.sqrt(schedule.alphas) * (1.0 - schedule.alphas_cumprod_prev)
          / (1.0 - schedule.alphas_cumprod))
    return _bcast(c0, t) * x0 + _bcast(ct, t) * x_t


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, e^{logvar1}) ‖ N(mean2, e^{logvar2})), elementwise, in
    nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def discretized_gaussian_log_likelihood(x: torch.Tensor, means: torch.Tensor,
                                        log_scales: torch.Tensor
                                        ) -> torch.Tensor:
    """log p(x) of images in [−1, 1] quantized to 256 levels under
    N(means, e^{2·log_scales}): the mass of the 2/255-wide bin around x
    (open-ended edge bins), through the tanh approximation of the normal
    CDF."""
    def cdf(z):
        return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (z + 0.044715 * z ** 3)))

    inv_std = torch.exp(-log_scales)
    plus = cdf((x - means + 1.0 / 255.0) * inv_std)
    minus = cdf((x - means - 1.0 / 255.0) * inv_std)
    log_plus = torch.log(torch.clamp(plus, min=1e-12))
    log_one_minus = torch.log(torch.clamp(1.0 - minus, min=1e-12))
    log_delta = torch.log(torch.clamp(plus - minus, min=1e-12))
    return torch.where(x < -0.999, log_plus,
                       torch.where(x > 0.999, log_one_minus, log_delta))


def vlb_term_bits(schedule: NoiseSchedule, x0: torch.Tensor,
                  x_t: torch.Tensor, t: torch.Tensor, eps_pred: torch.Tensor,
                  log_var: torch.Tensor) -> torch.Tensor:
    """[B] VLB term L_{t−1} in bits/dim: KL(q(x_{t−1}|x_t,x₀) ‖
    p(x_{t−1}|x_t)) for t > 0, −log p(x₀|x₁) for t = 0; the model mean from
    ``eps_pred`` with x̂₀ clipped to [−1, 1]."""
    true_mean = q_posterior_mean(schedule, x0, x_t, t)
    true_logvar = _bcast(posterior_log_variance_clipped(schedule), t)
    a = _bcast(schedule.sqrt_alphas_cumprod, t)
    s = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t)
    model_x0 = torch.clamp((x_t - s * eps_pred) / a, -1.0, 1.0)
    model_mean = q_posterior_mean(schedule, model_x0, x_t, t)
    kl = normal_kl(true_mean, true_logvar, model_mean, log_var)
    kl = kl.reshape(kl.shape[0], -1).mean(dim=1) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(x0, model_mean, 0.5 * log_var)
    nll = nll.reshape(nll.shape[0], -1).mean(dim=1) / math.log(2.0)
    return torch.where(t == 0, nll, kl)


def ddpm_posterior_step_learned(schedule: NoiseSchedule, x: torch.Tensor,
                                t: torch.Tensor, eps_pred: torch.Tensor,
                                log_var: torch.Tensor,
                                noise: torch.Tensor) -> torch.Tensor:
    """Ancestral reverse step with the model's learned log-variance: the
    mean of :func:`ddpm_posterior_step`, σ = e^{log_var/2}."""
    beta_t = _bcast(schedule.betas, t)
    inv_sqrt_alpha_t = torch.rsqrt(_bcast(schedule.alphas, t))
    sqrt_one_minus_ac = _bcast(schedule.sqrt_one_minus_alphas_cumprod, t)
    mean = inv_sqrt_alpha_t * (x - beta_t / sqrt_one_minus_ac * eps_pred)
    sigma = torch.exp(0.5 * log_var).to(x.dtype)
    nonzero = (t > 0).to(x.dtype)[:, None, None, None]
    return mean + nonzero * sigma * noise


# -- the fast samplers' timestep tables ------------------------------------
# The reference builds these tables in f32 before converting to integers,
# so one ulp can move a timestep. _linspace_f32 does the f32 arithmetic of
# jnp.linspace as XLA compiles it (the division by S−1 a multiply by its
# f32 reciprocal, folded into the stop term); the Karras grid runs in f32
# on the CPU (numpy's sqrt, torch's pow and log), which gives the
# reference's table.

def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """f32 ``jnp.linspace(start, stop, num)`` as XLA computes it:
    start·(1 − i·r) + (stop·r)·i with r = 1/(num−1) in f32, the last entry
    ``stop``."""
    f = np.float32
    s0, s1 = f(start), f(stop)
    if num == 1:
        return np.array([s0], f)
    it = np.arange(num - 1, dtype=f)
    r = f(1) / f(num - 1)
    out = s0 * (f(1) - it * r) + (s1 * r) * it
    return np.concatenate([out, [s1]]).astype(f)


def ddim_timesteps(num_timesteps: int, num_sampling_steps: int,
                   method: str = "uniform") -> torch.Tensor:
    """The DDIM timestep subsequence (int64, CPU): ``uniform`` =
    arange(0, T, T//S) (more than S entries when S does not divide T; the
    sampler visits the first S), ``quad`` = linspace(0, √(0.8·T), S)²
    truncated."""
    if method == "uniform":
        c = num_timesteps // num_sampling_steps
        return torch.arange(0, num_timesteps, c, dtype=torch.long)
    if method == "quad":
        ts = _linspace_f32(0, (num_timesteps * 0.8) ** 0.5,
                           num_sampling_steps)
        return torch.from_numpy((ts * ts).astype(np.int32).astype(np.int64))
    raise NotImplementedError(f"Unknown discretization method: {method}")


@dataclasses.dataclass(frozen=True)
class DDIMParams:
    """DDIM sampling buffers, indexed by step position i (not by
    timestep value): the timesteps, ᾱ and ᾱ_prev at them, the η-scaled σ
    and √(1−ᾱ)."""

    timesteps: torch.Tensor
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    sigmas: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor


def make_ddim_params(schedule: NoiseSchedule, num_sampling_steps: int = 50,
                     method: str = "uniform", eta: float = 0.0) -> DDIMParams:
    """DDIM buffers with σ = η·√((1−ᾱ_prev)/(1−ᾱ)·(1−ᾱ/ᾱ_prev))."""
    ac = schedule.alphas_cumprod
    ts = ddim_timesteps(schedule.num_timesteps, num_sampling_steps,
                        method).to(ac.device)
    alphas = ac[ts]
    alphas_prev = torch.cat([ac[0:1], ac[ts[:-1]]])
    sigmas = eta * torch.sqrt(
        (1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return DDIMParams(timesteps=ts, alphas=alphas, alphas_prev=alphas_prev,
                      sigmas=sigmas,
                      sqrt_one_minus_alphas=torch.sqrt(1.0 - alphas))


def ddim_step(params: DDIMParams, x: torch.Tensor, i: int,
              eps_pred: torch.Tensor, noise: Optional[torch.Tensor],
              eta: float) -> torch.Tensor:
    """One DDIM update at step position ``i``: x̂₀ clamped to [−1, 1], the
    direction √(1−ᾱ_prev−σ²)·ε̂, and for η > 0 the noise clamped to
    [−3, 3] times σ."""
    alpha = params.alphas[i]
    alpha_prev = params.alphas_prev[i]
    sigma = params.sigmas[i]
    pred_x0 = (x - params.sqrt_one_minus_alphas[i] * eps_pred) \
        * torch.rsqrt(alpha)
    pred_x0 = torch.clamp(pred_x0, -1.0, 1.0)
    dir_xt = torch.sqrt(torch.clamp(1.0 - alpha_prev - sigma ** 2,
                                    min=0.0)) * eps_pred
    out = torch.sqrt(alpha_prev) * pred_x0 + dir_xt
    if eta > 0:
        out = out + sigma * torch.clamp(noise, -3.0, 3.0)
    return out


@dataclasses.dataclass(frozen=True)
class DPMSolverParams:
    """DPM-Solver++(2M) buffers: S timesteps from T−1 down to 0, α = √ᾱ,
    σ = √(1−ᾱ) and λ = log(α/σ) at them."""

    timesteps: torch.Tensor
    alpha: torch.Tensor
    sigma: torch.Tensor
    lam: torch.Tensor


def make_dpm_solver_params(schedule: NoiseSchedule,
                           num_sampling_steps: int = 20) -> DPMSolverParams:
    """S timesteps uniform in t (linspace(T−1, 0, S) in f32, rounded half
    to even) and the half-log-SNR grid."""
    T = schedule.num_timesteps
    ts = np.round(_linspace_f32(T - 1, 0, num_sampling_steps)).astype(
        np.int64)
    ac = schedule.alphas_cumprod
    abar = ac[torch.from_numpy(ts).to(ac.device)]
    alpha = torch.sqrt(abar)
    sigma = torch.sqrt(1.0 - abar)
    return DPMSolverParams(timesteps=torch.from_numpy(ts).to(ac.device),
                           alpha=alpha, sigma=sigma,
                           lam=torch.log(alpha / sigma))


@dataclasses.dataclass(frozen=True)
class KarrasHeunParams:
    """Karras-spaced Heun buffers: the ρ-spaced σ̂ grid snapped to the
    discrete schedule (decreasing timesteps), √ᾱ and σ̂ = √(1−ᾱ)/√ᾱ at
    them."""

    timesteps: torch.Tensor
    alpha: torch.Tensor
    sigma_hat: torch.Tensor


def make_karras_heun_params(schedule: NoiseSchedule,
                            num_sampling_steps: int = 18,
                            rho: float = 7.0) -> KarrasHeunParams:
    """σ̂ᵢ = (σ̂_max^{1/ρ} + i/(S−1)·(σ̂_min^{1/ρ} − σ̂_max^{1/ρ}))^ρ, each
    snapped to argmin_t |log σ̂(t) − log σ̂ᵢ| (f32, on the CPU)."""
    ac = schedule.alphas_cumprod
    abar = ac.detach().cpu().float().numpy()
    # numpy's f32 sqrt is correctly rounded, as XLA's; torch's vectorized
    # one can differ by an ulp.
    sig_hat_all = torch.from_numpy(np.sqrt((np.float32(1) - abar) / abar))
    s_min, s_max = sig_hat_all[0], sig_hat_all[-1]
    i = torch.from_numpy(_linspace_f32(0.0, 1.0, num_sampling_steps))
    inv = 1.0 / rho
    grid = (s_max ** inv + i * (s_min ** inv - s_max ** inv)) ** rho
    ts = torch.argmin(torch.abs(torch.log(sig_hat_all)[None, :]
                                - torch.log(grid)[:, None]), dim=1)
    ts = ts.to(ac.device)
    abar_s = ac[ts]
    return KarrasHeunParams(timesteps=ts, alpha=torch.sqrt(abar_s),
                            sigma_hat=torch.sqrt((1.0 - abar_s) / abar_s))


def sigma_ladder(sigma_min: float, sigma_max: float,
                 num_scales: int) -> np.ndarray:
    """Geometric σ ladder from σ_max down to σ_min, f32 numpy:
    exp(linspace(ln σ_max, ln σ_min, num_scales)), the linspace as XLA
    computes it."""
    f = np.float32
    logs = _linspace_f32(np.log(f(sigma_max)), np.log(f(sigma_min)),
                         num_scales)
    return np.exp(logs).astype(f)


def continuous_sigma(sigma_min: float, sigma_max: float,
                     u: torch.Tensor) -> torch.Tensor:
    """u ∈ [0, 1] → σ = σ_min·(σ_max/σ_min)^u (geometric interpolation)."""
    return sigma_min * (sigma_max / sigma_min) ** u
