"""The training losses (counterpart of the reference's
``utils/losses.py``): the config-driven ``DiffusionLoss``, denoising
score matching and contrastive divergence with a gradient penalty.

Loss types mse / l1 / huber / hybrid with their per-type weights,
``huber_delta`` and ``hybrid_weights``; per-sample time weights snr /
linear / inverse (affinely rescaled over the batch to [min_weight,
max_weight], as in the reference) and min_snr (absolute). The SNR weights
come from the model's own ᾱ schedule. ``perceptual_weight > 0`` adds that
weight times the VGG16 feature distance (:class:`PerceptualLoss`).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target) ** 2


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """Smooth-L1 with threshold ``delta``: d²/(2δ) inside |d| < δ,
    |d| − δ/2 outside."""
    d = (pred - target).abs()
    return torch.where(d < delta, 0.5 * d ** 2 / delta, d - 0.5 * delta)


def _linear_alphas_cumprod(num_timesteps: int, beta_start: float = 1e-4,
                           beta_end: float = 2e-2) -> torch.Tensor:
    betas = torch.linspace(beta_start, beta_end, num_timesteps)
    return torch.cumprod(1.0 - betas, dim=0)


def snr_weights(t: torch.Tensor, num_timesteps: int,
                alphas_cumprod: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """SNR_t / max SNR from the model's ᾱ (a linear β rebuild when none is
    given), clamped at ≥ 1e-5."""
    if alphas_cumprod is None:
        alphas_cumprod = _linear_alphas_cumprod(num_timesteps).to(t.device)
    snr = alphas_cumprod / (1.0 - alphas_cumprod)
    return torch.clamp(snr[t] / snr.max(), min=1e-5)


def min_snr_weights(t: torch.Tensor, num_timesteps: int,
                    alphas_cumprod: Optional[torch.Tensor], gamma: float,
                    prediction_type: str) -> torch.Tensor:
    """Min-SNR-γ weights (arXiv:2303.09556) in the parameterization's own
    loss: min(SNR, γ) divided by SNR (ε) or SNR + 1 (v)."""
    if alphas_cumprod is None:
        alphas_cumprod = _linear_alphas_cumprod(num_timesteps).to(t.device)
    snr_t = (alphas_cumprod / (1.0 - alphas_cumprod))[t]
    w_x0 = torch.clamp(snr_t, max=gamma)
    if prediction_type == "epsilon":
        return w_x0 / snr_t
    if prediction_type == "v":
        return w_x0 / (snr_t + 1.0)
    return w_x0


class DiffusionLoss:
    """Config-driven diffusion loss: ``loss(pred, target, t)`` → scalar.

    Args:
        loss_type: 'mse' | 'l1' | 'huber' | 'hybrid'.
        loss_config: the YAML ``loss_config`` block.
        num_timesteps: T, for the linear time weight.
        alphas_cumprod: the model's [T] ᾱ schedule, for the SNR weights.
        prediction_type: the min_snr divisor follows it.
    """

    LOSS_TYPES = ("mse", "l1", "huber", "hybrid")

    def __init__(self, loss_type: str = "mse",
                 loss_config: Optional[Dict] = None,
                 num_timesteps: int = 1000,
                 alphas_cumprod: Optional[torch.Tensor] = None,
                 prediction_type: str = "epsilon"):
        self.loss_type = loss_type.lower()
        cfg = loss_config or {}
        if self.loss_type not in self.LOSS_TYPES:
            raise ValueError(f"Unsupported loss type: {loss_type}")
        # The selected type's weight defaults to 1 (the reference's l1/huber
        # weights default to 0 even when selected).
        self.mse_weight = cfg.get("mse_weight", 1.0)
        self.l1_weight = cfg.get(
            "l1_weight", 1.0 if self.loss_type == "l1" else 0.0)
        self.huber_weight = cfg.get(
            "huber_weight", 1.0 if self.loss_type == "huber" else 0.0)
        self.huber_delta = cfg.get("huber_delta", 1.0)
        self.use_hybrid = cfg.get("use_hybrid", self.loss_type == "hybrid")
        hw = cfg.get("hybrid_weights", {}) or {}
        self.hybrid_weights = {"mse": hw.get("mse", 1.0),
                               "l1": hw.get("l1", 0.0),
                               "huber": hw.get("huber", 0.0)}
        self.use_time_weighting = cfg.get("use_time_weighting", True)
        self.time_weight_type = cfg.get("time_weight_type", "snr")
        twp = cfg.get("time_weight_params", {}) or {}
        self.min_weight = twp.get("min_weight", 0.1)
        self.max_weight = twp.get("max_weight", 1.0)
        self.min_snr_gamma = twp.get("gamma", 5.0)
        self.num_timesteps = num_timesteps
        self.alphas_cumprod = alphas_cumprod
        self.prediction_type = prediction_type
        self.perceptual_weight = cfg.get("perceptual_weight", 0.0)
        self._perceptual: Optional[PerceptualLoss] = None
        if self.perceptual_weight > 0:
            self._perceptual = PerceptualLoss()

    def _base_loss(self, pred: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
        if self.use_hybrid:
            total = torch.zeros_like(pred)
            if self.hybrid_weights["mse"] > 0:
                total = total + self.hybrid_weights["mse"] * mse(pred, target)
            if self.hybrid_weights["l1"] > 0:
                total = total + self.hybrid_weights["l1"] * l1(pred, target)
            if self.hybrid_weights["huber"] > 0:
                total = total + self.hybrid_weights["huber"] * huber(
                    pred, target, self.huber_delta)
            return total
        if self.loss_type == "mse":
            return self.mse_weight * mse(pred, target)
        if self.loss_type == "l1":
            return self.l1_weight * l1(pred, target)
        if self.loss_type == "huber":
            return self.huber_weight * huber(pred, target, self.huber_delta)
        raise ValueError(f"Unsupported single loss type: {self.loss_type}")

    def time_weights(self, t: torch.Tensor) -> torch.Tensor:
        """Time weights of [..., N] timesteps, rescaled over the last axis
        (the batch, for a [B] input; each sample alone, for [B, 1])."""
        tf = t.float()
        if self.time_weight_type == "min_snr":
            return min_snr_weights(t, self.num_timesteps,
                                   self.alphas_cumprod, self.min_snr_gamma,
                                   self.prediction_type)
        if self.time_weight_type == "snr":
            w = snr_weights(t, self.num_timesteps, self.alphas_cumprod)
        elif self.time_weight_type == "linear":
            w = 1.0 - tf / float(self.num_timesteps - 1)
        elif self.time_weight_type == "inverse":
            w = 1.0 / (tf + 1.0)
        else:
            w = torch.ones_like(tf)
        lo = w.amin(dim=-1, keepdim=True)
        hi = w.amax(dim=-1, keepdim=True)
        return self.min_weight + (self.max_weight - self.min_weight) * (
            (w - lo) / (hi - lo + 1e-5))

    def per_sample(self, pred: torch.Tensor, target: torch.Tensor,
                   t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] losses, each sample's as the loss of a batch of one (the
        reference's eval vmaps a batch-1 ``loss_function``: over one sample
        the affine rescale gives every sample ``min_weight``)."""
        loss = self._base_loss(pred, target)
        if self.use_time_weighting and t is not None:
            w = self.time_weights(t[:, None])[:, 0]
            loss = loss * w.reshape(w.shape[:1] + (1,) * (loss.dim() - 1))
        loss = loss.reshape(loss.shape[0], -1).mean(dim=1)
        if self._perceptual is not None:
            loss = loss + self.perceptual_weight * \
                self._perceptual.per_sample(pred, target)
        return loss

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 timesteps: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = self._base_loss(pred, target)
        if self.use_time_weighting and timesteps is not None:
            w = self.time_weights(timesteps)
            loss = loss * w.reshape(w.shape[:1] + (1,) * (loss.dim() - 1))
        loss = loss.mean()
        if self._perceptual is not None:
            loss = loss + self.perceptual_weight * self._perceptual(pred,
                                                                    target)
        return loss


class PerceptualLoss:
    """VGG16 feature distance: the sum over the relu1_2, relu2_2 and
    relu3_3 taps of the mean squared difference, on images mapped from
    [−1, 1] to [0, 1] and ImageNet-normalized. Differentiable.

    Weights come from ``weights_path`` or ``$DMU_VGG16_WEIGHTS`` (a
    reference ``.npz`` or a torchvision ``.pth``, ``utils/vgg.py``);
    without a file they are seeded He-normal draws, a proxy that orders
    models. The network follows its inputs' device, in f32.
    """

    def __init__(self, seed: int = 0, weights_path: Optional[str] = None):
        from .vgg import VGG16Features, init_vgg16_, load_vgg16_params
        path = weights_path or os.environ.get("DMU_VGG16_WEIGHTS", "")
        self.net = VGG16Features()
        if path and os.path.exists(path):
            self.net.load_state_dict(load_vgg16_params(path), strict=True)
            self.pretrained = True
        else:
            init_vgg16_(self.net, torch.Generator().manual_seed(seed))
            self.pretrained = False
        self.net.eval().requires_grad_(False)

    def features(self, x: torch.Tensor):
        """NHWC images in [−1, 1] → the three taps (NCHW)."""
        from .inception import imagenet_normalize
        if self.net.features["0"].weight.device != x.device:
            self.net.to(x.device)
        h = (x.float().permute(0, 3, 1, 2) + 1.0) * 0.5
        return self.net(imagenet_normalize(h))

    def _tap_errors(self, pred: torch.Tensor, target: torch.Tensor):
        # One pass over both, so the net runs once a call.
        taps = self.features(torch.cat([pred, target]))
        b = pred.shape[0]
        return [(f[:b] - f[b:]) ** 2 for f in taps]

    def __call__(self, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
        return sum(e.mean() for e in self._tap_errors(pred, target))

    def per_sample(self, pred: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
        """[B] distances, each sample's as a batch of one."""
        return sum(e.reshape(e.shape[0], -1).mean(dim=1)
                   for e in self._tap_errors(pred, target))


def score_matching_loss(score: torch.Tensor, noise: torch.Tensor,
                        sigma: torch.Tensor, weighting: str = "none",
                        per_sample: bool = False) -> torch.Tensor:
    """Denoising score matching of a predicted ``score`` at noise levels
    ``sigma`` [B], whose target is −ε/σ for the ``noise`` ε that made the
    perturbation. ``weighting`` "none" is the plain MSE against −ε/σ;
    "sigma2" weights it by σ², i.e. ‖σ·s + ε‖² (unit-scale targets at
    every level). ``per_sample``: [B] means instead of the batch mean."""
    s = sigma[:, None, None, None]
    if weighting == "sigma2":
        err = (s * score + noise) ** 2
    elif weighting == "none":
        err = (score - (-noise / s)) ** 2
    else:
        raise ValueError(f"unknown DSM weighting: {weighting!r}")
    return err.reshape(err.shape[0], -1).mean(dim=1) if per_sample \
        else err.mean()


def energy_based_loss(energy_fn: Callable[[torch.Tensor], torch.Tensor],
                      x_real: torch.Tensor, x_fake: torch.Tensor,
                      alpha: torch.Tensor,
                      regularization_weight: float = 0.1,
                      per_sample: bool = False) -> torch.Tensor:
    """Contrastive divergence plus a gradient penalty:
    mean E(real) − mean E(fake) + w·mean (‖∇ₓE(x̂)‖₂ − 1)², the norm over
    all non-batch dims (+1e-12 under the root) at the interpolates
    x̂ = α·real + (1 − α)·fake, ``alpha`` [B, 1, 1, 1].

    The penalty's gradient is taken with ``create_graph`` whenever
    gradients are recorded, so the loss differentiates to second order
    in the parameters; under ``no_grad`` it is still computed (with
    autograd on locally) and carries no graph. ``per_sample``: [B]
    terms, each sample's loss as a batch of one."""
    create_graph = torch.is_grad_enabled()
    energy_real = energy_fn(x_real)
    energy_fake = energy_fn(x_fake)
    interp = alpha * x_real + (1 - alpha) * x_fake
    with torch.enable_grad():
        if not interp.requires_grad:
            interp = interp.detach().requires_grad_()
        grads, = torch.autograd.grad(energy_fn(interp).sum(), interp,
                                     create_graph=create_graph)
    grad_norm = torch.sqrt(grads.square().sum(dim=(1, 2, 3)) + 1e-12)
    penalty = (grad_norm - 1.0) ** 2
    if per_sample:
        return energy_real - energy_fake + regularization_weight * penalty
    return (energy_real.mean() - energy_fake.mean()
            + regularization_weight * penalty.mean())
