"""Trainers of the port (counterpart of the reference's ``trainers/``).

:class:`DiffusionTrainer` is the engine; DDPM uses it as it is, DDIM logs
its sampler's settings once (its sample grids take one column per saved
DDIM position, from the model's own intermediates). The score-based and
energy-based trainers log their own settings once and draw their sample
grids from the model's own sampler (its final samples, one image each).
"""

import contextlib

import torch

from ..utils.images import save_image
from .optim import Adam, make_lr_schedule, make_optimizer
from .trainer import _SEED_STRIDE, DiffusionTrainer


class DDPMTrainer(DiffusionTrainer):
    """DDPM training (the engine defaults)."""


class DDIMTrainer(DiffusionTrainer):
    """DDIM training: logs ``ddim/sampling_steps`` and ``ddim/eta`` at
    step 0."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logger.log({
            "ddim/sampling_steps": self.model.ddim_sampling_steps,
            "ddim/eta": self.model.eta,
        }, 0)


class _OwnSamplerTrainer(DiffusionTrainer):
    """Sample grids from the model's ``generate_samples``."""

    def generate_samples(self, epoch: int, num_samples: int = 4,
                         use_ema: bool = False) -> str:
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 99) * _SEED_STRIDE + epoch)
        with self.ema_weights() if use_ema else contextlib.nullcontext():
            samples = self.model.generate_samples(num_samples, gen)
        path = self.output_dir / "samples" / f"epoch_{epoch}.png"
        if not self.is_main:     # another rank of a spatial group
            return str(path)
        return save_image(samples.cpu().numpy(), str(path))


class ScoreBasedTrainer(_OwnSamplerTrainer):
    """Score-based training: logs ``score/sigma_min``, ``sigma_max``,
    ``beta`` and ``num_scales`` at step 0; grids by annealed Langevin."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logger.log({
            "score/sigma_min": self.model.sigma_min,
            "score/sigma_max": self.model.sigma_max,
            "score/beta": self.model.beta,
            "score/num_scales": self.model.num_scales,
        }, 0)


class EnergyBasedTrainer(_OwnSamplerTrainer):
    """Energy-based training: logs ``energy/scale``,
    ``regularization_weight``, ``langevin_step_size`` and
    ``langevin_steps`` at step 0; grids by the model's sweep."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.logger.log({
            "energy/scale": self.model.energy_scale,
            "energy/regularization_weight":
                self.model.regularization_weight,
            "energy/langevin_step_size": self.model.langevin_step_size,
            "energy/langevin_steps": self.model.langevin_steps,
        }, 0)


TRAINER_REGISTRY = {"ddpm": DDPMTrainer, "ddim": DDIMTrainer,
                    "score_based": ScoreBasedTrainer,
                    "energy_based": EnergyBasedTrainer}

__all__ = ["Adam", "DDIMTrainer", "DDPMTrainer", "DiffusionTrainer",
           "EnergyBasedTrainer", "ScoreBasedTrainer", "TRAINER_REGISTRY",
           "make_lr_schedule", "make_optimizer"]
