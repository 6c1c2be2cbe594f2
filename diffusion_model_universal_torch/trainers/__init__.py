"""Trainers of the port (counterpart of the reference's ``trainers/``).

:class:`DiffusionTrainer` is the engine; DDPM uses it as it is, DDIM logs
its sampler's settings once (its sample grids take one column per saved
DDIM position, from the model's own intermediates). The score-based and
energy-based trainers are not ported yet.
"""

from .optim import Adam, make_lr_schedule, make_optimizer
from .trainer import DiffusionTrainer


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


TRAINER_REGISTRY = {"ddpm": DDPMTrainer, "ddim": DDIMTrainer}

__all__ = ["Adam", "DDIMTrainer", "DDPMTrainer", "DiffusionTrainer", "TRAINER_REGISTRY",
           "make_lr_schedule", "make_optimizer"]
