"""Trainers of the port (counterpart of the reference's ``trainers/``).

:class:`DiffusionTrainer` is the engine; DDPM uses it as it is. The other
families' trainers are not ported yet.
"""

from .optim import Adam, make_lr_schedule, make_optimizer
from .trainer import DiffusionTrainer


class DDPMTrainer(DiffusionTrainer):
    """DDPM training (the engine defaults)."""


TRAINER_REGISTRY = {"ddpm": DDPMTrainer}

__all__ = ["Adam", "DDPMTrainer", "DiffusionTrainer", "TRAINER_REGISTRY",
           "make_lr_schedule", "make_optimizer"]
