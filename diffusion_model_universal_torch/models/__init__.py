"""Model families of the port and their registry (keyed by the CLI
``--model_type`` strings)."""

from .base import BaseDiffusionModel
from .ddim import DDIM
from .ddpm import DDPM
from .energy_based import EnergyBasedDiffusion, EnergyNet
from .score_based import ScoreBasedDiffusion
from .unet import UNet

MODEL_REGISTRY = {"ddpm": DDPM, "ddim": DDIM,
                  "score_based": ScoreBasedDiffusion,
                  "energy_based": EnergyBasedDiffusion}

__all__ = ["BaseDiffusionModel", "DDIM", "DDPM", "EnergyBasedDiffusion",
           "EnergyNet", "ScoreBasedDiffusion", "UNet", "MODEL_REGISTRY"]
