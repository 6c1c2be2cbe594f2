"""Model families of the port and their registry (keyed by the CLI
``--model_type`` strings)."""

from .base import BaseDiffusionModel
from .ddim import DDIM
from .ddpm import DDPM
from .unet import UNet

MODEL_REGISTRY = {"ddpm": DDPM, "ddim": DDIM}

__all__ = ["BaseDiffusionModel", "DDIM", "DDPM", "UNet", "MODEL_REGISTRY"]
