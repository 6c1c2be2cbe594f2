"""Model families of the port and their registry (keyed by the CLI
``--model_type`` strings)."""

from .base import BaseDiffusionModel
from .ddpm import DDPM
from .unet import UNet

MODEL_REGISTRY = {"ddpm": DDPM}

__all__ = ["BaseDiffusionModel", "DDPM", "UNet", "MODEL_REGISTRY"]
