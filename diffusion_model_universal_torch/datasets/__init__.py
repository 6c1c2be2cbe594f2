"""Datasets and the data pipeline of the port."""

from .registry import DATASET_REGISTRY, get_dataset

__all__ = ["DATASET_REGISTRY", "get_dataset"]
