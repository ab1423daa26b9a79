"""Synthetic data pipelines for the training driver."""
from .pipeline import SyntheticLMData  # noqa
