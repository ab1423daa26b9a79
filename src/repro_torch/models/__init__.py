"""Decoder LM family of the port: GQA and Mamba2 serving path."""
from .model import DecodeDims, Model, ModelConfig  # noqa: F401
