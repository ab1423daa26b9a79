"""The LM family of the port: every config, unsharded and sharded."""
from .model import DecodeDims, Model, ModelConfig  # noqa: F401
from .sharding import ParallelCtx  # noqa: F401
