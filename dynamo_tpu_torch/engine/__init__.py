"""The PyTorch/CUDA inference engine: continuous batching over a paged KV pool."""

from .config import EngineConfig, UnsupportedConfigError
from .engine import TorchEngine, UnsupportedRequestError

__all__ = [
    "EngineConfig", "TorchEngine", "UnsupportedConfigError",
    "UnsupportedRequestError",
]
