from .backend import TensorBackend
from .dispatch import (available_backends, current_backend, get_backend,
                       register_backend, set_backend, use_backend)
from .hopper_backend import HopperBackend
from .torch_backend import TorchBackend
from . import ops

__all__ = [
    "TensorBackend", "TorchBackend", "HopperBackend", "ops",
    "available_backends", "current_backend", "get_backend",
    "register_backend", "set_backend", "use_backend",
]
