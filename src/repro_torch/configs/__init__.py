from .base import ModelConfig, get_config, list_archs

__all__ = ["ModelConfig", "get_config", "list_archs"]
