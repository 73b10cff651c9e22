from .base import ARCH_IDS, ModelConfig, get_config, register

__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "register"]
