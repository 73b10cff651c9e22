"""The port's LLM stack: the dense decoder (``model.py``) and its building
blocks (``layers.py``)."""
from .model import Model, UnsupportedConfigError, init_cache, init_params

__all__ = ["Model", "UnsupportedConfigError", "init_cache", "init_params"]
