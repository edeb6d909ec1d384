"""Models of the port (dense decoder LM)."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
