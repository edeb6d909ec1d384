"""Models of the port (decoder LMs: dense, MoE and SSM families)."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
