"""Data pipelines of the port."""
from .synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
