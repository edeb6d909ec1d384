"""Step-size schedules of the port."""
from .schedules import (constant, cosine, linear_warmup, scale_grads,
                        warmup_cosine)

__all__ = ["constant", "cosine", "linear_warmup", "warmup_cosine",
           "scale_grads"]
