"""Step-size schedules: the counterpart of ``repro/optim/schedules.py``.

A schedule maps a step (a Python int or a tensor) to an f32 multiplier
tensor, computed in f32 as the JAX package computes it.  They compose with
every algorithm through :func:`scale_grads`: the optimizer keeps its α and
the gradient is scaled before the update, which for every algorithm of
:mod:`repro_torch.core.optimizers` equals scaling α (all are linear in the
gradient path) and leaves the bias-correction recursion intact.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.mixing import tree_map

__all__ = ["constant", "cosine", "linear_warmup", "warmup_cosine",
           "scale_grads"]

Schedule = Callable[[object], torch.Tensor]   # step -> f32 multiplier


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(value: float = 1.0) -> Schedule:
    return lambda step: torch.tensor(value, dtype=torch.float32)


def linear_warmup(warmup_steps: int, base: float = 1.0) -> Schedule:
    def f(step):
        s = _f32(step)
        return base * torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)
    return f


def cosine(total_steps: int, base: float = 1.0,
           floor: float = 0.1) -> Schedule:
    def f(step):
        s = torch.clamp(_f32(step), 0, total_steps)
        cos = 0.5 * (1.0 + torch.cos(math.pi * s / max(total_steps, 1)))
        return base * (floor + (1.0 - floor) * cos)
    return f


def warmup_cosine(warmup_steps: int, total_steps: int, base: float = 1.0,
                  floor: float = 0.1) -> Schedule:
    w = linear_warmup(warmup_steps, base)
    c = cosine(total_steps, base, floor)

    def f(step):
        return torch.where(_f32(step) < warmup_steps, w(step), c(step))
    return f


def scale_grads(grads, step, schedule: Schedule):
    """Multiply every gradient leaf by ``schedule(step)`` in f32 and round
    back to the leaf's dtype."""
    m = schedule(step)
    return tree_map(lambda g: (m.to(g.device) * g.float()).to(g.dtype),
                    grads)
