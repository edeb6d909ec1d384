"""Diagnostics: the counterpart of ``repro/core/metrics.py``.

Tree metrics reduce in f32 with ``sum``, one leaf at a time (a tree is a
``{path: tensor}`` dict or one tensor; leaves carry the agent axis).  The
bus metrics use that the bus pads are zero, so one reduction over the
``(A, rows, 128)`` buffer equals the per-leaf reduction over the tree;
they reduce one agent's row block at a time, so that the f32 temporaries
stay at one agent's size on a multi-gigabyte bus.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .mixing import tree_map

__all__ = ["tree_sqnorm", "agent_mean", "consensus_distance",
           "bus_consensus", "bus_grad_norm"]


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, Mapping) else [tree]


def tree_sqnorm(tree) -> torch.Tensor:
    """Σ over leaves of Σ leaf², each leaf squared and summed in f32."""
    return sum(leaf.float().square().sum() for leaf in _leaves(tree))


def agent_mean(tree):
    """x̄ = (1/n) Σ_i x_i over the leading agent axis (kept, size 1), in
    each leaf's dtype."""
    return tree_map(lambda leaf: leaf.mean(dim=0, keepdim=True), tree)


def consensus_distance(tree) -> torch.Tensor:
    """‖X − X̄‖²_F, the paper's deviation term, in f32; the deviation of
    each leaf is taken in its own dtype, as in the JAX package."""
    return sum((leaf - leaf.mean(dim=0, keepdim=True)).float().square().sum()
               for leaf in _leaves(tree))


def _sq_sum(rows) -> torch.Tensor:
    return sum(r.float().square().sum() for r in rows)


def bus_consensus(bus: torch.Tensor) -> torch.Tensor:
    """‖X − X̄‖²_F over the agent axis, in f32."""
    mean = bus.float().mean(dim=0)
    return _sq_sum(b.float() - mean for b in bus)


def bus_grad_norm(g_bus: torch.Tensor) -> torch.Tensor:
    """Global gradient norm over a packed gradient bus, in f32."""
    return _sq_sum(g_bus).sqrt()
