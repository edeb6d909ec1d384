"""Packed-bus diagnostics: the counterpart of the bus half of
``repro/core/metrics.py``.  The bus pads are zero, so one reduction over the
``(A, rows, 128)`` buffer equals the per-leaf reduction over the tree.
Both reduce one agent's row block at a time, so that the f32 temporaries
stay at one agent's size on a multi-gigabyte bus."""
from __future__ import annotations

import torch

__all__ = ["bus_consensus", "bus_grad_norm"]


def _sq_sum(rows) -> torch.Tensor:
    return sum(r.float().square().sum() for r in rows)


def bus_consensus(bus: torch.Tensor) -> torch.Tensor:
    """‖X − X̄‖²_F over the agent axis, in f32."""
    mean = bus.float().mean(dim=0)
    return _sq_sum(b.float() - mean for b in bus)


def bus_grad_norm(g_bus: torch.Tensor) -> torch.Tensor:
    """Global gradient norm over a packed gradient bus, in f32."""
    return _sq_sum(g_bus).sqrt()
