"""Bus-resident EDM: the counterpart of ``repro/core/optimizers.py::
make_edm_bus``.

Exact-Diffusion with Momentum (the paper's Algorithm 1), per agent::

    m   ← β m + (1−β) g
    ψ'  ← x − α m
    φ   ← ψ' + x − ψ
    x   ← Σ_j w_ij φ_j            (gossip)

over ``(A, rows, 128)`` bus buffers.  ``use_fused_kernel=True`` runs the
elementwise chain as ONE CUDA kernel launch over the whole bus
(:func:`repro_torch.kernels.ops.edm_update_bus`); otherwise it is the
plain PyTorch chain.  The other algorithms of the JAX package are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import edm_update_ref

__all__ = ["DecOptimizer", "make_edm_bus"]

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DecOptimizer:
    name: str
    init: Callable[[torch.Tensor], State]
    step: Callable[[torch.Tensor, torch.Tensor, State], tuple]


def make_edm_bus(alpha: float, beta: float, mix: Callable, *,
                 use_fused_kernel: bool = False) -> DecOptimizer:
    """Bus-resident EDM.  ``init(x_bus)`` → ``{"m": 0, "psi": x}``;
    ``step(x_bus, g_bus, state)`` → ``(mix(φ), {"m": m', "psi": ψ'})``.

    The step writes m' and ψ' over the state's own ``m`` and ``psi``
    buffers (each element is read before it is written, so this is exact);
    it consumes its state as the JAX step donates it, which keeps one bus
    copy of each off the peak memory at full width.  Zero-preservation
    keeps the layout's pad region zero."""

    def init(x_bus: torch.Tensor) -> State:
        # ψ(0) = x(0) as a DISTINCT buffer: ψ is updated in place.
        return {"m": torch.zeros_like(x_bus), "psi": x_bus.clone()}

    def step(x_bus, g_bus, state: State):
        m, psi = state["m"], state["psi"]
        out = (m, psi, None)
        if use_fused_kernel:
            m_new, psi_new, phi = kops.edm_update_bus(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta, out=out)
        else:
            m_new, psi_new, phi = edm_update_ref(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta, out=out)
        return mix(phi), {"m": m_new, "psi": psi_new}

    return DecOptimizer("edm_bus", init, step)
