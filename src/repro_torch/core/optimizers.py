"""Bus-resident EDM: the counterpart of ``repro/core/optimizers.py::
make_edm_bus`` and ``::make_edm_bus_ef``.

Exact-Diffusion with Momentum (the paper's Algorithm 1), per agent::

    m   ← β m + (1−β) g
    ψ'  ← x − α m
    φ   ← ψ' + x − ψ
    x   ← Σ_j w_ij φ_j            (gossip)

over ``(A, rows, 128)`` bus buffers.  ``use_fused_kernel=True`` runs the
elementwise chain as ONE CUDA kernel launch over the whole bus
(:func:`repro_torch.kernels.ops.edm_update_bus`); otherwise it is the
plain PyTorch chain.  :func:`make_edm_bus_ef` is the same step with the
error-feedback-compressed gossip wire (bf16 / int8): it sends ``Q(φ + e)``
and carries the residual ``e``.  The other algorithms of the JAX package
are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import edm_update_ref

from .wire import WireCodec, encode_ef

__all__ = ["DecOptimizer", "make_edm_bus", "make_edm_bus_ef"]

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


def make_edm_bus_ef(alpha: float, beta: float, mix: Callable,
                    codec: WireCodec, *, use_fused_kernel: bool = False,
                    error_feedback: bool = True) -> DecOptimizer:
    """Bus-resident EDM with an error-feedback-compressed wire.  Per step::

        m'  = β m + (1-β) g
        ψ'  = x − α m'
        c   = (ψ' + x − ψ) + e          (φ plus the carried residual)
        pay = encode(c)                 (the wire payload, codec format)
        e'  = c − decode(pay)           (sender-local, carried across rounds)
        x'  = mix(pay)                  (wire-coded engine → f32 mix)

    ``mix`` takes the codec's payload and returns the f32 mixed bus
    (``make_mixer(..., wire=codec)``).  State is ``{m, psi, e}``; m', ψ'
    and e' are written over the state's own buffers, as
    :func:`make_edm_bus` does.  ``use_fused_kernel=True`` runs the chain,
    the quantization and the residual as ONE CUDA kernel launch
    (:func:`repro_torch.kernels.ops.edm_update_bus_ef`); otherwise the
    plain chain and :func:`repro_torch.core.wire.encode_ef`.

    ``error_feedback=False`` drops the residual (``pay = encode(φ)``,
    ``e`` stays 0): the naive-quantization negative control, not a
    production mode."""

    def init(x_bus: torch.Tensor) -> State:
        return {"m": torch.zeros_like(x_bus), "psi": x_bus.clone(),
                "e": torch.zeros_like(x_bus)}

    def step(x_bus, g_bus, state: State):
        m, psi, e = state["m"], state["psi"], state["e"]
        if use_fused_kernel and error_feedback and codec.fmt != "f32":
            m_new, psi_new, payload, e_new = kops.edm_update_bus_ef(
                x_bus, g_bus, m, psi, e, alpha=alpha, beta=beta,
                fmt=codec.fmt, block_rows=codec.block_rows,
                out=(m, psi, e))
        else:
            m_new, psi_new, phi = edm_update_ref(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta,
                out=(m, psi, None))
            if error_feedback:
                payload, e_new = encode_ef(codec, phi.add_(e))
                e_new = e.copy_(e_new)
            else:
                payload, e_new = codec.encode(phi), e
        return mix(payload), {"m": m_new, "psi": psi_new, "e": e_new}

    return DecOptimizer("edm_bus_ef", init, step)
