"""Plain PyTorch versions of the port's CUDA kernels.

Each repeats its kernel's arithmetic operation for operation, so on the card
the two agree bit for bit; the CPU tests hold these against the JAX
package's Pallas kernels (run in interpret mode), and the wrappers in
:mod:`repro_torch.kernels.ops` use them for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["edm_update_ref", "gossip_axpy_ref"]


def edm_update_ref(x, g, m, psi, *, alpha: float, beta: float,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EDM chain ``m' = βm + (1−β)g``, ``ψ' = x − αm'``, ``φ = ψ' + x − ψ``.

    Every product and sum rounds to f32 on its own; ``(1 − β)`` is a Python
    double rounded once to f32, as in the JAX kernel.  ``out`` =
    ``(m_out, psi_out, phi_out)`` receives the results where an entry is
    not None (``m_out`` may be ``m`` and ``psi_out`` may be ``psi``: all
    three are computed first)."""
    m_new = beta * m + (1.0 - beta) * g
    psi_new = x - alpha * m_new
    phi = psi_new + x - psi
    vals = (m_new, psi_new, phi)
    if out is None:
        return vals
    return tuple(val if dst is None else dst.copy_(val)
                 for dst, val in zip(out, vals))


def gossip_axpy_ref(operands: Sequence[torch.Tensor],
                    weights: Sequence[float],
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """n-ary combine ``Σₖ wₖ·operandₖ``: f32 accumulation in term order,
    starting from ``w₀·o₀``, one rounding to ``out_dtype`` (default: the
    operands' dtype) at the end."""
    acc = float(weights[0]) * operands[0].float()
    for w, o in zip(weights[1:], operands[1:]):
        acc = acc + float(w) * o.float()
    return acc.to(out_dtype or operands[0].dtype)
