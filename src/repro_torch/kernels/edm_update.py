"""CUDA kernels of the EDM step: the fused update and the n-ary combine.

Two wrappers around the hand-written ``sm_90a`` kernels in ``csrc/``:

* :func:`edm_update_flat` — ``csrc/edm_update.cu``, the counterpart of the
  Pallas kernel ``repro/kernels/edm_update.py::edm_update_flat``: the whole
  EDM chain in one pass, 4 reads and 3 writes per element;
* :func:`gossip_axpy_flat` — ``csrc/gossip_axpy.cu``, the counterpart of
  ``repro/kernels/edm_update.py::gossip_axpy_flat``: ``Σₖ wₖ·operandₖ`` with
  f32 accumulation and runtime weights.

Both take CUDA tensors only, check device, dtype, shape, contiguity and
alignment before passing raw pointers, launch on PyTorch's current stream
and raise on a non-zero CUDA status.  Each counts its launches in a plain
integer attribute (``edm_update_flat.launches``), incremented where the
kernel is launched and nowhere else.  The plain versions are in
:mod:`repro_torch.kernels.ref`; the device dispatch is in
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import torch

from ._ffi import DTYPE_CODE, check, launcher, raise_on, stream

__all__ = ["BLOCK_ROWS", "LANE", "MAX_OPERANDS", "edm_update_flat",
           "gossip_axpy_flat"]


def _env_block_rows() -> int:
    """Bus tile height, read once at import from ``REPRO_BLOCK_ROWS`` as in
    the JAX package.  It is a data-format constant of the bus layout (rows
    round up to it), not a CUDA tile size."""
    raw = os.environ.get("REPRO_BLOCK_ROWS", "")
    if not raw:
        return 512
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"REPRO_BLOCK_ROWS must be an integer, got {raw!r}")
    if n <= 0 or n % 8:
        raise ValueError(
            f"REPRO_BLOCK_ROWS must be a positive multiple of 8, got {n}")
    return n


BLOCK_ROWS = _env_block_rows()
LANE = 128
MAX_OPERANDS = 16
def edm_update_flat(x, g, m, psi, *, alpha: float, beta: float,
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EDM update on the card.  Inputs: ``(rows, 128)`` f32 CUDA
    tensors, contiguous.  Returns ``(m', ψ', φ)``, written into ``out`` =
    ``(m_out, psi_out, phi_out)`` where an entry is not None; ``m_out``
    may be ``m`` and ``psi_out`` may be ``psi`` (in place).  Bit-equal to
    :func:`repro_torch.kernels.ref.edm_update_ref` (no FMA contraction)."""
    if x.dim() != 2 or x.shape[1] != LANE:
        raise ValueError(f"edm_update_flat takes (rows, {LANE}), got "
                         f"{tuple(x.shape)}")
    for name, t in (("g", g), ("m", m), ("psi", psi), ("x", x)):
        check(t, name, x)
    out = tuple(torch.empty_like(x) if o is None else o
                for o in (out or (None,) * 3))
    for name, t in zip(("m_out", "psi_out", "phi_out"), out):
        check(t, name, x)
    fn = launcher("edm_update", [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                  + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), g.data_ptr(), m.data_ptr(), psi.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            x.numel(), alpha, beta, 1.0 - beta, stream(x))
    raise_on(err, "edm_update")
    edm_update_flat.launches += 1
    return tuple(out)


edm_update_flat.launches = 0


def gossip_axpy_flat(operands: Sequence[torch.Tensor],
                     weights: Sequence[float], *,
                     out_dtype: Optional[torch.dtype] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused n-ary combine ``Σₖ wₖ·operandₖ`` on the card.

    ``operands``: 1 to 16 CUDA tensors of one shape and dtype (f32 or
    bf16), contiguous, with a multiple of 4 elements; ``weights``: one
    float each — runtime kernel arguments, so every weight set reuses one
    compiled kernel.  Accumulates in f32 and rounds once to ``out_dtype``
    (default: the operands' dtype).  Bit-equal to
    :func:`repro_torch.kernels.ref.gossip_axpy_ref`."""
    operands = tuple(operands)
    n = len(operands)
    if not 1 <= n <= MAX_OPERANDS or len(weights) != n:
        raise ValueError(f"gossip_axpy_flat takes 1..{MAX_OPERANDS} operands "
                         f"with one weight each, got {n} and {len(weights)}")
    first = operands[0]
    dtypes = tuple(DTYPE_CODE)
    for k, o in enumerate(operands):
        check(o, f"operand {k}", first, dtypes=(first.dtype,))
    if first.dtype not in dtypes:
        raise ValueError(f"operand dtype {first.dtype} not in {dtypes}")
    if first.numel() % 4:
        raise ValueError("operands need a multiple of 4 elements")
    out_dtype = out_dtype or first.dtype
    if out is None:
        out = torch.empty(first.shape, dtype=out_dtype, device=first.device)
    check(out, "out", first, dtypes=(out_dtype,))
    ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in operands))
    ws = (ctypes.c_float * n)(*(float(w) for w in weights))
    fn = launcher("gossip_axpy", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(first.device):
        err = fn(ptrs, ws, n, DTYPE_CODE[first.dtype], DTYPE_CODE[out_dtype],
                 out.data_ptr(), first.numel(), stream(first))
    raise_on(err, "gossip_axpy")
    gossip_axpy_flat.launches += 1
    return out


gossip_axpy_flat.launches = 0
