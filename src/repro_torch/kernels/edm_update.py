"""CUDA kernels of the EDM step: the fused updates and the n-ary combines.

Four wrappers around the hand-written ``sm_90a`` kernels in ``csrc/``,
each the counterpart of the Pallas kernel of the same name in
``repro/kernels/edm_update.py``:

* :func:`edm_update_flat` — ``csrc/edm_update.cu``: the whole EDM chain in
  one pass, 4 reads and 3 writes per element;
* :func:`edm_update_ef_flat` — ``csrc/edm_update_ef.cu``: the EDM chain
  plus the error-feedback quantization of ``c = φ + e`` to the bf16 or
  int8 gossip wire (one scale per ``(block_rows, 128)`` tile);
* :func:`gossip_axpy_flat` — ``csrc/gossip_axpy.cu``: ``Σₖ wₖ·operandₖ``
  with f32 accumulation and runtime weights;
* :func:`gossip_axpy_q8_flat` — ``csrc/gossip_axpy_q8.cu``: the int8
  wire's dequantize-and-combine ``Σₖ coef[k, tile]·qₖ``.

All take CUDA tensors only, check device, dtype, shape, contiguity and
alignment before passing raw pointers (the combines also take the agent
blocks of a policy group's rows ``bus[:, r0:r1]`` of a larger bus in place:
:func:`repro_torch.kernels._ffi.check`), launch on PyTorch's current stream
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

from ._ffi import (DTYPE_CODE, FLOAT_DTYPES, agent_blocks, check,
                   count_launch, launcher, raise_on, stream)

__all__ = ["BLOCK_ROWS", "LANE", "MAX_OPERANDS", "edm_update_flat",
           "edm_update_ef_flat", "gossip_axpy_flat", "gossip_axpy_q8_flat"]


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
    may be ``m``, ``psi_out`` ``psi`` and ``phi_out`` ``x`` (in place: a
    thread reads an element's inputs before it writes them).  Bit-equal to
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
    count_launch(edm_update_flat)
    return tuple(out)


edm_update_flat.launches = 0


def gossip_axpy_flat(operands: Sequence[torch.Tensor],
                     weights: Sequence[float], *,
                     out_dtype: Optional[torch.dtype] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused n-ary combine ``Σₖ wₖ·operandₖ`` on the card.

    ``operands``: 1 to 16 CUDA tensors of one shape and dtype (f32 or
    bf16), of any element count (a parameter leaf as well as the bus);
    contiguous, or ``(A, ...)`` with each agent block dense and the blocks
    a 16-byte multiple apart, as a policy group's rows ``bus[:, r0:r1]``
    are (the output too).  ``weights``: one float each — runtime kernel
    arguments, so every weight set reuses one compiled kernel.
    Accumulates in f32 and rounds once to ``out_dtype`` (default: the
    operands' dtype).  Bit-equal to
    :func:`repro_torch.kernels.ref.gossip_axpy_ref`."""
    operands = tuple(operands)
    n = len(operands)
    if not 1 <= n <= MAX_OPERANDS or len(weights) != n:
        raise ValueError(f"gossip_axpy_flat takes 1..{MAX_OPERANDS} operands "
                         f"with one weight each, got {n} and {len(weights)}")
    first = operands[0]
    for k, o in enumerate(operands):
        check(o, f"operand {k}", first, dtypes=(first.dtype,),
              agent_strided=True)
    out_dtype = out_dtype or first.dtype
    for what, dt in (("operand", first.dtype), ("output", out_dtype)):
        if dt not in FLOAT_DTYPES:
            raise ValueError(f"{what} dtype {dt} not in {FLOAT_DTYPES}")
    if out is None:
        out = torch.empty(first.shape, dtype=out_dtype, device=first.device)
    check(out, "out", first, dtypes=(out_dtype,), agent_strided=True)
    n_agents, size, strides = agent_blocks(operands + (out,))
    out_stride = strides.pop()
    ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in operands))
    ws = (ctypes.c_float * n)(*(float(w) for w in weights))
    fn = launcher("gossip_axpy", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(first.device):
        err = fn(ptrs, (ctypes.c_longlong * n)(*strides), ws, n,
                 DTYPE_CODE[first.dtype], DTYPE_CODE[out_dtype],
                 out.data_ptr(), out_stride, n_agents, size, stream(first))
    raise_on(err, "gossip_axpy")
    count_launch(gossip_axpy_flat)
    return out


gossip_axpy_flat.launches = 0


def _check_tiles(t: torch.Tensor, block_rows: int, what: str) -> int:
    """Number of whole ``(block_rows, 128)`` tiles in ``(rows, 128)``
    ``t``; raises if the rows do not split into whole tiles."""
    if t.dim() != 2 or t.shape[1] != LANE:
        raise ValueError(f"{what} takes (rows, {LANE}), got "
                         f"{tuple(t.shape)}")
    if block_rows <= 0 or block_rows % 8 or t.shape[0] % block_rows:
        raise ValueError(f"{what}: rows {t.shape[0]} must be a multiple of "
                         f"block_rows={block_rows} (a positive multiple "
                         "of 8)")
    return t.shape[0] // block_rows


def edm_update_ef_flat(x, g, m, psi, e, *, alpha: float, beta: float,
                       fmt: str, block_rows: int = BLOCK_ROWS,
                       out: Optional[Sequence[torch.Tensor]] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Fused EDM update with error-feedback quantization on the card.

    Inputs: ``(rows, 128)`` f32 CUDA tensors, contiguous, rows a multiple
    of ``block_rows``.  Returns ``(m', ψ', q, e')`` for ``fmt="bf16"``
    (``q`` bf16) and ``(m', ψ', q, scale, e')`` for ``fmt="int8"`` (``q``
    int8, ``scale`` f32 ``(rows // block_rows,)``, one per tile), written
    into the entries of ``out`` (same order) that are not None; ``m_out``
    may be ``m``, ``psi_out`` ``psi`` and ``e_out`` ``e`` (in place).
    Bit-equal to :func:`repro_torch.kernels.ref.edm_update_ef_ref`."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"edm_update_ef_flat takes fmt bf16 or int8, got "
                         f"{fmt!r} (f32 has no quantize: edm_update_flat)")
    n_tiles = _check_tiles(x, block_rows, "edm_update_ef_flat")
    for name, t in (("g", g), ("m", m), ("psi", psi), ("e", e), ("x", x)):
        check(t, name, x)
    qdt = torch.bfloat16 if fmt == "bf16" else torch.int8
    shapes = [(x.shape, torch.float32), (x.shape, torch.float32),
              (x.shape, qdt)]
    if fmt == "int8":
        shapes.append(((n_tiles,), torch.float32))
    shapes.append((x.shape, torch.float32))
    names = ("m_out", "psi_out", "q_out") + (
        ("scale_out",) if fmt == "int8" else ()) + ("e_out",)
    out = tuple(out) if out is not None else (None,) * len(shapes)
    if len(out) != len(shapes):
        raise ValueError(f"out has {len(out)} entries, {fmt} has "
                         f"{len(shapes)} outputs")
    out = tuple(torch.empty(shape, dtype=dt, device=x.device) if o is None
                else o for o, (shape, dt) in zip(out, shapes))
    for name, t, (shape, dt) in zip(names, out, shapes):
        check(t, name, x, dtypes=(dt,), shape=shape)
    m_out, psi_out, q_out, e_out = out[0], out[1], out[2], out[-1]
    scale_ptr = out[3].data_ptr() if fmt == "int8" else None
    fn = launcher("edm_update_ef", [ctypes.c_void_p] * 10
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                  + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), g.data_ptr(), m.data_ptr(), psi.data_ptr(),
            e.data_ptr(), m_out.data_ptr(), psi_out.data_ptr(),
            q_out.data_ptr(), scale_ptr, e_out.data_ptr(), x.numel(),
            DTYPE_CODE[qdt], block_rows, alpha, beta, 1.0 - beta, stream(x))
    raise_on(err, "edm_update_ef")
    count_launch(edm_update_ef_flat)
    return out


edm_update_ef_flat.launches = 0


def gossip_axpy_q8_flat(operands: Sequence[torch.Tensor],
                        coefs: torch.Tensor, *,
                        block_rows: int = BLOCK_ROWS,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused int8 dequantize-and-combine ``Σₖ coef[k, tile]·qₖ`` on the
    card.

    ``operands``: 1 to 16 int8 CUDA tensors of one shape, contiguous,
    ``(rows, 128)`` or ``(A, rows, 128)``, rows a multiple of
    ``block_rows``; ``coefs``: an f32 CUDA tensor ``(n, n_tiles)`` of
    per-operand, per-tile ``weight × scale`` over the flattened rows
    (agent-major) — device data, so every weight and scale set reuses one
    build.  Returns the f32 combine, written into ``out`` when given: of
    the operands' shape, contiguous or (3-D) with each agent block dense,
    as a policy group's rows ``x[:, r0:r1]`` of a larger bus are.
    Bit-equal to :func:`repro_torch.kernels.ref.gossip_axpy_q8_ref`."""
    operands = tuple(operands)
    n = len(operands)
    if not 1 <= n <= MAX_OPERANDS:
        raise ValueError(f"gossip_axpy_q8_flat takes 1..{MAX_OPERANDS} "
                         f"operands, got {n}")
    first = operands[0]
    if first.dim() not in (2, 3):
        raise ValueError(f"gossip_axpy_q8_flat takes (rows, {LANE}) or (A, "
                         f"rows, {LANE}) operands, got {tuple(first.shape)}")
    n_tiles = _check_tiles(first.reshape(-1, first.shape[-1]), block_rows,
                           "gossip_axpy_q8_flat")
    for k, o in enumerate(operands):
        check(o, f"operand {k}", first, dtypes=(torch.int8,))
    check(coefs, "coefs", first, shape=(n, n_tiles))
    if out is None:
        out = torch.empty(first.shape, dtype=torch.float32,
                          device=first.device)
    check(out, "out", first, shape=first.shape,
          agent_strided=first.dim() == 3)
    n_agents, size, (out_stride,) = agent_blocks((out,))
    if n_agents > 1:
        _check_tiles(first[0], block_rows, "gossip_axpy_q8_flat into an "
                     "agent-strided out")
    ptrs = (ctypes.c_void_p * n)(*(o.data_ptr() for o in operands))
    fn = launcher("gossip_axpy_q8", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(first.device):
        err = fn(ptrs, n, coefs.data_ptr(), block_rows, out.data_ptr(),
                 out_stride, n_agents, size, stream(first))
    raise_on(err, "gossip_axpy_q8")
    count_launch(gossip_axpy_q8_flat)
    return out


gossip_axpy_q8_flat.launches = 0
