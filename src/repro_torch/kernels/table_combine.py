"""The gossip combine driven by a source table: masked rounds and late slots.

``out[a] = Σₖ w[k, a] · x[src[k, a]]`` over the A agents of one card, where
``x`` is agent-stacked (the ``(A, rows, 128)`` bus or an ``(A, *shape)``
parameter leaf) and ``src`` / ``w`` are ``(K, A)`` tables.  It carries what
the JAX package's ``_axpy_kernel`` combines with one weight per agent: a
liveness-masked round (:class:`~repro_torch.core.elastic.MaskedTopology`:
per-agent sources and weights) and the overlap pipeline's ``complete``
(late slots read the agent's own row under the slot's weight, pad slots
carry weight 0).  A neighbour's payload is a row block of the same buffer,
so no permuted copy and no ``(K, A, ...)`` stack is made: the kernel
(``csrc/table_combine.cu``) reads each term's row block in place.

* :func:`table_operands` — the checks every device makes;
* :func:`table_combine_flat` — the launch: ``x`` and ``out`` f32 or bf16
  (the dtypes of ``csrc/gossip_axpy.cu``), ``src`` int32 and ``w`` f32
  **device tensors**, read by the kernel at every launch, so a captured
  CUDA graph replays with the tables written into them before the replay.

The plain version is :func:`repro_torch.kernels.ref.table_combine_ref`;
the device dispatch :func:`repro_torch.kernels.ops.table_combine`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._ffi import (DTYPE_CODE, FLOAT_DTYPES, agent_stride, check,
                   count_launch, launcher, overlaps, raise_on, stream)

__all__ = ["MAX_TERMS", "MAX_AGENTS", "table_operands",
           "table_combine_flat"]

MAX_TERMS = 16
MAX_AGENTS = 1024


def table_operands(x: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.dtype:
    """Check a table combine's operands on any device and return the output
    dtype: ``x`` an ``(A, ...)`` f32 or bf16 tensor, ``src`` an integer
    ``(K, A)`` table of agent indices and ``w`` an f32 ``(K, A)`` table,
    both on ``x``'s device, 1 ≤ K ≤ 16; ``out`` (if given) of ``x``'s shape
    and the output dtype, the span of its agent blocks apart from x's
    (every output row block reads other agents' blocks)."""
    if x.dim() < 1 or x.dtype not in FLOAT_DTYPES:
        raise ValueError(f"the table combine takes (A, ...) tensors of "
                         f"{FLOAT_DTYPES}, got {x.dtype} {tuple(x.shape)}")
    A = x.shape[0]
    if src.dim() != 2 or src.shape[1] != A or not 1 <= src.shape[0] \
            <= MAX_TERMS or A > MAX_AGENTS:
        raise ValueError(f"src must be (K, {A}) with 1 ≤ K ≤ {MAX_TERMS} "
                         f"and A ≤ {MAX_AGENTS}, got {tuple(src.shape)}")
    if src.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"src must hold integers, got {src.dtype}")
    if w.shape != src.shape or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 {tuple(src.shape)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    for name, t in (("src", src), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    out_dtype = out_dtype or (out.dtype if out is not None else x.dtype)
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"output dtype {out_dtype} not in {FLOAT_DTYPES}")
    if out is not None:
        if (out.shape != x.shape or out.dtype != out_dtype
                or out.device != x.device):
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}, expected {out_dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if overlaps(x, out):
            raise ValueError("out overlaps x: the table combine reads other "
                             "agents' row blocks, so it cannot run in place")
    return out_dtype


def table_combine_flat(x: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
                       *, out_dtype: Optional[torch.dtype] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[a] = Σₖ w[k, a] · x[src[k, a]]`` on the card, one launch.

    ``x``: an ``(A, ...)`` f32 or bf16 CUDA tensor, any element count per
    agent, contiguous or a policy group's rows ``bus[:, r0:r1]`` of a
    larger bus (read in place; ``out`` may be strided so too); ``src``: an
    int32 ``(K, A)`` CUDA tensor of agent indices in ``[0, A)``; ``w``: an
    f32 ``(K, A)`` CUDA tensor.  Terms are taken in slot order k = 0 … K−1
    with f32 accumulation and one rounding to ``out_dtype`` (default:
    x's); weight-0 slots are computed.  ``out``
    (default: a new tensor) may alias no byte of ``x``.  Bit-equal to
    :func:`repro_torch.kernels.ref.table_combine_ref`."""
    out_dtype = table_operands(x, src, w, out_dtype, out)
    check(x, "x", x, dtypes=FLOAT_DTYPES, agent_strided=True)
    check(src, "src", x, dtypes=(torch.int32,), shape=src.shape)
    check(w, "w", x, shape=w.shape)
    if out is None:
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    check(out, "out", x, dtypes=(out_dtype,), agent_strided=True)
    K, A = src.shape
    n = x[0].numel() if A else 0
    fn = launcher("table_combine", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), src.data_ptr(), w.data_ptr(),
                 K, A, n, agent_stride(x) if A else 0,
                 agent_stride(out) if A else 0, DTYPE_CODE[x.dtype],
                 DTYPE_CODE[out_dtype], stream(x))
    raise_on(err, "table_combine")
    count_launch(table_combine_flat)
    return out


table_combine_flat.launches = 0
