"""CUDA kernel of paged prefill attention (chunked prefill).

:func:`paged_prefill_flat` wraps ``csrc/paged_prefill.cu``, the
counterpart of the Pallas kernel
``repro/kernels/paged_prefill.py::_prefill_kernel``: one C-token chunk of
one slot, ``(K, C·G, hd)`` queries, over the slot's earlier pages (linear
or ring key positions, per-element window mask) and causally over the
chunk's own ``(K, C, hd)`` keys.

It takes CUDA tensors only, checks them as
:func:`~repro_torch.kernels.paged_attention.paged_attention_flat` does,
launches on PyTorch's current stream and raises on a non-zero CUDA
status.  ``paged_prefill_flat.launches`` counts its launches, incremented
where the kernel is launched and nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.paged_prefill_attention_ref`; the device
dispatch and the model-layout transform are
:func:`repro_torch.kernels.ops.paged_prefill_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._ffi import DTYPE_CODE, check, check_head, launcher, raise_on, stream

__all__ = ["paged_prefill_flat"]


def paged_prefill_flat(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                       chunk_start: int, chunk_len: int, *, page_size: int,
                       window: int = 0,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged prefill attention of one chunk of one slot on the card.
    q: (K, C·G, hd), row ``i·G + g`` = chunk token i, group member g;
    k_chunk, v_chunk: (K, C, hd), the chunk's keys and values (not yet in
    the pools); pools: (num_pages, page_size, K, hd); pt_row: (n_pages,)
    int32.  ``chunk_start``, ``chunk_len`` and ``window`` are kernel
    arguments.  Returns (K, C·G, hd) in q's dtype."""
    K, CG, hd = q.shape
    check_head(q, hd)
    C = k_chunk.shape[1]
    if C == 0 or CG % C:
        raise ValueError(f"q rows {CG} are not a multiple of the chunk "
                         f"width {C}")
    G = CG // C
    num_pages = k_pool.shape[0]
    check(q, "q", q, dtypes=(q.dtype,))
    for name, t in (("k_chunk", k_chunk), ("v_chunk", v_chunk)):
        check(t, name, q, dtypes=(q.dtype,), shape=(K, C, hd))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        check(t, name, q, dtypes=(q.dtype,),
              shape=(num_pages, page_size, K, hd))
    n_pages = pt_row.shape[0] if pt_row.dim() == 1 else -1
    check(pt_row, "pt_row", q, dtypes=(torch.int32,), shape=(n_pages,))
    start, clen = int(chunk_start), int(chunk_len)
    if start < 0 or not 0 <= clen <= C or window < 0:
        raise ValueError(f"chunk_start {start}, chunk_len {clen} (C = {C}) "
                         f"or window {window} out of range")
    if out is None:
        out = torch.empty_like(q)
    check(out, "out", q, dtypes=(q.dtype,))
    fn = launcher("paged_prefill", [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), pt_row.data_ptr(),
                 out.data_ptr(), DTYPE_CODE[q.dtype], K, C, G, hd,
                 page_size, n_pages, start, clen, int(window), hd ** -0.5,
                 stream(q))
    raise_on(err, "paged_prefill")
    paged_prefill_flat.launches += 1
    return out


paged_prefill_flat.launches = 0
