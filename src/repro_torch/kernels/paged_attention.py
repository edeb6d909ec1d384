"""CUDA kernel of paged decode attention.

:func:`paged_attention_flat` wraps ``csrc/paged_attention.cu``, the
counterpart of the Pallas kernel
``repro/kernels/paged_attention.py::_paged_kernel``: one query token per
slot, grouped ``(B, K, G, hd)``, over ``(num_pages, page_size, K, hd)``
pools through a ``(B, n_pages)`` page table, masked by ``kv_len``.

It takes CUDA tensors only (f32 or bf16, ``hd`` a multiple of 8 up to
256), checks device, dtype, shape, contiguity and alignment before passing
raw pointers, launches on PyTorch's current stream and raises on a
non-zero CUDA status.  It counts its launches in a plain integer attribute
(``paged_attention_flat.launches``), incremented where the kernel is
launched and nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.paged_attention_ref`; the device dispatch
is :func:`repro_torch.kernels.ops.paged_attention`.  The operand checks
and the ctypes call are :mod:`repro_torch.kernels._ffi`'s.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._ffi import (DTYPE_CODE, MAX_HEAD_DIM, check, check_head, launcher,
                   raise_on, stream)

__all__ = ["MAX_HEAD_DIM", "paged_attention_flat"]


def paged_attention_flat(q, k_pool, v_pool, page_table, kv_len, *,
                         page_size: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged decode attention on the card.  q: (B, K, G, hd); pools:
    (num_pages, page_size, K, hd) of q's dtype; page_table: (B, n_pages)
    int32; kv_len: (B,) int32.  Returns (B, K, G, hd) in q's dtype; a slot
    with ``kv_len == 0`` gets a zero tile."""
    B, K, G, hd = q.shape
    check_head(q, hd)
    num_pages = k_pool.shape[0]
    n_pages = page_table.shape[1] if page_table.dim() == 2 else -1
    check(q, "q", q, dtypes=(q.dtype,))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        check(t, name, q, dtypes=(q.dtype,),
              shape=(num_pages, page_size, K, hd))
    check(page_table, "page_table", q, dtypes=(torch.int32,),
          shape=(B, n_pages))
    check(kv_len, "kv_len", q, dtypes=(torch.int32,), shape=(B,))
    if out is None:
        out = torch.empty_like(q)
    check(out, "out", q, dtypes=(q.dtype,))
    fn = launcher("paged_attention", [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 DTYPE_CODE[q.dtype], B, K, G, hd, page_size, n_pages,
                 hd ** -0.5, stream(q))
    raise_on(err, "paged_attention")
    paged_attention_flat.launches += 1
    return out


paged_attention_flat.launches = 0
