"""CUDA kernel of paged decode attention.

:func:`paged_attention_flat` wraps ``csrc/paged_attention.cu``, the
counterpart of the Pallas kernel
``repro/kernels/paged_attention.py::_paged_kernel``: one query token per
slot, grouped ``(B, K, G, hd)``, over ``(num_pages, page_size, K, hd)``
pools through a ``(B, n_pages)`` page table, masked by ``kv_len``.

The kernel splits each (slot, KV head)'s key range across the blocks of
one thread-block cluster by :func:`split_plan`, gathers each block's K/V
rows with ``cp.async``, runs bf16 on the tensor cores (``mma.sync``) and
f32 on the CUDA cores, and merges the splits through distributed shared
memory inside the same launch.  The plan is a function of shapes only:
the wrapper never reads ``kv_len`` back, so a launch waits for nothing on
the host.

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
from typing import Optional, Tuple

import torch

from ._ffi import (DTYPE_CODE, MAX_HEAD_DIM, check, check_head, count_launch,
                   launcher, raise_on, sm_count, stream)

__all__ = ["MAX_HEAD_DIM", "MAX_SPLITS", "MIN_SPLIT_KEYS",
           "paged_attention_flat", "split_plan"]

MAX_SPLITS = 8         # the portable thread-block cluster size
MIN_SPLIT_KEYS = 64    # a shorter split costs more in its merge than it saves
BLOCKS_PER_SM = 4      # blocks the plan aims for: keys in flight on every SM


def split_plan(slots: int, kv_heads: int, rows: int, page_size: int, *,
               sms: int) -> Tuple[int, int]:
    """``(n_split, split_keys)``: how the kernel cuts each (slot, KV
    head)'s ``rows = n_pages · page_size`` key positions into ``n_split``
    page-aligned ranges of ``split_keys`` keys, one block of a cluster
    each; split s covers ``[s·split_keys, (s+1)·split_keys)``.

    ``n_split`` is the smallest power of two (at most :data:`MAX_SPLITS`)
    that gives the grid of ``slots · kv_heads · n_split`` blocks
    :data:`BLOCKS_PER_SM` blocks an SM, halved while a split would hold
    fewer than :data:`MIN_SPLIT_KEYS` keys.  Only shapes enter: the same
    plan serves every ``kv_len``, so a launch reads nothing back from the
    card."""
    if rows <= 0 or page_size <= 0:
        return 1, max(page_size, 1)
    n_split = 1
    while (n_split < MAX_SPLITS
           and slots * kv_heads * n_split < BLOCKS_PER_SM * sms):
        n_split *= 2
    while n_split > 1 and -(-rows // n_split) < MIN_SPLIT_KEYS:
        n_split //= 2
    pages = -(-rows // page_size)
    split_keys = -(-pages // n_split) * page_size
    return n_split, split_keys


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
    n_split, split_keys = split_plan(B, K, n_pages * page_size, page_size,
                                     sms=sm_count(q.device))
    fn = launcher("paged_attention", [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 DTYPE_CODE[q.dtype], B, K, G, hd, page_size, n_pages,
                 hd ** -0.5, split_keys, n_split, stream(q))
    raise_on(err, "paged_attention")
    count_launch(paged_attention_flat)
    return out


paged_attention_flat.launches = 0
