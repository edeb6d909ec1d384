"""CUDA kernel of paged prefill attention (chunked prefill).

:func:`paged_prefill_flat` wraps ``csrc/paged_prefill.cu``, the
counterpart of the Pallas kernel
``repro/kernels/paged_prefill.py::_prefill_kernel``: one C-token chunk of
one slot, ``(K, C·G, hd)`` queries, over the slot's earlier pages (linear
or ring key positions, per-element window mask) and causally over the
chunk's own ``(K, C, hd)`` keys.

In bf16 the kernel splits the slot's keys across blocks by
:func:`split_plan` and merges the splits' partials inside the same launch;
the wrapper allocates their scratch, and keeps one zeroed ticket buffer
per (device, stream) that the kernel leaves zeroed: launches on one stream
run in order, and launches on two streams never share a ticket, so they
may overlap in time.  It takes CUDA tensors only, checks
them as :func:`~repro_torch.kernels.paged_attention.paged_attention_flat`
does, launches on PyTorch's current stream and raises on a non-zero CUDA
status.  ``paged_prefill_flat.launches`` counts its launches, incremented
where the kernel is launched and nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.paged_prefill_attention_ref`; the device
dispatch and the model-layout transform are
:func:`repro_torch.kernels.ops.paged_prefill_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ._ffi import (DTYPE_CODE, check, check_head, count_launch, launcher,
                   raise_on, sm_count, stream)

__all__ = ["KEY_TILE", "MAX_SPLITS", "Q_TILE", "paged_prefill_flat",
           "split_plan"]

Q_TILE = 64       # query rows per block of the bf16 kernel
KEY_TILE = 64     # keys per tile; a split holds a whole number of tiles
MAX_SPLITS = 64   # the merge's weights fit the block's shared memory

_tickets: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def split_plan(prev: int, n_chunk: int, q_rows: int, n_kv_heads: int, *,
               sms: int) -> Tuple[int, int]:
    """``(n_split, split_keys)``: how the bf16 kernel cuts a slot's keys —
    its ``prev`` earlier pool rows, then the chunk's ``n_chunk`` keys, one
    index range — into ``n_split`` ranges of ``split_keys`` keys (a
    multiple of :data:`KEY_TILE`; the last range ends at the last key).
    Split s covers ``[s·split_keys, min((s+1)·split_keys, prev + n_chunk))``.
    The splits are as long as they can be while the grid of
    ``ceil(q_rows / Q_TILE) · n_kv_heads · n_split`` blocks still reaches
    ``sms`` blocks, one key tile each at the shortest and at most
    :data:`MAX_SPLITS` of them; no split is empty."""
    total = prev + n_chunk
    if total <= 0:
        return 1, KEY_TILE
    n_tiles = -(-total // KEY_TILE)
    blocks = -(-q_rows // Q_TILE) * n_kv_heads
    per = max(1, n_tiles * blocks // sms, -(-n_tiles // MAX_SPLITS))
    per = min(n_tiles, per)
    return -(-n_tiles // per), per * KEY_TILE


def _ticket_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 tickets of ``device``'s current stream, zero:
    the kernel's last block of a query tile resets the ticket it took, and
    a launch on another stream takes tickets of its own.  A new buffer is
    zeroed on that stream, so it is ready before the launch that uses
    it."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


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
    n_split, split_keys, o_part, ml_part, tickets = 1, KEY_TILE, q, q, q
    if q.dtype == torch.bfloat16:
        prev = min(start, window) if window else start
        prev = max(0, min(prev, n_pages * page_size))
        n_split, split_keys = split_plan(prev, clen, CG, K,
                                         sms=sm_count(q.device))
        if n_split > 1:
            o_part = torch.empty((n_split, K, CG, hd), dtype=torch.float32,
                                 device=q.device)
            ml_part = torch.empty((n_split, K, CG, 2), dtype=torch.float32,
                                  device=q.device)
            tickets = _ticket_buffer(q.device, K * -(-CG // Q_TILE))
    fn = launcher("paged_prefill", [ctypes.c_void_p] * 10
                  + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), pt_row.data_ptr(),
                 out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(),
                 tickets.data_ptr(), DTYPE_CODE[q.dtype], K, C, G, hd,
                 page_size, n_pages, start, clen, int(window), hd ** -0.5,
                 split_keys, n_split, stream(q))
    raise_on(err, "paged_prefill")
    count_launch(paged_prefill_flat)
    return out


paged_prefill_flat.launches = 0
