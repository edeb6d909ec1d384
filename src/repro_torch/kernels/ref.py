"""Plain PyTorch versions of the port's CUDA kernels.

The EDM update and the combine repeat their kernel's arithmetic operation
for operation, so on the card the two agree bit for bit.  The paged
attention versions are the op sequences of ``repro/kernels/ref.py``
(gather the pages, then a full softmax), which the kernels' online
softmax matches to a stated tolerance.  The CPU tests hold these against
the JAX package's Pallas kernels (run in interpret mode), and the wrappers
in :mod:`repro_torch.kernels.ops` use them for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.models.attention import (_gather_pages, paged_prefill_sdpa,
                                          sdpa_ref)

__all__ = ["edm_update_ref", "gossip_axpy_ref", "gather_pages",
           "paged_attention_ref", "paged_prefill_attention_ref"]


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


# the dense view of a paged pool, shared with the model's plain path
gather_pages = _gather_pages


def paged_attention_ref(q, k_pool, v_pool, page_table, kv_len, *,
                        page_size: int) -> torch.Tensor:
    """Plain paged decode attention: gather each slot's pages into a dense
    cache and run ``sdpa_ref`` with per-slot ``kv_len`` masking.
    q: (B, K, G, hd) grouped single-token queries; returns (B, K, G, hd).
    An idle slot (``kv_len == 0``) gives a zero tile, as the kernel does
    (the softmax over all-masked rows alone would average its null-page
    rows)."""
    B, K, G, hd = q.shape
    if k_pool.shape[1] != page_size:
        raise ValueError(f"pool page size {k_pool.shape[1]} != {page_size}")
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    out = sdpa_ref(q.reshape(B, 1, K * G, hd), k, v, causal=False,
                   kv_len=kv_len).reshape(B, K, G, hd)
    live = (torch.as_tensor(kv_len, device=q.device) > 0)[:, None, None, None]
    return torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def paged_prefill_attention_ref(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                                chunk_start, chunk_len, *, page_size: int,
                                window: int = 0) -> torch.Tensor:
    """Plain paged prefill attention: gather the slot's pages, add the
    in-flight chunk's keys and values, and run the positional SDPA with
    ring-aware key positions and a per-element window mask.
    q: (1, C, H, hd); k_chunk, v_chunk: (1, C, K, hd); pt_row:
    (n_pages,); returns (1, C, H, hd).  The ``attn_impl="ref"`` engine
    runs this same function."""
    if k_pool.shape[1] != page_size:
        raise ValueError(f"pool page size {k_pool.shape[1]} != {page_size}")
    return paged_prefill_sdpa(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                              chunk_start, chunk_len, window=window)
