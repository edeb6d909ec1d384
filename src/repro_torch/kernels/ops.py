"""Device-dispatching entry points to the port's kernels.

The counterpart of ``repro/kernels/ops.py``.  Each op looks at the device
of the tensors it is given: on ``cuda`` it launches the CUDA kernel (a
build or launch failure raises), on ``cpu`` — which the caller chose
explicitly, see :func:`repro_torch.device.resolve_device` — it runs the
plain PyTorch version.  Nothing turns a kernel failure into the plain
version.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import ref
from .edm_update import (BLOCK_ROWS, LANE, edm_update_flat,
                         gossip_axpy_flat)
from .paged_attention import paged_attention_flat
from .paged_prefill import paged_prefill_flat

__all__ = ["edm_update_bus", "gossip_axpy", "paged_attention",
           "paged_prefill_attention", "padded_size", "launch_counts",
           "reset_launch_counts"]


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")


def padded_size(n: int, block_rows: Optional[int] = None) -> int:
    """Elements an ``n``-element array occupies once padded to whole
    ``(block_rows, 128)`` tiles, as the JAX wrappers pad per leaf."""
    tile = (block_rows or BLOCK_ROWS) * LANE
    return -(-n // tile) * tile


def edm_update_bus(x, g, m, psi, *, alpha: float, beta: float,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EDM update over the whole ``(A, rows, 128)`` bus: ONE kernel
    launch on the card.  Returns ``(m', ψ', φ)`` in bus layout, written
    into the entries of ``out`` that are not None (``out[0]`` may be
    ``m``, ``out[1]`` ``psi``)."""
    A, rows, lane = x.shape
    if lane != LANE:
        raise ValueError(f"bus lane width must be {LANE}, got {x.shape}")
    if not _on_card(x):
        return ref.edm_update_ref(x, g, m, psi, alpha=alpha, beta=beta,
                                  out=out)
    def flat(b):
        if b is None:
            return None
        if not b.is_contiguous():
            raise ValueError("edm_update_bus takes contiguous buses")
        return b.view(A * rows, LANE)

    outs = edm_update_flat(flat(x), flat(g), flat(m), flat(psi), alpha=alpha,
                           beta=beta, out=[flat(o) for o in out or ()])
    return tuple(o.view(x.shape) for o in outs)


def gossip_axpy(operands: Sequence[torch.Tensor], weights: Sequence[float],
                *, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """n-ary combine ``Σₖ wₖ·operandₖ`` for same-shape operands (f32 or
    bf16), f32 accumulation, one rounding to ``out_dtype`` (default: the
    operands' dtype).  One kernel launch on the card."""
    operands = tuple(operands)
    if not _on_card(operands[0]):
        return ref.gossip_axpy_ref(operands, weights, out_dtype=out_dtype)
    return gossip_axpy_flat(operands, weights, out_dtype=out_dtype)


def paged_attention(q, k_pool, v_pool, page_table, kv_len, *,
                    page_size: int) -> torch.Tensor:
    """Paged decode attention: q (B, K, G, hd) single-token queries grouped
    by KV head, pools (num_pages, page_size, K, hd), page_table
    (B, n_pages) int32, kv_len (B,) int32.  Returns (B, K, G, hd); an idle
    slot (``kv_len == 0``) gets a zero tile.  One kernel launch on the
    card."""
    if not _on_card(q):
        return ref.paged_attention_ref(q, k_pool, v_pool, page_table, kv_len,
                                       page_size=page_size)
    return paged_attention_flat(q.contiguous(), k_pool, v_pool, page_table,
                                kv_len, page_size=page_size)


def paged_prefill_attention(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                            chunk_start: int, chunk_len: int, *,
                            page_size: int, window: int = 0) -> torch.Tensor:
    """Paged prefill attention of one chunk of one slot, in the model's
    layout: q (1, C, H, hd), k_chunk / v_chunk (1, C, K, hd) the chunk's
    keys and values (not yet in the pools), pools (num_pages, page_size,
    K, hd), pt_row (n_pages,) int32.  Returns (1, C, H, hd).  On the card
    the queries go to the kernel's ``(K, C·G, hd)`` layout (row
    ``i·G + g`` = token i, group member g) and back, around one kernel
    launch; ``chunk_start`` and ``chunk_len`` are kernel arguments."""
    if not _on_card(q):
        return ref.paged_prefill_attention_ref(
            q, k_chunk, v_chunk, k_pool, v_pool, pt_row, chunk_start,
            chunk_len, page_size=page_size, window=window)
    _, C, H, hd = q.shape
    K = k_chunk.shape[2]
    G = H // K
    qk = q.reshape(C, K, G, hd).permute(1, 0, 2, 3).reshape(K, C * G, hd)
    kc = k_chunk[0].permute(1, 0, 2).contiguous()          # (K, C, hd)
    vc = v_chunk[0].permute(1, 0, 2).contiguous()
    out = paged_prefill_flat(qk.contiguous(), kc, vc, k_pool, v_pool, pt_row,
                             chunk_start, chunk_len, page_size=page_size,
                             window=window)
    return out.reshape(K, C, G, hd).permute(1, 0, 2, 3).reshape(1, C, H, hd)


_COUNTED = {"edm_update": edm_update_flat, "gossip_axpy": gossip_axpy_flat,
            "paged_attention": paged_attention_flat,
            "paged_prefill": paged_prefill_flat}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
