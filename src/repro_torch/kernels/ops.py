"""Device-dispatching entry points to the port's kernels.

The counterpart of ``repro/kernels/ops.py``.  Each op looks at the device
of the tensors it is given: on ``cuda`` it launches the CUDA kernel (a
build or launch failure raises), on ``cpu`` — which the caller chose
explicitly, see :func:`repro_torch.device.resolve_device` — it runs the
plain PyTorch version.  Nothing turns a kernel failure into the plain
version.

The combines (``gossip_axpy``, ``gossip_axpy_wire``, ``ring_combine``,
``table_combine``, ``table_combine_wire``) take a policy group's rows
``bus[:, r0:r1]`` of a larger bus as their bus operand and ``out=``
where their kernels read or write it in place (an agent stride, no
copy); their plain versions take the same views.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from . import ref
from .edm_update import (BLOCK_ROWS, LANE, edm_update_ef_flat,
                         edm_update_flat, gossip_axpy_flat,
                         gossip_axpy_q8_flat)
from .flash_attention import flash_attention_flat
from .paged_attention import paged_attention_flat
from .paged_prefill import paged_prefill_flat
from .ring_dma import ring_combine_flat, ring_operands
from .ring_peer import peer_operands, ring_peer_flat
from .table_combine import table_combine_flat, table_operands
from .table_peer import (table_peer_flat, table_peer_operands,
                         table_peer_q8_flat)

__all__ = ["edm_update", "edm_update_tree", "edm_update_bus",
           "edm_update_bus_ef", "gossip_axpy", "gossip_axpy_wire",
           "ring_combine", "ring_peer", "table_combine", "table_combine_wire",
           "table_peer", "table_peer_q8",
           "flash_attention", "paged_attention",
           "paged_prefill_attention", "padded_size", "pack_leaf",
           "unpack_leaf", "launch_counts", "reset_launch_counts"]


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")


def _bus_flat(b: torch.Tensor, what: str) -> torch.Tensor:
    """``(A, rows, 128)`` bus → its ``(A·rows, 128)`` view."""
    if not b.is_contiguous():
        raise ValueError(f"{what} takes contiguous buses")
    return b.view(-1, LANE)


def padded_size(n: int, block_rows: Optional[int] = None) -> int:
    """Elements an ``n``-element array occupies once padded to whole
    ``(block_rows, 128)`` tiles, as the JAX wrappers pad per leaf."""
    tile = (block_rows or BLOCK_ROWS) * LANE
    return -(-n // tile) * tile


def pack_leaf(t: torch.Tensor, block_rows: Optional[int] = None
              ) -> torch.Tensor:
    """Any-shape array → a new zero-padded ``(rows, 128)`` f32 buffer of
    :func:`padded_size` elements, as the JAX wrappers pack a leaf."""
    n = t.numel()
    flat = torch.zeros(padded_size(n, block_rows), dtype=torch.float32,
                       device=t.device)
    flat[:n] = t.reshape(-1)
    return flat.view(-1, LANE)


def unpack_leaf(packed: torch.Tensor, shape, dtype: torch.dtype
                ) -> torch.Tensor:
    """Inverse of :func:`pack_leaf`: the first ``prod(shape)`` elements,
    reshaped and cast to ``dtype``."""
    n = 1
    for d in shape:
        n *= d
    return packed.reshape(-1)[:n].view(shape).to(dtype)


def edm_update(x, g, m, psi, *, alpha: float, beta: float,
               block_rows: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Array-level fused EDM update, any shape: each input is packed to
    a padded ``(rows, 128)`` f32 buffer (:func:`pack_leaf`), updated by ONE
    kernel launch on the card (the plain chain on the CPU), and unpacked
    to its own dtype.  Returns ``(m', ψ', φ)`` in the dtypes of m, ψ and
    x."""
    xp, gp, mp, pp = (pack_leaf(t, block_rows) for t in (x, g, m, psi))
    update = edm_update_flat if _on_card(x) else ref.edm_update_ref
    # m' and ψ' over the packed temporaries: one f32 copy fewer at peak
    m2, psi2, phi = update(xp, gp, mp, pp, alpha=alpha, beta=beta,
                           out=(mp, pp, None))
    del xp, gp
    return (unpack_leaf(m2, m.shape, m.dtype),
            unpack_leaf(psi2, psi.shape, psi.dtype),
            unpack_leaf(phi, x.shape, x.dtype))


def edm_update_tree(params: Mapping[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor],
                    m: Mapping[str, torch.Tensor],
                    psi: Mapping[str, torch.Tensor], *, alpha: float,
                    beta: float):
    """Tree-level fused update over ``{path: tensor}`` dicts: one
    :func:`edm_update` (one kernel launch on the card) per leaf.  Returns
    ``(m', φ, ψ')`` dicts, the optimizer's order, as the JAX
    ``edm_update_tree`` does.  A bare tensor is a one-leaf tree."""
    if not isinstance(params, Mapping):
        m_new, psi_new, phi = edm_update(params, grads, m, psi, alpha=alpha,
                                         beta=beta)
        return m_new, phi, psi_new
    m_new, phi, psi_new = {}, {}, {}
    for p in params:
        m_new[p], psi_new[p], phi[p] = edm_update(
            params[p], grads[p], m[p], psi[p], alpha=alpha, beta=beta)
    return m_new, phi, psi_new


def edm_update_bus(x, g, m, psi, *, alpha: float, beta: float,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused EDM update over the whole ``(A, rows, 128)`` bus: ONE kernel
    launch on the card.  Returns ``(m', ψ', φ)`` in bus layout, written
    into the entries of ``out`` that are not None (``out[0]`` may be
    ``m``, ``out[1]`` ``psi``)."""
    _, _, lane = x.shape
    if lane != LANE:
        raise ValueError(f"bus lane width must be {LANE}, got {x.shape}")
    if not _on_card(x):
        return ref.edm_update_ref(x, g, m, psi, alpha=alpha, beta=beta,
                                  out=out)

    def flat(b):
        return None if b is None else _bus_flat(b, "edm_update_bus")

    outs = edm_update_flat(flat(x), flat(g), flat(m), flat(psi), alpha=alpha,
                           beta=beta, out=[flat(o) for o in out or ()])
    return tuple(o.view(x.shape) for o in outs)


def edm_update_bus_ef(x, g, m, psi, e, *, alpha: float, beta: float,
                      fmt: str, block_rows: Optional[int] = None,
                      out: Optional[Sequence[torch.Tensor]] = None,
                      payload_out=None):
    """Fused EDM update with error-feedback quantization over the whole
    ``(A, rows, 128)`` bus: ONE kernel launch on the card.

    Returns ``(m', ψ', payload, e')`` where ``payload`` is the wire codec's
    (:class:`repro_torch.core.wire.WireCodec`): a bf16 bus for
    ``fmt="bf16"``, ``(int8 bus, (A, rows // block_rows) f32 scales)``
    for ``fmt="int8"``.  ``out = (m_out, psi_out, e_out)`` receives m', ψ'
    and e' where an entry is not None (each may alias its input);
    ``payload_out`` (a payload of the same form, contiguous: a peer
    table's slot) receives the payload.  f32 has no quantize to fuse: it
    raises, as the JAX wrapper has no f32 case."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"edm_update_bus_ef takes fmt bf16 or int8, got "
                         f"{fmt!r}; the f32 wire is edm_update_bus")
    block_rows = block_rows or BLOCK_ROWS
    A, rows, lane = x.shape
    if lane != LANE or rows % block_rows:
        raise ValueError(f"bus {tuple(x.shape)} is not (A, rows, {LANE}) "
                         f"with rows a multiple of block_rows={block_rows}")
    m_out, psi_out, e_out = out or (None,) * 3
    q_out, s_out = ((None, None) if payload_out is None
                    else tuple(payload_out) if fmt == "int8"
                    else (payload_out, None))
    if not _on_card(x):
        outs = ref.edm_update_ef_ref(
            x, g, m, psi, e, alpha=alpha, beta=beta, fmt=fmt,
            block_rows=block_rows,
            out=(m_out, psi_out, q_out)
            + ((None if s_out is None else s_out.view(-1),)
               if fmt == "int8" else ()) + (e_out,))
    else:
        def flat(b):
            return None if b is None else _bus_flat(b, "edm_update_bus_ef")

        outs = edm_update_ef_flat(
            flat(x), flat(g), flat(m), flat(psi), flat(e), alpha=alpha,
            beta=beta, fmt=fmt, block_rows=block_rows,
            out=(flat(m_out), flat(psi_out), flat(q_out))
            + ((None if s_out is None else s_out.view(-1),)
               if fmt == "int8" else ()) + (flat(e_out),))
    m2, psi2, q = (o.view(x.shape) for o in outs[:3])
    payload = (q, outs[3].view(A, rows // block_rows)) if fmt == "int8" \
        else q
    return m2, psi2, payload, outs[-1].view(x.shape)


def gossip_axpy(operands: Sequence[torch.Tensor], weights: Sequence[float],
                *, out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n-ary combine ``Σₖ wₖ·operandₖ`` for same-shape operands (f32 or
    bf16), f32 accumulation, one rounding to ``out_dtype`` (default: the
    operands' dtype), written into ``out`` when given (it may alias no
    operand).  One kernel launch on the card."""
    operands = tuple(operands)
    if not _on_card(operands[0]):
        val = ref.gossip_axpy_ref(operands, weights, out_dtype=out_dtype)
        return val if out is None else out.copy_(val)
    return gossip_axpy_flat(operands, weights, out_dtype=out_dtype, out=out)


def gossip_axpy_wire(payloads: Sequence, weights: Sequence[float], *,
                     fmt: str, block_rows: Optional[int] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused decode-and-combine ``Σₖ wₖ · decode(payloadₖ)`` of wire-coded
    gossip payloads, f32 out (into ``out`` when given), one kernel launch
    on the card.

    ``payloads``: post-permute payloads of one format — f32 or bf16 buses
    (the combine kernel, f32 out: the decode is its widening), or
    ``(q, scale)`` int8 pairs, whose weight × per-tile scale products
    become the q8 kernel's ``(n, n_tiles)`` coefficients."""
    payloads = tuple(payloads)
    if fmt in ("f32", "bf16"):
        return gossip_axpy(payloads, weights, out_dtype=torch.float32,
                           out=out)
    if fmt != "int8":
        raise ValueError(f"unknown wire format {fmt!r}")
    block_rows = block_rows or BLOCK_ROWS
    qs, scales = zip(*payloads)
    coefs = ref.wire_coefs(weights, scales)
    if not _on_card(qs[0]):
        val = ref.gossip_axpy_q8_ref(qs, coefs, block_rows=block_rows)
        return val if out is None else out.copy_(val)
    return gossip_axpy_q8_flat(qs, coefs, block_rows=block_rows, out=out)


def ring_combine(x: torch.Tensor, terms: Sequence[Tuple[int, float]], *,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ring transport's combine ``out[a] = Σₖ wₖ · x[(a − shiftₖ) mod
    A]`` over an ``(A, rows, 128)`` f32 bus, ``terms`` the ring's
    ``(shift, weight)`` pairs in topology order: one kernel launch on the
    card (the rolls fused in), the rolls plus the plain combine on the
    CPU.  ``out`` may alias no byte of ``x``."""
    ring_operands(x, terms, out)        # the card's checks, on every device
    if not _on_card(x):
        val = ref.ring_combine_ref(x, terms)
        return val if out is None else out.copy_(val)
    return ring_combine_flat(x, terms, out=out)


def ring_peer(x_self: torch.Tensor, x_left: torch.Tensor,
              x_right: torch.Tensor, terms: Sequence[Tuple[int, float]],
              n_ranks: int, *, out: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """The multi-rank ring combine ``Σₖ wₖ · x_srcₖ`` over this rank's
    payload and its neighbours' (``terms`` the ring's ``(shift, weight)``
    pairs over ``n_ranks`` ranks): one kernel launch on the card, reading
    peer views in place (:class:`repro_torch.kernels.ring_peer.PeerRing`),
    the plain combine on the CPU."""
    peer_operands(x_self, x_left, x_right, terms, n_ranks, out)
    if not _on_card(x_self):
        val = ref.ring_peer_ref(x_self, x_left, x_right, terms, n_ranks)
        return val if out is None else out.copy_(val)
    return ring_peer_flat(x_self, x_left, x_right, terms, n_ranks, out=out)


def table_peer(payloads: Sequence[torch.Tensor], src, weights, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The multi-rank source-table combine ``out[b] = Σₖ w[k, b] ·
    block[src[k, b]]`` over the ``(B, rows, 128)`` f32 or bf16 payloads of
    the ranks of one host (``payloads[j]`` rank j's, peer views in place:
    :class:`repro_torch.kernels.table_peer.PeerTable`; ``src`` global agent
    indices, ``(K,)`` ranks at one agent a rank), f32 out: one kernel
    launch on the card, the plain combine on the CPU; only the blocks the
    table names are read."""
    blocks, _, _ = table_peer_operands(payloads, src, weights, out)
    if not _on_card(payloads[blocks[0] // payloads[0].shape[0]]):
        val = ref.table_peer_ref(payloads, src, weights)
        return val if out is None else out.copy_(val)
    return table_peer_flat(payloads, src, weights, out=out)


def table_peer_q8(qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                  src, weights, *, block_rows: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 wire's multi-rank dequantize-and-combine over the ranks'
    ``(B, rows, 128)`` int8 payloads and ``(B, rows // block_rows)`` f32
    scales (peer views in place), f32 out: one kernel launch on the card,
    the plain version on the CPU."""
    blocks, _, _ = table_peer_operands(qs, src, weights, out, scales=scales,
                                       block_rows=block_rows)
    if not _on_card(qs[blocks[0] // qs[0].shape[0]]):
        val = ref.table_peer_q8_ref(qs, scales, src, weights,
                                    block_rows=block_rows)
        return val if out is None else out.copy_(val)
    return table_peer_q8_flat(qs, scales, src, weights,
                              block_rows=block_rows, out=out)


def table_combine(x: torch.Tensor, src: torch.Tensor, w: torch.Tensor, *,
                  out_dtype: Optional[torch.dtype] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The source-table combine ``out[a] = Σₖ w[k, a] · x[src[k, a]]`` over
    an ``(A, ...)`` f32 or bf16 tensor, ``src`` / ``w`` ``(K, A)`` int32 /
    f32 tables on x's device: one kernel launch on the card (the tables
    read from device memory), the gather route on the CPU.  f32
    accumulation, one rounding to ``out_dtype`` (default: x's), into
    ``out`` when given (it may alias no byte of ``x``)."""
    table_operands(x, src, w, out_dtype, out)   # the card's checks, everywhere
    if not _on_card(x):
        val = ref.table_combine_ref(x, src, w, out_dtype=out_dtype)
        return val if out is None else out.copy_(val)
    return table_combine_flat(x, src, w, out_dtype=out_dtype, out=out)


def table_combine_wire(payload, src: torch.Tensor, w: torch.Tensor, *,
                       fmt: str, block_rows: Optional[int] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The source-table combine of a wire-coded ``(A, rows, 128)`` bus
    payload, decode folded in, f32 out: a bf16 bus goes through the table
    kernel with f32 out; an int8 ``(q, scale)`` pair is gathered by the
    table (``q`` rows and their per-tile scales) into the q8 combine,
    whose per-tile coefficients ``w[k, a] · scale`` carry the per-agent
    weights (the tiles are agent-major)."""
    if fmt in ("f32", "bf16"):
        return table_combine(payload, src, w, out_dtype=torch.float32,
                             out=out)
    if fmt != "int8":
        raise ValueError(f"unknown wire format {fmt!r}")
    q, scale = payload
    idx = src.long()
    qs = [q.index_select(0, idx[k]) for k in range(idx.shape[0])]
    coefs = torch.stack([(scale.index_select(0, idx[k])
                          * w[k].view(-1, 1)).reshape(-1)
                         for k in range(idx.shape[0])])
    block_rows = block_rows or BLOCK_ROWS
    if not _on_card(q):
        val = ref.gossip_axpy_q8_ref(qs, coefs, block_rows=block_rows)
        return val if out is None else out.copy_(val)
    return gossip_axpy_q8_flat(qs, coefs, block_rows=block_rows, out=out)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    blk_q: int = 128, blk_k: int = 128) -> torch.Tensor:
    """Flash GQA attention in the ``(B, H, S, hd)`` layout: q
    ``(B, H, Sq, hd)``, k, v ``(B, K, Sk, hd)``.  ``blk_q`` / ``blk_k``
    keep the JAX op's shape contract (``Sq % blk_q == 0``,
    ``Sk % blk_k == 0``); they do not choose the CUDA kernel's tiles.
    One kernel launch on the card; the plain version on the CPU."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} KV "
                         "heads")
    if blk_q <= 0 or blk_k <= 0 or Sq % blk_q or Sk % blk_k:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of "
                         f"blk_q={blk_q} and blk_k={blk_k}")
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_flat(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal, window=window)


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
            "edm_update_ef": edm_update_ef_flat,
            "gossip_axpy_q8": gossip_axpy_q8_flat,
            "flash_attention": flash_attention_flat,
            "paged_attention": paged_attention_flat,
            "paged_prefill": paged_prefill_flat,
            "ring_combine": ring_combine_flat,
            "ring_peer": ring_peer_flat,
            "table_combine": table_combine_flat,
            "table_peer": table_peer_flat,
            "table_peer_q8": table_peer_q8_flat}


def launch_counts() -> Dict[str, int]:
    """Kernels the wrappers ran since the last :func:`reset_launch_counts`
    (a CUDA graph's capture and replays are not among them:
    :func:`repro_torch.kernels._ffi.count_launch`)."""
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
