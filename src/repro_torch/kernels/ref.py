"""Plain PyTorch versions of the port's CUDA kernels.

The EDM updates (plain and with the error-feedback wire) and the combines
repeat their kernel's arithmetic operation for operation, so on the card
the two agree bit for bit.  The paged
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

from .table_peer import table_columns

__all__ = ["edm_update_ref", "edm_update_ef_ref", "gossip_axpy_ref",
           "ring_combine_ref", "ring_peer_ref", "table_combine_ref",
           "table_peer_ref", "table_peer_q8_ref", "gossip_axpy_q8_ref",
           "wire_coefs",
           "finite_absmax", "int8_scale_inv", "flash_attention_ref",
           "gather_pages", "paged_attention_ref",
           "paged_prefill_attention_ref"]


def edm_update_ref(x, g, m, psi, *, alpha: float, beta: float,
                   out: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EDM chain ``m' = βm + (1−β)g``, ``ψ' = x − αm'``, ``φ = ψ' + x − ψ``.

    Every product and sum rounds to f32 on its own; ``(1 − β)`` is a Python
    double rounded once to f32, as in the JAX kernel.  ``out`` =
    ``(m_out, psi_out, phi_out)`` receives the results where an entry is
    not None (``m_out`` may be ``m`` and ``psi_out`` may be ``psi``: all
    three are computed first; ``phi_out`` may alias no input).  The chain
    accumulates in place where that changes no rounding (a sum's operands
    commute exactly), so a bus-sized call holds few temporaries."""
    m_new = beta * m
    m_new.add_((1.0 - beta) * g)
    psi_new = alpha * m_new
    torch.sub(x, psi_new, out=psi_new)
    phi_out = None if out is None else out[2]
    phi = torch.add(psi_new, x, out=phi_out) if phi_out is not None \
        else psi_new + x
    phi.sub_(psi)
    vals = (m_new, psi_new, phi)
    if out is None:
        return vals
    return tuple(val if dst is None or dst is val else dst.copy_(val)
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


def ring_combine_ref(x: torch.Tensor, terms: Sequence[Tuple[int, float]]
                     ) -> torch.Tensor:
    """The ring combine as the one-device ppermute engine runs it: each
    ``(shift, weight)`` term's payload is ``torch.roll(x, shift, 0)`` (``x``
    itself for shift 0 or one agent), then :func:`gossip_axpy_ref` over
    them in term order."""
    A = x.shape[0]
    payloads = [x if A == 1 or s % A == 0 else torch.roll(x, s, 0)
                for s, _ in terms]
    return gossip_axpy_ref(payloads, [w for _, w in terms])


def ring_peer_ref(x_self: torch.Tensor, x_left: torch.Tensor,
                  x_right: torch.Tensor, terms: Sequence[Tuple[int, float]],
                  n_ranks: int) -> torch.Tensor:
    """The multi-rank ring combine on three given payloads: each ``(shift,
    weight)`` term's operand is ``x_self`` (shift ≡ 0 mod ``n_ranks``, or
    one rank), ``x_left`` (+1: agent a − 1's payload) or ``x_right`` (−1),
    then :func:`gossip_axpy_ref` over them in term order — what the
    multi-rank ppermute engine computes from its permuted copies."""
    ops = []
    for s, _ in terms:
        s %= n_ranks
        ops.append(x_self if n_ranks == 1 or s == 0
                   else x_left if s == 1 else x_right)
    return gossip_axpy_ref(ops, [w for _, w in terms])


def table_peer_ref(payloads: Sequence[torch.Tensor], src,
                   weights) -> torch.Tensor:
    """The multi-rank source-table combine on given payloads, f32 out:
    ``payloads[j]`` is rank j's ``(B, rows, 128)`` f32 or bf16 payload, and
    agent b's term k reads block ``src[k][b]`` (global agent index rank ·
    B + agent; ``(K,)`` ranks at one agent a rank: a late or masked-out
    slot names the agent itself) — :func:`gossip_axpy_ref` over the
    agent's blocks in table order with f32 accumulation, as the one-device
    engines combine the permuted payloads (and decode the bf16 wire).
    Only the blocks the table names are read."""
    B = payloads[0].shape[0]
    src, w = table_columns(src, weights, B)
    out = torch.empty(payloads[0].shape, dtype=torch.float32,
                      device=payloads[0].device)
    for b in range(B):
        out[b] = gossip_axpy_ref(
            [payloads[int(g) // B][int(g) % B] for g in src[:, b]],
            [float(v) for v in w[:, b]], out_dtype=torch.float32)
    return out


def table_peer_q8_ref(qs: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor], src, weights, *,
                      block_rows: int) -> torch.Tensor:
    """The int8 wire's multi-rank dequantize-and-combine on given
    payloads: ``qs[j]`` / ``scales[j]`` rank j's ``(B, rows, 128)`` int8
    data and ``(B, rows // block_rows)`` f32 scales; agent b's
    coefficients are :func:`wire_coefs` of its column's weights and
    source blocks' scales, combined by :func:`gossip_axpy_q8_ref` — the
    one-device fused engines' ``gossip_axpy_wire`` / ``table_combine_wire``
    on the permuted payloads."""
    B = qs[0].shape[0]
    src, w = table_columns(src, weights, B)
    out = torch.empty(qs[0].shape, dtype=torch.float32, device=qs[0].device)
    for b in range(B):
        blocks = [(int(g) // B, int(g) % B) for g in src[:, b]]
        coefs = wire_coefs([float(v) for v in w[:, b]],
                           [scales[j][a] for j, a in blocks])
        out[b] = gossip_axpy_q8_ref([qs[j][a] for j, a in blocks], coefs,
                                    block_rows=block_rows)
    return out


def table_combine_ref(x: torch.Tensor, src, w,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The source-table combine ``out[a] = Σₖ w[k, a] · x[src[k, a]]``: term
    k's operand is x gathered by row ``src[k]``, weighted agent by agent by
    ``w[k]`` (f32), accumulated in f32 in slot order from ``w₀·o₀`` and
    rounded once to ``out_dtype`` (default: x's) — the gather route of the
    JAX package's masked engines with :func:`gossip_axpy_ref`'s rounding.
    Weight-0 slots are computed (0·Inf is NaN, as in the stack)."""
    src = torch.as_tensor(src, device=x.device).long()
    w = torch.as_tensor(w, dtype=torch.float32, device=x.device)
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)

    def term(k):       # a gathered copy of its own, weighted in place
        return x.index_select(0, src[k]).float().mul_(w[k].view(bshape))

    acc = term(0)
    for k in range(1, src.shape[0]):
        acc.add_(term(k))
    return acc.to(out_dtype or x.dtype)


def int8_scale_inv(absmax: torch.Tensor):
    """``(scale, inv)`` of blocks with finite absmax ``absmax``:
    ``absmax / 127`` and ``127 / max(absmax, 1e-30)`` where ``absmax > 0``,
    else 0 — the reference's guards, shared by the codec and the fused
    kernel's plain version.  Both divide tensor by tensor: on CUDA,
    PyTorch turns a division by a Python scalar into a product with its
    reciprocal, which rounds differently from the kernel's division."""
    c127 = torch.full_like(absmax, 127.0)
    scale = absmax / c127
    inv = torch.where(absmax > 0.0, c127 / absmax.clamp(min=1e-30),
                      torch.zeros_like(absmax))
    return scale, inv


def finite_absmax(blocks: torch.Tensor) -> torch.Tensor:
    """Max |x| over the last axis, non-finite values counted as 0."""
    mag = blocks.abs()
    mag.masked_fill_(~torch.isfinite(blocks), 0.0)
    return mag.amax(-1)




def edm_update_ef_ref(x, g, m, psi, e, *, alpha: float, beta: float,
                      fmt: str, block_rows: int,
                      out: Optional[Sequence[torch.Tensor]] = None):
    """EDM chain plus error-feedback quantization of ``c = φ + e``, as the
    Pallas kernels ``_edm_ef_bf16_kernel`` / ``_edm_ef_int8_kernel`` do.

    Inputs: f32 tensors of one shape ``(..., 128)``; for int8 the scale
    tiles are ``block_rows`` consecutive rows of the flattened row axis.
    Returns ``(m', ψ', q, e')`` for ``fmt="bf16"`` (``q`` bf16) and
    ``(m', ψ', q, scale, e')`` for ``fmt="int8"`` (``q`` int8, ``scale``
    f32 of shape ``(n_tiles,)``), written into ``out`` (same order) where
    an entry is not None; ``m_out``, ``psi_out`` and ``e_out`` may alias
    ``m``, ``psi`` and ``e``.

    int8, per tile: ``absmax`` over finite ``|c|``; ``scale =
    absmax / 127``; ``inv = 127 / max(absmax, 1e-30)`` if ``absmax > 0``
    else 0; ``q = clip(round_half_even(c · inv), ±127)``, 0 where ``c`` is
    NaN; ``e' = c − q · scale`` with that f32 ``q``.  The int8 store maps a
    still-NaN ``q`` (±Inf in a tile whose finite values are all 0) to 0,
    and ``e'`` is NaN there — the Pallas kernel's values, not the codec's
    (:func:`repro_torch.core.wire.encode_ef` gives ``e' = ±Inf``)."""
    if fmt not in ("bf16", "int8"):
        raise ValueError(f"edm_update_ef_ref takes fmt bf16 or int8, got "
                         f"{fmt!r} (f32 has no quantize: edm_update_ref)")
    out = tuple(out) if out is not None else (None,) * (4 if fmt == "bf16"
                                                         else 5)
    m_new, psi_new, c = edm_update_ref(x, g, m, psi, alpha=alpha, beta=beta,
                                       out=(out[0], out[1], None))
    c.add_(e)                                  # e is read before e_out is written
    if fmt == "bf16":
        q = c.to(torch.bfloat16)
        e_new = c.sub_(q.float())
        vals = (m_new, psi_new, q, e_new)
    else:
        blocks = c.view(-1, block_rows * c.shape[-1])
        scale, inv = int8_scale_inv(finite_absmax(blocks))
        qf = blocks * inv[:, None]
        qf.round_().clamp_(-127.0, 127.0)
        qf.masked_fill_(torch.isnan(blocks), 0.0)
        e_new = c.sub_((qf * scale[:, None]).view(c.shape))
        q = qf.masked_fill_(torch.isnan(qf), 0.0).to(torch.int8).view(c.shape)
        vals = (m_new, psi_new, q, scale, e_new)
    return tuple(val if dst is None or dst is val else dst.copy_(val)
                 for dst, val in zip(out, vals))


def wire_coefs(weights: Sequence[float],
               scales: Sequence[torch.Tensor]) -> torch.Tensor:
    """``(n, n_tiles)`` f32 products ``wₖ · scaleₖ[tile]`` of the int8
    combine: each operand's scales flattened in tile order (agent-major,
    since rows is a multiple of block_rows per agent)."""
    # a Python weight times an f32 tensor rounds the weight to f32 first:
    # the product of two f32 values, with no host-to-device copy (which a
    # CUDA graph capture would refuse)
    return torch.stack([t.reshape(-1) * float(w)
                        for w, t in zip(weights, scales)])


def gossip_axpy_q8_ref(operands: Sequence[torch.Tensor], coefs: torch.Tensor,
                       *, block_rows: int) -> torch.Tensor:
    """Dequantize-and-combine ``Σₖ coef[k, tile] · f32(qₖ)`` of int8
    operands of one shape ``(..., 128)``: f32 accumulation in term order,
    starting from ``coef[0]·q₀``; tile = ``block_rows`` consecutive rows
    of the flattened row axis."""
    first = operands[0]
    width = block_rows * first.shape[-1]

    def term(k):
        return (coefs[k][:, None] * operands[k].reshape(-1, width).float())

    acc = term(0)
    for k in range(1, len(operands)):
        acc = acc + term(k)
    return acc.view(first.shape)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Plain flash GQA attention, the Pallas kernel's function.
    q: (B, H, Sq, hd); k, v: (B, K, Sk, hd); query head h reads KV head
    ``h // (H/K)``.  Scores ``(q·hd^-0.5)·k`` in f32 on absolute positions
    from 0 on both axes; key j is live for query i iff (not causal or
    j <= i) and (``window == 0`` or j > i − window).  A row with no live
    key outputs 0, as the Pallas kernel's does (the JAX package's
    ``ref.flash_attention_ref`` returns the mean of v there instead).
    One rounding to q's dtype."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    s = (q.float() * hd ** -0.5) @ kf.transpose(-1, -2)     # (B, H, Sq, Sk)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    live = mask.any(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    del s
    out = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


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
