"""GQA attention: the counterpart of ``repro/models/attention.py`` for
training, cached decode, the encoder-decoder's cross attention and the
paged serving paths.

Plain einsum and matmul, as the JAX path is plain jnp (it trains on
``sdpa_ref``, not on the Pallas flash kernel).  Logits and softmax are f32,
masked entries take ``-1e30``, and the output is cast back to the query
dtype.

Caches and page pools are updated IN PLACE (``index_put_`` / slice writes
on the per-layer views), where the JAX ``.at[].set`` and
``dynamic_update_slice`` copy; the functions still return the updated
tensors, so callers read like the reference.  The orders the reference
relies on are kept: paged decode writes the new row first and then
attends, paged prefill attends first and then writes.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .layers import rms_norm, rope

__all__ = ["sdpa_ref", "sdpa_pos_ref", "prev_page_positions",
           "paged_prefill_sdpa", "apply_attn", "apply_attn_paged",
           "apply_attn_paged_prefill", "init_kv_cache"]

NEG_INF = -1e30


def _as_long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def sdpa_ref(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
             kv_len=None) -> torch.Tensor:
    """Scaled dot-product attention with GQA head sharing.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); H % K == 0.  ``q_offset`` is
    the absolute position of q[0] (cached decode).  ``kv_len`` is the
    number of valid kv rows: a scalar, or a ``(B,)`` tensor for ragged
    slot batches (the continuous-batching engine)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf * scale, k.float())
    q_pos = q_offset + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    lens = None if kv_len is None else _as_long(kv_len, dev)
    if lens is not None and lens.dim() == 1:
        # ragged slot batch: a per-slot valid-kv mask
        bmask = mask[None] & (k_pos[None, None, :] < lens[:, None, None])
        logits = torch.where(bmask[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    else:
        if lens is not None:
            mask &= k_pos[None, :] < lens
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def sdpa_pos_ref(q, k, v, *, q_pos, k_pos, k_valid,
                 window: int = 0) -> torch.Tensor:
    """GQA SDPA with explicit per-row key positions and validity: the
    chunked-prefill reference, where the key rows mix ring or linear page
    rows with the in-flight chunk.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); q_pos: (Sq,); k_pos: (Sk,);
    k_valid: (Sk,) bool.  Mask: valid ∧ causal (k_pos ≤ q_pos) ∧ window
    (k_pos > q_pos − w)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf * scale, k.float())
    mask = k_valid[None, :] & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def prev_page_positions(n_rows: int, chunk_start, window: int = 0,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, valid) of the previously filled page rows a prefill
    chunk starting at absolute position ``chunk_start`` attends to.

    Linear (``window == 0``): row r holds position r, valid iff
    r < chunk_start.  Ring: row r holds the latest position p < chunk_start
    with p ≡ r (mod window), ``(chunk_start−1) − ((chunk_start−1−r) mod
    window)``, valid iff that position exists; the occupied rows are the
    prefix [0, min(chunk_start, window))."""
    r = torch.arange(n_rows, dtype=torch.int32, device=device)
    start = int(chunk_start)
    if window:
        pos = (start - 1) - torch.remainder(start - 1 - r, window)
        # rows past the ring (NULL page-table entries) alias in-window
        # positions through the mod: only the ring's own rows are real
        valid = (pos >= 0) & (pos < start) & (r < window)
    else:
        pos = r
        valid = (pos >= 0) & (pos < start)
    return pos, valid


def _gather_pages(pool, page_table) -> torch.Tensor:
    """Dense view of a paged pool: (num_pages, page_size, K, hd) gathered
    through a (B, n_pages) page table → (B, n_pages·page_size, K, hd).
    Row ``j·page_size + r`` of slot b is row r of physical page
    ``page_table[b, j]``.  Also :func:`repro_torch.kernels.ref.gather_pages`."""
    B, n_pages = page_table.shape
    _, page_size, K, hd = pool.shape
    dense = pool.index_select(0, page_table.reshape(-1).long())
    return dense.reshape(B, n_pages * page_size, K, hd)


def paged_prefill_sdpa(q, k_chunk, v_chunk, k_pool, v_pool, pt_row,
                       chunk_start, chunk_len, *,
                       window: int = 0) -> torch.Tensor:
    """Plain chunked-prefill attention: chunk queries attend causally to
    every previously filled page row of ONE slot (gathered through its
    page-table row) plus the in-flight chunk's own keys, which ride
    alongside rather than through the pool.

    q: (1, C, H, hd); k_chunk, v_chunk: (1, C, K, hd); pools
    (num_pages, page_size, K, hd); pt_row: (n_pages,); chunk_start: the
    absolute position of q[0]; chunk_len: valid chunk rows.  This is the
    ``attn_impl="ref"`` op sequence and the plain version of the paged
    prefill kernel."""
    C = q.shape[1]
    dev = q.device
    k_prev = _gather_pages(k_pool, pt_row[None])      # (1, R, K, hd)
    v_prev = _gather_pages(v_pool, pt_row[None])
    kpos_prev, valid_prev = prev_page_positions(k_prev.shape[1], chunk_start,
                                                window, device=dev)
    # never-written rows: masked logits already exclude them, but
    # 0·NaN = NaN in the value product would leak pool poison
    dead = ~valid_prev[None, :, None, None]
    k_prev = torch.where(dead, torch.zeros((), dtype=k_prev.dtype,
                                           device=dev), k_prev)
    v_prev = torch.where(dead, torch.zeros((), dtype=v_prev.dtype,
                                           device=dev), v_prev)
    qpos = int(chunk_start) + torch.arange(C, dtype=torch.int32, device=dev)
    k_all = torch.cat([k_prev, k_chunk], dim=1)
    v_all = torch.cat([v_prev, v_chunk], dim=1)
    k_pos = torch.cat([kpos_prev, qpos])
    k_valid = torch.cat([valid_prev,
                         torch.arange(C, device=dev) < int(chunk_len)])
    return sdpa_pos_ref(q, k_all, v_all, q_pos=qpos, k_pos=k_pos,
                        k_valid=k_valid, window=window)


def _qkv(p: Dict[str, torch.Tensor], cfg, x, positions):
    """Projections (plus the QKV bias, before the head reshape), the
    per-head QK RMS norm, then RoPE — in the reference's order.  The head
    counts are the weights': a tensor-parallel rank's ``wq`` / ``wk``
    hold its whole query and KV heads only."""
    B, S, _ = x.shape
    hd = cfg.hd
    H, K = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def init_kv_cache(cfg, batch: int, length: int, *, dtype=None,
                  device=None, n_kv_heads: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Zero ``(batch, length, K, hd)`` k / v caches; ``n_kv_heads`` is a
    tensor-parallel rank's K (default: the config's)."""
    K, hd = n_kv_heads or cfg.n_kv_heads, cfg.hd
    dt = dtype or getattr(torch, cfg.dtype)
    return {"k": torch.zeros(batch, length, K, hd, dtype=dt, device=device),
            "v": torch.zeros(batch, length, K, hd, dtype=dt, device=device)}


def _out(x, out, wo, reduce):
    """``x + out @ wo``: the heads' output projected and added to the
    residual.  Under tensor parallelism ``out`` holds the rank's heads and
    ``wo`` their rows (row-parallel), and ``reduce`` sums the partial
    product over the model axis before the residual, so x is counted
    once."""
    y = out.reshape(*out.shape[:-2], -1) @ wo
    return x + (y if reduce is None else reduce(y))


def apply_attn(p: Dict[str, torch.Tensor], cfg, x, positions, *,
               mode: str = "train", cache: Optional[Dict] = None,
               window: int = 0, cur_len=None,
               xattn_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               reduce: Optional[Callable] = None):
    """Pre-norm causal (or sliding-window) self-attention with residual,
    or the encoder-decoder's cross attention.  ``reduce`` is the
    tensor-parallel sum of the row-parallel ``wo`` product (None: the
    layer's weights are whole).

    mode:
      "train"   — returns y;
      "prefill" — as train, and returns ``(y, cache)`` with the prompt's
                  K/V (the last ``window`` rows rolled so that position p
                  sits at ring row p % window);
      "decode"  — one new token (Sq = 1) written into ``cache`` in place
                  (ring row ``pos % window`` or linear row ``cur_len`` /
                  ``pos``), then attention over it; returns ``(y, cache)``;
      "cross"   — ``q = h @ wq`` over the encoder's ``xattn_kv = (k, v)``
                  (``(B, T, K, hd)``, every row valid: no mask), as the
                  reference's; returns ``(y, cache)``, ``cache`` untouched.
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    win = window or cfg.sliding_window
    B, S = h.shape[:2]
    if mode == "cross":
        q = (h @ p["wq"]).reshape(B, S, -1, cfg.hd)
        k, v = xattn_kv
        out = sdpa_ref(q, k, v, causal=False)
        return _out(x, out, p["wo"], reduce), cache
    if mode in ("train", "prefill"):
        q, k, v = _qkv(p, cfg, h, positions)
        out = sdpa_ref(q, k, v, causal=True, window=win)
        y = _out(x, out, p["wo"], reduce)
        if mode == "train":
            return y
        if win and k.shape[1] > win:
            # keep the last `win` entries, rolled so that the ring row of
            # position p is p % win (the decode layout)
            shift = (S - win) % win
            cache = {"k": torch.roll(k[:, -win:], shift, dims=1),
                     "v": torch.roll(v[:, -win:], shift, dims=1)}
        else:
            cache = {"k": k, "v": v}
        return y, cache
    if mode != "decode" or cache is None:
        raise ValueError(f"attention mode {mode!r} is not one of train, "
                         "prefill, decode (with a cache) or cross")
    # one new token; positions: (B, 1), the same absolute position per row
    q, k_new, v_new = _qkv(p, cfg, h, positions)
    pos = int(positions[0, 0])
    L = cache["k"].shape[1]
    ring = bool(win) and L == win
    if ring:
        slot = pos % win
    else:
        slot = int(cur_len) if cur_len is not None else pos
    slot = min(slot, L - 1)          # dynamic_update_slice clamps its start
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    # in the ring every occupied row lies within the window: plain
    # attention over it, the not yet filled rows masked by kv_len
    n_valid = min(pos + 1, win) if ring else pos + 1
    out = sdpa_ref(q, cache["k"], cache["v"], causal=False, kv_len=n_valid)
    return _out(x, out, p["wo"], reduce), cache


AttnFn = Callable[..., torch.Tensor]


def apply_attn_paged(p: Dict[str, torch.Tensor], cfg, x, positions, *,
                     pools: Dict[str, torch.Tensor], page_table, kv_len,
                     attn_fn: AttnFn, window: int = 0,
                     reduce: Optional[Callable] = None):
    """Paged decode attention sub-block: one token per slot, KV read and
    written through a page table.

    x: (B, 1, d); positions: (B, 1) each slot's absolute position (ragged);
    pools: {"k", "v"} of ONE layer, ``(num_pages, page_size, K, hd)``;
    page_table: (B, n_pages) int32; kv_len: (B,) valid rows including the
    one written here (0 for idle slots, whose writes sink into the null
    page and whose output is junk the engine discards).

    The new row is written into the pools in place FIRST, then attended
    over by ``attn_fn(q (B, K, G, hd), k_pool, v_pool, page_table, kv_len,
    *, page_size) -> (B, K, G, hd)``: :func:`repro_torch.kernels.ops.
    paged_attention` (the kernel) or its plain version
    :func:`repro_torch.kernels.ref.paged_attention_ref`.  K and G are the
    weights' (a tensor-parallel rank's pools hold its KV heads only), and
    ``reduce`` sums the ``wo`` partial over the model axis.
    Returns (y, pools)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k_new, v_new = _qkv(p, cfg, h, positions)
    B = x.shape[0]
    page_size = pools["k"].shape[1]
    pos = positions[:, 0].long()
    row = torch.remainder(pos, window) if window else pos
    pt = page_table.long()
    phys = pt[torch.arange(B, device=pt.device), row // page_size]
    rin = row % page_size
    # idle slots (page-table row all NULL) write into the null page; those
    # duplicate targets collide only with each other, never with a live
    # slot's pages (allocator invariant)
    pools["k"].index_put_((phys, rin), k_new[:, 0])
    pools["v"].index_put_((phys, rin), v_new[:, 0])
    H, K, hd = q.shape[2], k_new.shape[2], cfg.hd
    out = attn_fn(q.reshape(B, K, H // K, hd), pools["k"], pools["v"],
                  page_table, kv_len, page_size=page_size)
    return _out(x, out.reshape(B, 1, H, hd), p["wo"], reduce), pools


def apply_attn_paged_prefill(p: Dict[str, torch.Tensor], cfg, x, *,
                             pools: Dict[str, torch.Tensor], pt_row,
                             chunk_start: int, chunk_len: int,
                             attn_fn: AttnFn, window: int = 0,
                             reduce: Optional[Callable] = None):
    """Chunked-prefill attention sub-block: one C-token chunk of ONE slot's
    prompt attends over the slot's previously filled pages plus itself,
    then is written into the pages.

    x: (1, C, d); pt_row: (n_pages,) the slot's page-table row;
    chunk_start: the absolute position of x[:, 0]; chunk_len: valid rows
    (the last chunk is padded; padded rows are masked out of attention and
    written into page 0, the null page).

    Attention runs BEFORE the write: in ring mode a chunk's rows alias ring
    rows that still hold live earlier keys, so writing first would read
    overwritten values.  ``attn_fn(q, k_chunk, v_chunk, k_pool, v_pool,
    pt_row, chunk_start, chunk_len, *, page_size, window) -> (1, C, H,
    hd)`` is :func:`repro_torch.kernels.ops.paged_prefill_attention` (the
    kernel) or its plain version
    :func:`repro_torch.kernels.ref.paged_prefill_attention_ref`, which is
    :func:`paged_prefill_sdpa`.  The write is in place.  ``reduce`` is
    the tensor-parallel sum, as in :func:`apply_attn_paged`.
    Returns (y (1, C, d), pools)."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    C = x.shape[1]
    dev = x.device
    start, n_live = int(chunk_start), int(chunk_len)
    qpos = start + torch.arange(C, device=dev)
    q, k_new, v_new = _qkv(p, cfg, h, qpos[None])
    page_size = pools["k"].shape[1]
    out = attn_fn(q, k_new, v_new, pools["k"], pools["v"], pt_row, start,
                  n_live, page_size=page_size, window=window)
    # valid rows go to the slot's pages, padded rows to the null page;
    # ring rows are distinct within one chunk since C <= window
    row = torch.remainder(qpos, window) if window else qpos
    live = torch.arange(C, device=dev) < n_live
    # a padded row may lie past the slot's pages: clamp its lookup (JAX's
    # gather clamps out-of-range indices) before sending it to page 0
    pg = (row // page_size).clamp_(max=pt_row.shape[0] - 1)
    phys = torch.where(live, pt_row.long()[pg],
                       torch.zeros((), dtype=torch.long, device=dev))
    rin = row % page_size
    pools["k"].index_put_((phys, rin), k_new[0])
    pools["v"].index_put_((phys, rin), v_new[0])
    return _out(x, out, p["wo"], reduce), pools
