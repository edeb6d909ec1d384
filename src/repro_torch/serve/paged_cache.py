"""Paged KV cache for the continuous-batching engine: the counterpart of
``repro/serve/paged_cache.py``.

KV storage is a page pool per attention layer: fixed-size pages of
``page_size`` token rows, a per-slot page table mapping each slot's
logical page to a physical page, and a host-side free-list allocator.

Layout contract (as in the reference):

* a page holds ``page_size`` token rows of ``(K, hd)`` each; ``page_size``
  is a multiple of 8 rows;
* physical page 0 is the null page: the allocator never hands it out,
  free slots' page-table rows are all zero, and idle slots' decode writes
  land there, so a write by a dead slot never corrupts a live one;
* ring mode (``window > 0``): a slot owns exactly ``window / page_size``
  pages and position p lives at ring row ``p % window``.

The pools are torch tensors on the engine's device, shaped like the
model's stacked cache tree, ``(n_blocks, num_pages, page_size, K, hd)`` per
period position; the allocator is numpy, line for line the reference's.
Under tensor parallelism a rank's pools hold its ``K / M`` KV heads
(:func:`paged_pool_specs`: the heads over ``model``); the page gather is
slot-local, so the pools need no collective, and every rank runs the same
allocator on its own pools.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, block_period, layer_kinds

__all__ = ["PagedCacheConfig", "PageAllocator", "init_paged_pools",
           "paged_pool_shapes", "paged_pool_specs", "NULL_PAGE"]

NULL_PAGE = 0          # reserved physical page: write sink for idle slots
_SUBLANE = 8           # token rows per page come in multiples of 8


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static geometry of the paged cache.

    ``max_context`` is the per-slot context ceiling (prompt + generated);
    ring mode caps it at ``window``.  ``num_pages`` counts physical pages
    including the reserved null page."""

    page_size: int
    num_pages: int
    max_slots: int
    max_context: int
    window: int = 0                 # 0 = linear; else a ring of `window` rows

    def __post_init__(self):
        if self.page_size <= 0 or self.page_size % _SUBLANE:
            raise ValueError(f"page_size must be a positive multiple of "
                             f"{_SUBLANE} rows, got {self.page_size}")
        if self.window and self.window % self.page_size:
            raise ValueError(
                "ring mode needs window % page_size == 0 so a slot owns "
                f"whole pages, got window={self.window} "
                f"page_size={self.page_size}")
        if self.num_pages <= 1 + self.pages_per_slot:
            raise ValueError(
                "page pool too small for even one slot (num_pages="
                f"{self.num_pages}, need {1 + self.pages_per_slot}+)")

    @property
    def slot_context(self) -> int:
        """Rows of KV a slot can hold: the ring size in window mode, the
        context ceiling otherwise."""
        return self.window if self.window else self.max_context

    @property
    def pages_per_slot(self) -> int:
        """Width of one page-table row (logical pages per slot)."""
        return -(-self.slot_context // self.page_size)


def paged_pool_shapes(cfg: ModelConfig, pcfg: PagedCacheConfig,
                      n_kv_heads: Optional[int] = None
                      ) -> Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]:
    """(shape, dtype) of each period position's k and v pools, mirroring
    the model's stacked cache tree, ``n_kv_heads`` KV heads a pool (a
    tensor-parallel rank's; default the config's).  Attention mixers
    only."""
    period = block_period(cfg)
    kinds = layer_kinds(cfg)[:period]
    n_blocks = cfg.n_layers // period
    if any(mixer != "attn" for mixer, _ in kinds):
        raise NotImplementedError("paged pools cover attention mixers only")
    shape = (n_blocks, pcfg.num_pages, pcfg.page_size,
             n_kv_heads or cfg.n_kv_heads, cfg.hd)
    return tuple((shape, getattr(torch, cfg.dtype)) for _ in kinds)


def init_paged_pools(cfg: ModelConfig, pcfg: PagedCacheConfig, device,
                     n_kv_heads: Optional[int] = None) -> Tuple[dict, ...]:
    """Zero-filled page pools on ``device``: a tuple over period positions
    of ``{"k", "v"}`` (``n_kv_heads``: see :func:`paged_pool_shapes`)."""
    return tuple({name: torch.zeros(shape, dtype=dt, device=device)
                  for name in ("k", "v")}
                 for shape, dt in paged_pool_shapes(cfg, pcfg, n_kv_heads))


def paged_pool_specs(cfg: ModelConfig):
    """The reference's ``paged_pool_specs``: the pools' KV heads over
    ``model``, pages unsplit (the page gather is slot-local, so the paged
    decode step needs no collective for its pools), one ``{"k", "v"}``
    a period position.  A family with SSM mixers (paged pools cover
    attention only) or the encoder-decoder family raises
    ``NotImplementedError``."""
    from repro_torch.core.sharding import P
    from repro_torch.models.transformer import lm_cache_specs
    if any("h" in c for c in lm_cache_specs(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: paged pools cover attention mixers only (an SSM "
            "layer's state is fixed-size: serve it through greedy_generate)")
    spec = {"k": P(None, None, None, "model", None),
            "v": P(None, None, None, "model", None)}
    return tuple(dict(spec) for _ in range(block_period(cfg)))


class PageAllocator:
    """Host-side page-table bookkeeping: free-list page allocation and slot
    admit / release, in numpy.  The engine calls it between dispatches and
    ships ``page_table`` / ``lengths`` to the device once per step.

    Invariants (checked; a breach raises ``RuntimeError``, a bad request
    ``ValueError``):

    * physical page ``NULL_PAGE`` is never allocated;
    * a live slot's pages are disjoint from every other live slot's;
    * free slots' page-table rows are all ``NULL_PAGE`` and their length 0;
    * chunked-prefill slots: ``prefill_cursor`` counts prompt rows already
      written, ``lengths == prefill_cursor`` while ``prefilling``, and
      ``prefill_cursor <= prompt_len``; all pages are reserved at
      admission, so a mid-prefill slot never runs out of pages."""

    def __init__(self, pcfg: PagedCacheConfig):
        self.cfg = pcfg
        self.free_pages: List[int] = list(range(pcfg.num_pages - 1, 0, -1))
        self.free_slots: List[int] = list(range(pcfg.max_slots - 1, -1, -1))
        self.page_table = np.zeros((pcfg.max_slots, pcfg.pages_per_slot),
                                   np.int32)
        self.lengths = np.zeros((pcfg.max_slots,), np.int32)
        self.active = np.zeros((pcfg.max_slots,), bool)
        self.prompt_len = np.zeros((pcfg.max_slots,), np.int32)
        self.prefill_cursor = np.zeros((pcfg.max_slots,), np.int32)
        self.prefilling = np.zeros((pcfg.max_slots,), bool)

    # -- capacity queries ---------------------------------------------------

    def pages_needed(self, context_len: int) -> int:
        """Pages a slot with ``context_len`` total rows needs: the whole
        ring in window mode."""
        ctx = min(context_len, self.cfg.slot_context)
        if self.cfg.window:
            return self.cfg.pages_per_slot
        return -(-ctx // self.cfg.page_size)

    def can_admit(self, context_len: int) -> bool:
        return (bool(self.free_slots)
                and self.pages_needed(context_len) <= len(self.free_pages))

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def pages_in_use(self) -> int:
        return (self.cfg.num_pages - 1) - len(self.free_pages)

    # -- admit / advance / release -----------------------------------------

    def admit(self, context_len: int, prompt_len: int, *,
              chunked: bool = False) -> int:
        """Reserve a slot and every page a request whose context will reach
        ``context_len`` rows needs.  Returns the slot id.

        ``chunked=True`` admits for chunked prefill: the slot starts with
        zero written rows and a prefill cursor that
        :meth:`advance_prefill` walks to ``prompt_len``; ``chunked=False``
        is the per-request prefill path, where all ``prompt_len`` rows are
        written on admission."""
        if not context_len >= prompt_len > 0:
            raise ValueError(f"need context_len >= prompt_len > 0, got "
                             f"{context_len}, {prompt_len}")
        if not self.cfg.window and context_len > self.cfg.max_context:
            raise ValueError(f"context {context_len} > max_context "
                             f"{self.cfg.max_context}")
        if not self.can_admit(context_len):
            raise RuntimeError(
                f"admit() without can_admit(): {len(self.free_slots)} "
                f"slots, {len(self.free_pages)} pages free")
        slot = self.free_slots.pop()
        n = self.pages_needed(context_len)
        pages = [self.free_pages.pop() for _ in range(n)]
        row = np.full((self.cfg.pages_per_slot,), NULL_PAGE, np.int32)
        row[:n] = pages
        self.page_table[slot] = row
        self.prompt_len[slot] = prompt_len
        self.prefill_cursor[slot] = 0 if chunked else prompt_len
        self.prefilling[slot] = chunked
        self.lengths[slot] = 0 if chunked else prompt_len
        self.active[slot] = True
        return slot

    def advance(self, slot: int, n: int = 1) -> None:
        """Account ``n`` decoded rows on ``slot``.  ``lengths`` is the true
        absolute length even in ring mode (the ring write row is
        ``length % window``; RoPE needs the absolute position)."""
        if not self.active[slot]:
            raise RuntimeError(f"advance of inactive slot {slot}")
        if self.prefilling[slot]:
            raise RuntimeError(f"decode advance on mid-prefill slot {slot}")
        self.lengths[slot] = int(self.lengths[slot]) + n
        if not self.cfg.window and self.lengths[slot] > self.cfg.max_context:
            raise RuntimeError(f"slot {slot} grew to {self.lengths[slot]} "
                               f"rows > max_context {self.cfg.max_context}")

    def advance_prefill(self, slot: int, n: int) -> None:
        """Account ``n`` prompt rows written by a prefill chunk; the slot
        leaves ``prefilling`` exactly when the cursor reaches its prompt
        length."""
        if not (self.active[slot] and self.prefilling[slot]):
            raise RuntimeError(f"prefill advance on slot {slot}, which is "
                               "not mid-prefill")
        if n < 1:
            raise ValueError(f"prefill advance by {n} rows")
        cur = int(self.prefill_cursor[slot]) + n
        if cur > self.prompt_len[slot]:
            raise ValueError(f"slot {slot}: cursor {cur} past prompt length "
                             f"{int(self.prompt_len[slot])}")
        self.prefill_cursor[slot] = cur
        self.lengths[slot] = cur
        if cur == self.prompt_len[slot]:
            self.prefilling[slot] = False

    def release(self, slot: int) -> None:
        """Evict: return the slot's pages to the free list and zero its
        page-table row."""
        if not self.active[slot]:
            raise RuntimeError(f"release of inactive slot {slot}")
        for p in self.page_table[slot]:
            if p != NULL_PAGE:
                self.free_pages.append(int(p))
        self.page_table[slot] = NULL_PAGE
        self.lengths[slot] = 0
        self.prompt_len[slot] = 0
        self.prefill_cursor[slot] = 0
        self.prefilling[slot] = False
        self.active[slot] = False
        self.free_slots.append(slot)

    # -- tables for the device ----------------------------------------------

    def decode_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """(page_table, lengths) for the decode half of a dispatch, with
        mid-prefill slots' rows masked to the null page: in ring mode their
        decode write row ``length % window`` aliases a live ring row once
        the ring is full, so the mask is needed for correctness."""
        pt = self.page_table.copy()
        pt[self.prefilling] = NULL_PAGE
        return pt, self.lengths.copy()
