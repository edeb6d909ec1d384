"""Continuous-batching decode scheduler over the paged KV cache: the
counterpart of ``repro/serve/scheduler.py``.

The decode batch is a set of slots: each dispatch decodes every live slot,
finished requests release their pages at once, and arrivals are admitted
the moment a slot and pages are free.

* device — :func:`build_paged_serve_step`: embed → paged attention over
  every layer → greedy head, for the whole slot batch (``max_slots``
  slots, a fixed page-table width);
* host — :class:`ContinuousBatchingEngine`: allocator bookkeeping,
  prefill, eviction on EOS or budget, and the arrival loop.  Per dispatch
  it ships a few small int32 tables to the device and reads back one
  ``(B, 1)`` token array.

Two prefill paths:

* legacy per-request (``prefill_chunk=None``): each request is prefilled
  at its exact prompt length on admission and its dense cache is written
  into its pages; every live decode slot waits meanwhile;
* chunked (``prefill_chunk=C``): prompts are cut into C-token chunks (the
  last one padded and masked) and one mixed dispatch advances every live
  decode slot AND at most one chunk, under a per-dispatch token budget
  (``max_step_tokens``).

``attn_impl`` selects the attention: ``"ref"`` is the plain gather +
``sdpa_ref`` sequence (the exactness anchor), ``"kernel"`` goes through
:func:`repro_torch.kernels.ops.paged_attention` and
:func:`~repro_torch.kernels.ops.paged_prefill_attention`: the CUDA kernels
on the card, their plain versions on the CPU.

``poisson_load`` draws open-loop Poisson arrivals with numpy, so one seed
gives the reference's trace; ``run_fixed_batch`` is the batch-synchronous
baseline.  Serving runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models.api import Model
from .engine import build_serve_step, grow_caches
from .paged_cache import PageAllocator, PagedCacheConfig, init_paged_pools

__all__ = ["Request", "poisson_load", "build_paged_serve_step",
           "ContinuousBatchingEngine", "run_fixed_batch", "summarize"]

# attn_impl -> (paged decode attention, paged prefill attention)
ATTN_FNS = {"ref": (ref.paged_attention_ref, ref.paged_prefill_attention_ref),
            "kernel": (ops.paged_attention, ops.paged_prefill_attention)}
ATTN_IMPLS = tuple(ATTN_FNS)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray          # (S,) int32 prompt ids
    max_new: int                # generation budget incl. the prefill token
    arrival: float              # seconds after load start (open loop)
    eos_id: int = -1            # -1: disabled (random-weight runs)


def poisson_load(n_requests: int, rate: float, *, vocab: int,
                 prompt_buckets=(16, 32), new_token_buckets=(8, 16, 32, 96),
                 prompt_dist: str = "bucket", seed: int = 0,
                 eos_id: int = -1) -> List[Request]:
    """Open-loop Poisson arrivals (exponential gaps at ``rate`` req/s) with
    prompt lengths and generation budgets drawn from small bucket sets.

    ``prompt_dist``: ``"bucket"`` draws prompt lengths uniformly from
    ``prompt_buckets``; ``"exact"`` draws a uniform integer over
    ``[min(prompt_buckets), max(prompt_buckets)]``, a length continuum.
    The draws are the reference's, call for call."""
    if prompt_dist not in ("bucket", "exact"):
        raise ValueError(f"prompt_dist {prompt_dist!r} not in "
                         "('bucket', 'exact')")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    lo, hi = min(prompt_buckets), max(prompt_buckets)
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        if prompt_dist == "bucket":
            S = int(rng.choice(prompt_buckets))
        else:
            S = int(rng.integers(lo, hi + 1))
        out.append(Request(
            rid=rid,
            tokens=rng.integers(0, vocab, (S,)).astype(np.int32),
            max_new=int(rng.choice(new_token_buckets)),
            arrival=t, eos_id=eos_id))
    return out


def build_paged_serve_step(model: Model, *, attn_impl: str = "ref",
                           mixed: bool = False) -> Callable:
    """``step(params, pools, token, positions, page_table, kv_len)`` →
    ``(next_token (B, 1), pools)``: one dispatch decodes the whole slot
    batch through the paged cache (greedy head).

    ``mixed=True`` builds the chunked-prefill step ``step(params, pools,
    token, positions, page_table, kv_len, chunk_tokens, pt_row,
    chunk_start, chunk_len)`` → ``(next_token (B, 1), chunk_next (C,),
    pools)``: the decode batch plus one prompt chunk of one slot in one
    walk over the layers.  ``chunk_next[i]`` is the greedy token after
    chunk position i; rows past ``chunk_len`` are padding.

    ``attn_impl`` picks the attention from :data:`ATTN_FNS`: the plain
    versions (``"ref"``) or the kernels' device dispatch (``"kernel"``)."""
    if attn_impl not in ATTN_FNS:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    attn_fn, prefill_attn_fn = ATTN_FNS[attn_impl]

    if not mixed:
        def step(params, pools, token, positions, page_table, kv_len):
            logits, pools = model.decode_step_paged(
                params, pools, token, positions, page_table, kv_len,
                attn_fn=attn_fn)
            nxt = torch.argmax(logits[:, -1].float(), dim=-1)
            return nxt.to(torch.int32)[:, None], pools

        return step

    def mixed_step(params, pools, token, positions, page_table, kv_len,
                   chunk_tokens, pt_row, chunk_start, chunk_len):
        d_logits, c_logits, pools = model.decode_step_mixed(
            params, pools, token, positions, page_table, kv_len,
            chunk_tokens, pt_row, chunk_start, chunk_len,
            attn_fn=attn_fn, prefill_attn_fn=prefill_attn_fn)
        nxt = torch.argmax(d_logits[:, -1].float(), dim=-1)
        cn = torch.argmax(c_logits[0].float(), dim=-1)
        return nxt.to(torch.int32)[:, None], cn.to(torch.int32), pools

    return mixed_step


@dataclasses.dataclass
class _Live:
    req: Request
    slot: int
    emitted: List[int]
    t_last: float               # emission time of the latest token


@dataclasses.dataclass
class _Fill:
    """A slot mid-chunked-prefill: admitted (pages reserved), its prompt
    being written one chunk per mixed dispatch, no token emitted yet."""
    req: Request
    slot: int


class ContinuousBatchingEngine:
    """Slot-based continuous batching: admit on free pages, decode every
    live slot per dispatch, evict on EOS or budget.

    Greedy decoding on ``attn_impl="ref"`` is token-exact against the
    dense :func:`repro_torch.serve.engine.greedy_generate`: the same q/k/v
    values flow through the same ``sdpa_ref`` ops, and page-padding
    columns get exactly zero weight.  ``prefill_chunk=C`` switches to
    chunked prefill: admission only reserves a slot and pages, then each
    dispatch runs the mixed step, every live decode slot plus at most one
    C-token chunk of the oldest mid-prefill slot, capped by
    ``max_step_tokens`` (chunk tokens + decode tokens per dispatch).

    ``compile_count`` keeps the reference's metric key.  The port compiles
    nothing per shape (no ``jit``), so it counts the step callables the
    engine builds: the decode-only and the mixed step on first use (2 on
    the chunked path), and on the legacy path the distinct prompt lengths
    (prefill) and page counts (page scatter) it has served, the shapes
    the reference compiles for.  It survives ``reset()``.  ``mixed_steps``
    counts the dispatches that carried a prefill chunk (each launches the
    prefill kernel once per layer); the run's metrics report it beside
    ``steps``.

    ``device`` follows :func:`repro_torch.device.resolve_device`: ``None``
    means ``cuda`` and raises without a GPU; the CPU must be asked for.
    The page pools live there and are written in place.

    A model built on a tensor-parallel grid (``build_model(cfg,
    mesh=grid)``) is served with the rank's blocks of the params
    (:func:`repro_torch.core.sharding.shard_params` or ``init_lm_rank``);
    the pools hold the rank's ``K / M`` KV heads (the reference's
    ``paged_pool_specs``).  Every rank runs this same host schedule and
    allocator on its own pools, and the dispatches' logits are gathered
    over the model axis, so every rank emits the same tokens; the ranks
    must see the same requests at the same times (a closed batch).
    """

    def __init__(self, model: Model, params, pcfg: PagedCacheConfig, *,
                 attn_impl: str = "ref", prefill_chunk: Optional[int] = None,
                 max_step_tokens: Optional[int] = None, device=None):
        if model.decode_step_paged is None:
            raise NotImplementedError(
                f"the {model.cfg.family} family has no paged decode path, "
                "as in the reference: serve its fixed batch through "
                "greedy_generate (the serve CLI without "
                "--continuous-batching)")
        if model.decode_window != pcfg.window:
            raise ValueError(f"model window {model.decode_window} != cache "
                             f"window {pcfg.window}")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk {prefill_chunk} < 1")
            # ring writes put chunk rows at position % window: a chunk
            # wider than the ring would collide with itself
            if pcfg.window and prefill_chunk > pcfg.window:
                raise ValueError(f"prefill_chunk {prefill_chunk} > window "
                                 f"{pcfg.window}")
        if max_step_tokens is not None and max_step_tokens < 1:
            raise ValueError(f"max_step_tokens {max_step_tokens} < 1")
        self.device = resolve_device(device)
        self.model, self.pcfg = model, pcfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.pools = init_paged_pools(model.cfg, pcfg, self.device,
                                      model.kv_heads)
        self.prefill_chunk = prefill_chunk
        self.max_step_tokens = max_step_tokens
        self.compile_count = 0
        self._shapes = set()        # legacy path: (kind, length) served
        self._step = None           # decode-only step, built on first use
        self._mixed = None          # mixed step, built on first use
        self._attn_impl = attn_impl
        self.reset()

    def reset(self) -> None:
        """Fresh serving state (allocator, slots, metrics); the built step
        callables and ``compile_count`` are kept.  Pools keep stale pages:
        every page is written before ``kv_len`` exposes it."""
        pcfg = self.pcfg
        self.alloc = PageAllocator(pcfg)
        self.tok = np.zeros((pcfg.max_slots, 1), np.int32)
        self.live: Dict[int, _Live] = {}          # slot -> decoding state
        self._filling: List[_Fill] = []           # FIFO of mid-prefill slots
        self.completed: Dict[int, np.ndarray] = {}  # rid -> generated ids
        self.latencies: List[float] = []          # per emitted token (s)
        self.ttfts: List[float] = []              # arrival -> first token (s)
        self.queue_waits: List[float] = []        # arrival -> admission (s)
        self.steps = 0
        self.mixed_steps = 0                      # dispatches with a chunk
        self._t0 = time.perf_counter()            # run() resets it

    # -- built callables ----------------------------------------------------

    def _count_shape(self, key) -> None:
        """Count a legacy-path shape (prompt length, page count) the first
        time it is served."""
        if key not in self._shapes:
            self._shapes.add(key)
            self.compile_count += 1

    def _decode_step(self) -> Callable:
        if self._step is None:
            self._step = build_paged_serve_step(
                self.model, attn_impl=self._attn_impl)
            self.compile_count += 1
        return self._step

    def _mixed_step(self) -> Callable:
        if self._mixed is None:
            self._mixed = build_paged_serve_step(
                self.model, attn_impl=self._attn_impl, mixed=True)
            self.compile_count += 1
        return self._mixed

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    @staticmethod
    def _scatter(pools, caches, pages: torch.Tensor):
        """Write one request's dense prefill cache into its pages, in
        place.  caches leaf: (n_blocks, 1, L, K, hd); pages: (n_used,)
        physical ids.  Logical row r lands at row ``r % page_size`` of page
        ``pages[r // page_size]``; a ring cache (L == window) maps through
        unchanged."""
        n_used = pages.shape[0]
        for pool, cache in zip(pools, caches):
            for name in ("k", "v"):
                c = cache[name]
                n_blocks, _, L, K, hd = c.shape
                ps = pool[name].shape[2]
                rows = F.pad(c[:, 0], (0, 0, 0, 0, 0, n_used * ps - L))
                pool[name][:, pages] = rows.reshape(n_blocks, n_used, ps, K,
                                                    hd)
        return pools

    # -- admission / eviction -----------------------------------------------

    @torch.inference_mode()
    def try_admit(self, req: Request) -> bool:
        """Admit if a slot and enough pages are free.

        Legacy path: prefill + page scatter, emitting the request's first
        token before returning.  Chunked path: reservation only; the
        dispatch that completes the last chunk emits the first token."""
        S = int(req.tokens.shape[0])
        # rows the slot will hold: the prompt and every fed-back token (the
        # last emitted token is never fed)
        ctx = S + req.max_new - 1
        if not self.alloc.can_admit(ctx):
            return False
        now = time.perf_counter()
        self.queue_waits.append(now - (self._t0 + req.arrival))
        if self.prefill_chunk is not None:
            slot = self.alloc.admit(ctx, S, chunked=True)
            self._filling.append(_Fill(req=req, slot=slot))
            return True
        slot = self.alloc.admit(ctx, S)
        logits, caches = self.model.prefill(
            self.params, {"tokens": self._dev(req.tokens[None])})
        n_used = self.alloc.pages_needed(ctx)
        self._count_shape(("prefill", S))
        self._count_shape(("scatter", n_used))
        pages = self._dev(self.alloc.page_table[slot, :n_used]).long()
        self.pools = self._scatter(self.pools, caches, pages)
        tok0 = int(torch.argmax(logits[0, -1].float()))
        now = time.perf_counter()
        st = _Live(req=req, slot=slot, emitted=[tok0], t_last=now)
        # TTFT of token 1 (queue wait + prefill), on the absolute clock
        ttft = now - (self._t0 + req.arrival)
        self.latencies.append(ttft)
        self.ttfts.append(ttft)
        if req.max_new == 1 or tok0 == req.eos_id:
            self._finish(st)
        else:
            self.tok[slot, 0] = tok0
            self.live[slot] = st
        return True

    def _finish(self, st: _Live) -> None:
        self.completed[st.req.rid] = np.asarray(st.emitted, np.int32)
        self.alloc.release(st.slot)
        self.tok[st.slot, 0] = 0
        self.live.pop(st.slot, None)

    # -- decode -------------------------------------------------------------

    def _decode_inputs(self):
        """(positions, page_table, kv_len) for the decode half of a
        dispatch, on the device.  Mid-prefill slots are masked out: kv_len
        0 and a null page-table row (see ``PageAllocator.decode_tables``)."""
        lens = self.alloc.lengths
        decoding = self.alloc.active & ~self.alloc.prefilling
        kv = np.where(decoding, lens + 1, 0).astype(np.int32)
        if self.pcfg.window:
            kv = np.minimum(kv, self.pcfg.window).astype(np.int32)
        pt, _ = self.alloc.decode_tables()
        return self._dev(lens), self._dev(pt), self._dev(kv)

    def _next_chunk(self):
        """The chunk of this dispatch: up to ``prefill_chunk`` tokens of the
        oldest mid-prefill slot, shrunk to the token budget
        (``max_step_tokens`` − live decode slots).  None (decode-only
        step) when there is no prefill work or no budget."""
        if not self._filling:
            return None
        C = self.prefill_chunk
        n_tok = C
        if self.max_step_tokens is not None:
            n_tok = min(n_tok, self.max_step_tokens - len(self.live))
        fill = self._filling[0]
        cur = int(self.alloc.prefill_cursor[fill.slot])
        n_tok = min(n_tok, int(fill.req.tokens.shape[0]) - cur)
        if n_tok <= 0:
            return None
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n_tok] = fill.req.tokens[cur:cur + n_tok]
        return fill, cur, n_tok, chunk

    @torch.inference_mode()
    def step(self) -> None:
        """One batched dispatch: every live decode slot advances one token;
        in chunked mode one prefill chunk rides along (mixed step)."""
        positions, pt, kv = self._decode_inputs()
        work = self._next_chunk() if self.prefill_chunk is not None else None
        token = self._dev(self.tok)
        if work is None:
            nxt, self.pools = self._decode_step()(
                self.params, self.pools, token, positions, pt, kv)
        else:
            fill, cur, n_tok, chunk = work
            pt_row = self._dev(self.alloc.page_table[fill.slot])
            nxt, chunk_next, self.pools = self._mixed_step()(
                self.params, self.pools, token, positions, pt, kv,
                self._dev(chunk), pt_row, cur, n_tok)
        nxt = nxt.cpu().numpy()
        now = time.perf_counter()
        self.steps += 1
        joined = -1                       # slot that turned live this step
        if work is not None:
            self.mixed_steps += 1
            self.alloc.advance_prefill(fill.slot, n_tok)
            if not self.alloc.prefilling[fill.slot]:
                # final chunk: emit the first token (argmax after the last
                # real prompt position; rows >= n_tok are padding)
                self._filling.pop(0)
                tok0 = int(chunk_next[n_tok - 1])
                st = _Live(req=fill.req, slot=fill.slot, emitted=[tok0],
                           t_last=now)
                ttft = now - (self._t0 + fill.req.arrival)
                self.latencies.append(ttft)
                self.ttfts.append(ttft)
                if fill.req.max_new == 1 or tok0 == fill.req.eos_id:
                    self._finish(st)
                else:
                    self.tok[fill.slot, 0] = tok0
                    self.live[fill.slot] = st
                    joined = fill.slot
        for slot in list(self.live):
            if slot == joined:
                continue          # this slot's first decode is next step
            st = self.live[slot]
            self.alloc.advance(slot)
            tok = int(nxt[slot, 0])
            st.emitted.append(tok)
            self.latencies.append(now - st.t_last)
            st.t_last = now
            if len(st.emitted) >= st.req.max_new or tok == st.req.eos_id:
                self._finish(st)
            else:
                self.tok[slot, 0] = tok

    # -- arrival loop -------------------------------------------------------

    def run(self, requests: List[Request]) -> Dict[str, Any]:
        """Drive the open-loop arrival trace to completion; returns
        :func:`summarize` metrics."""
        pending = sorted(requests, key=lambda r: r.arrival)
        self._t0 = time.perf_counter()
        i = 0
        while i < len(pending) or self.live or self._filling:
            now = time.perf_counter() - self._t0
            while i < len(pending) and pending[i].arrival <= now:
                if not self.try_admit(pending[i]):
                    break                      # no slot or pages: decode
                i += 1
            if self.live or self._filling:
                self.step()
            elif i < len(pending):
                time.sleep(min(1e-3, max(0.0, pending[i].arrival - now)))
        wall = time.perf_counter() - self._t0
        return summarize(self.completed, self.latencies, wall,
                         steps=self.steps, ttfts=self.ttfts,
                         queue_waits=self.queue_waits,
                         compile_count=self.compile_count,
                         mixed_steps=self.mixed_steps)


def _pctls(vals, prefix: str) -> Dict[str, Any]:
    v = np.asarray(vals, np.float64) * 1e3
    return {
        f"{prefix}_p50_ms": round(float(np.percentile(v, 50)), 3)
        if len(v) else None,
        f"{prefix}_p99_ms": round(float(np.percentile(v, 99)), 3)
        if len(v) else None,
    }


def summarize(completed: Dict[int, np.ndarray], latencies: List[float],
              wall: float, *, steps: int,
              ttfts: Optional[List[float]] = None,
              queue_waits: Optional[List[float]] = None,
              compile_count: Optional[int] = None,
              mixed_steps: Optional[int] = None) -> Dict[str, Any]:
    """Serving metrics, under the reference's keys, plus ``mixed_steps``
    where given.  ``latencies`` are per emitted token (TTFT for a
    request's first token, the inter-token gap after); ``ttfts`` /
    ``queue_waits`` are per request."""
    total = int(sum(len(v) for v in completed.values()))
    lat = np.asarray(latencies) * 1e3
    out = {
        "requests": len(completed),
        "tokens": total,
        "wall_s": round(wall, 4),
        "tokens_per_s": round(total / wall, 2) if wall else float("inf"),
        "steps": steps,
        "p50_ms": round(float(np.percentile(lat, 50)), 3) if len(lat) else None,
        "p99_ms": round(float(np.percentile(lat, 99)), 3) if len(lat) else None,
    }
    if ttfts is not None:
        out.update(_pctls(ttfts, "ttft"))
    if queue_waits is not None:
        out.update(_pctls(queue_waits, "queue"))
    if compile_count is not None:
        out["compile_count"] = compile_count
    if mixed_steps is not None:
        out["mixed_steps"] = mixed_steps
    return out


@torch.inference_mode()
def run_fixed_batch(model: Model, params, requests: List[Request], *,
                    batch_size: int, prompt_pad: Optional[int] = None,
                    device=None) -> Dict[str, Any]:
    """Batch-synchronous baseline, instrumented per token.

    Requests are cut in arrival order into fixed batches: each waits for
    its last arrival, prompts are right-padded to ``prompt_pad`` (default:
    the longest prompt of the trace), and the whole batch decodes
    ``max(max_new)`` steps.  Only each request's own budget counts toward
    throughput."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    if prompt_pad is None:
        prompt_pad = max(int(r.tokens.shape[0]) for r in requests)
    step = build_serve_step(model)
    reqs = sorted(requests, key=lambda r: r.arrival)
    completed: Dict[int, np.ndarray] = {}
    latencies: List[float] = []
    ttfts: List[float] = []
    queue_waits: List[float] = []
    steps = 0
    t0 = time.perf_counter()
    for c0 in range(0, len(reqs), batch_size):
        chunk = reqs[c0:c0 + batch_size]
        barrier = max(r.arrival for r in chunk)
        while time.perf_counter() - t0 < barrier:
            time.sleep(1e-3)
        now = time.perf_counter()
        for r in chunk:
            queue_waits.append(now - (t0 + r.arrival))
        toks = np.zeros((len(chunk), prompt_pad), np.int32)
        for j, r in enumerate(chunk):
            toks[j, :r.tokens.shape[0]] = r.tokens
        n_steps = max(r.max_new for r in chunk)
        logits, caches = model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(dev)})
        caches = grow_caches(model, caches, len(chunk),
                             model.decode_window or prompt_pad + n_steps)
        tok = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        emitted = [tok.cpu().numpy()[:, 0]]
        now = time.perf_counter()
        t_last = [now] * len(chunk)
        for r in chunk:
            ttft = now - (t0 + r.arrival)
            latencies.append(ttft)
            ttfts.append(ttft)
        steps += 1
        for s in range(n_steps - 1):
            tok, caches = step(params, caches, tok, prompt_pad + s)
            emitted.append(tok.cpu().numpy()[:, 0])
            now = time.perf_counter()
            steps += 1
            for j, r in enumerate(chunk):
                if s + 2 <= r.max_new:      # token s+2 is within budget
                    latencies.append(now - t_last[j])
                    t_last[j] = now
        gen = np.stack(emitted, axis=1)      # (chunk, n_steps)
        for j, r in enumerate(chunk):
            completed[r.rid] = gen[j, :r.max_new]
    wall = time.perf_counter() - t0
    return summarize(completed, latencies, wall, steps=steps, ttfts=ttfts,
                     queue_waits=queue_waits)
