"""Decoder LM of the dense family: the counterpart of
``repro/models/transformer.py`` (``init_lm``, ``lm_loss``).

Parameters are a flat dict keyed by the JAX tree's ``|``-joined paths.  As
in JAX, the layers at one position of the block period share stacked
leaves of leading dim ``n_blocks`` (``blocks|<pi>|attn|wq`` is
``(n_blocks, d, H·hd)``); the forward pass walks the stack in a Python loop
where JAX scans it.  The MoE, SSM, hybrid, encoder-decoder and VLM
families are not ported yet (ROADMAP.md).

Serving (the counterparts of ``lm_prefill``, ``lm_decode_step`` and the
paged entries): caches and page pools keep the JAX layout, a tuple over
period positions of ``{"k", "v"}`` leaves with leading ``n_blocks``
(``pools[pi]["k"][b]`` is layer ``b·period + pi``'s
``(num_pages, page_size, K, hd)`` pool), and are written in place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, block_period, layer_kinds
from .attention import (apply_attn, apply_attn_paged,
                        apply_attn_paged_prefill, init_kv_cache)
from .layers import apply_dense_ffn, rms_norm

__all__ = ["param_specs", "param_meta", "init_lm", "lm_loss",
           "init_lm_cache", "lm_prefill", "lm_decode_step",
           "lm_decode_step_paged", "lm_prefill_chunk_paged",
           "lm_serve_step_mixed"]

# (shape, dtype, fan_in); fan_in None marks a zero-initialised norm weight
Spec = Tuple[Tuple[int, ...], torch.dtype, object]


def _check_dense(cfg: ModelConfig):
    kinds = layer_kinds(cfg)[:block_period(cfg)]
    if any(k != ("attn", "dense") for k in kinds) or cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port runs "
            "the dense family (ROADMAP.md)")
    if cfg.qkv_bias or cfg.qk_norm or not cfg.mlp_gated:
        raise NotImplementedError(
            "QKV bias, QK norm and ungated MLPs are not ported yet "
            "(ROADMAP.md)")
    return kinds


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every parameter's shape, dtype and init fan-in, keyed by path."""
    _check_dense(cfg)
    period = block_period(cfg)
    nb = cfg.n_layers // period
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ff = cfg.dense_d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, Spec] = {
        "embed": ((cfg.vocab_size, d), dt, d),
        "final_ln": ((d,), dt, None),
        "lm_head": ((d, cfg.vocab_size), dt, d),
    }
    for pi in range(period):
        a, f = f"blocks|{pi}|attn|", f"blocks|{pi}|ffn|"
        specs.update({
            a + "ln": ((nb, d), dt, None),
            a + "wq": ((nb, d, H * hd), dt, d),
            a + "wk": ((nb, d, K * hd), dt, d),
            a + "wv": ((nb, d, K * hd), dt, d),
            a + "wo": ((nb, H * hd, d), dt, H * hd),
            f + "ln": ((nb, d), dt, None),
            f + "w_gate": ((nb, d, ff), dt, d),
            f + "w_up": ((nb, d, ff), dt, d),
            f + "w_down": ((nb, ff, d), dt, ff),
        })
    return specs


def param_meta(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Shape-only (``meta`` device) parameter dict: no allocation."""
    return {p: torch.empty(s, dtype=dt, device="meta")
            for p, (s, dt, _) in param_specs(cfg).items()}


# Φ(±2) of the standard normal: the truncation bounds of the JAX init
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling)."""
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(2.0 * _LO - 1.0, 2.0 * _HI - 1.0, generator=generator)
    return (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_lm(cfg: ModelConfig, generator: torch.Generator
            ) -> Dict[str, torch.Tensor]:
    """Random parameters on ``generator.device``: truncated-normal fan-in
    init (std = 1/√fan_in) for matrices, zeros for norm weights — the JAX
    package's scheme, drawn from a ``torch.Generator`` (so the values
    differ from ``jax.random``'s; tests carry weights across instead)."""
    params = {}
    specs = param_specs(cfg)
    for path in sorted(specs):
        shape, dt, fan_in = specs[path]
        if fan_in is None:
            params[path] = torch.zeros(shape, dtype=dt,
                                       device=generator.device)
        else:
            w = _trunc_normal(shape, generator) * (1.0 / math.sqrt(fan_in))
            params[path] = w.to(dt)
    return params


def _layers(cfg: ModelConfig, params: Dict[str, torch.Tensor]
            ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Per-layer ``{"attn": {...}, "ffn": {...}}`` views of the stacked
    leaves.  ``unbind`` keeps one autograd node per stacked leaf, whose
    backward stacks the per-layer gradients."""
    period = block_period(cfg)
    nb = cfg.n_layers // period
    layers: List[Dict[str, Dict[str, torch.Tensor]]] = [
        {"attn": {}, "ffn": {}} for _ in range(cfg.n_layers)]
    for path, leaf in params.items():
        parts = path.split("|")
        if parts[0] != "blocks":
            continue
        pi, sub, name = int(parts[1]), parts[2], parts[3]
        for b, w in enumerate(leaf.unbind(0)):
            layers[b * period + pi][sub][name] = w
    assert len(layers) == nb * period
    return layers


def lm_loss(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy of one agent.  batch: {tokens (B, S)}; the
    loss predicts tokens[1:] from the prefix, f32 logits through
    ``logsumexp``."""
    _check_dense(cfg)
    tokens = batch["tokens"].long()
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for lp in _layers(cfg, params):
        x = apply_attn(lp["attn"], cfg, x, positions)
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).float()
    pred = logits[:, :-1]
    tgt = tokens[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = pred.gather(-1, tgt[..., None])[..., 0]
    return (logz - gold).mean()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, params, x) -> torch.Tensor:
    return rms_norm(x, params["final_ln"], cfg.norm_eps) @ params["lm_head"]


def _stack_index(cfg: ModelConfig):
    """(layer, block b, period position pi) for every layer, in order."""
    period = block_period(cfg)
    return [(li, li // period, li % period) for li in range(cfg.n_layers)]


def init_lm_cache(cfg: ModelConfig, batch: int, length: int, *,
                  device=None) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Zero KV caches: a tuple over period positions of stacked
    ``(n_blocks, batch, length, K, hd)`` leaves (``device="meta"`` gives
    the shapes without allocating)."""
    _check_dense(cfg)
    nb = cfg.n_layers // block_period(cfg)
    out = []
    for _ in range(block_period(cfg)):
        one = init_kv_cache(cfg, batch, length, device=device)
        out.append({k: v[None].expand(nb, *v.shape).contiguous()
                    for k, v in one.items()})
    return tuple(out)


def lm_prefill(cfg: ModelConfig, params, tokens, *, window: int = 0):
    """Full-sequence forward returning (last-token logits (B, 1, V), kv
    caches); with ``window`` each cache holds the last ``window`` rows in
    ring order."""
    _check_dense(cfg)
    tokens = tokens.long()
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    per_layer = []
    for lp in _layers(cfg, params):
        x, cache = apply_attn(lp["attn"], cfg, x, positions, mode="prefill",
                              window=window)
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
        per_layer.append(cache)
    period = block_period(cfg)
    caches = tuple(
        {name: torch.stack([c[name] for c in per_layer[pi::period]])
         for name in ("k", "v")}
        for pi in range(period))
    return _logits(cfg, params, x[:, -1:]), caches


def lm_decode_step(cfg: ModelConfig, params, caches, token, pos, *,
                   window: int = 0):
    """One decode step.  token: (B, 1); pos: the absolute position, the
    same for every row.  The caches are written in place.  Returns
    (logits (B, 1, V), caches)."""
    token = token.long()
    x = params["embed"][token]
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=token.device)
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        layer_cache = {name: caches[pi][name][b] for name in ("k", "v")}
        x, _ = apply_attn(lp["attn"], cfg, x, positions, mode="decode",
                          cache=layer_cache, window=window)
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    return _logits(cfg, params, x), caches


def _layer_pools(pools, b: int, pi: int) -> Dict[str, torch.Tensor]:
    return {name: pools[pi][name][b] for name in ("k", "v")}


def lm_decode_step_paged(cfg: ModelConfig, params, pools, token, positions,
                         page_table, kv_len, *, attn_fn: Callable,
                         window: int = 0):
    """One continuous-batching decode step over the whole slot batch.
    token: (B, 1); positions: (B,) each slot's absolute position (ragged);
    page_table: (B, n_pages); kv_len: (B,) valid KV rows (0 for idle
    slots).  ``attn_fn`` is the attention of
    :func:`~repro_torch.models.attention.apply_attn_paged` (the kernel or
    its plain version).  The pools
    are written in place.  Returns (logits (B, 1, V), pools)."""
    _check_dense(cfg)
    token = token.long()
    x = params["embed"][token]
    pos2 = positions.reshape(token.shape[0], 1).long()
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged(lp["attn"], cfg, x, pos2,
                                pools=_layer_pools(pools, b, pi),
                                page_table=page_table, kv_len=kv_len,
                                window=window, attn_fn=attn_fn)
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    return _logits(cfg, params, x), pools


def lm_prefill_chunk_paged(cfg: ModelConfig, params, pools, tokens, pt_row,
                           chunk_start: int, chunk_len: int, *,
                           attn_fn: Callable, window: int = 0):
    """One chunked-prefill step for ONE slot: a C-token chunk of its
    prompt (padded to C) attends to the slot's earlier pages and is
    written into them.  tokens: (1, C); pt_row: (n_pages,).  Returns
    (logits (1, C, V), pools); logits rows ≥ chunk_len are padding."""
    _check_dense(cfg)
    x = params["embed"][tokens.long()]
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged_prefill(
            lp["attn"], cfg, x, pools=_layer_pools(pools, b, pi),
            pt_row=pt_row, chunk_start=chunk_start, chunk_len=chunk_len,
            window=window, attn_fn=attn_fn)
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    return _logits(cfg, params, x), pools


def lm_serve_step_mixed(cfg: ModelConfig, params, pools, token, positions,
                        page_table, kv_len, chunk_tokens, pt_row,
                        chunk_start: int, chunk_len: int, *,
                        attn_fn: Callable, prefill_attn_fn: Callable,
                        window: int = 0):
    """The mixed serving step: every live decode slot advances one token
    AND one prefill chunk of one slot runs, in one walk over the layers.
    Decode inputs are :func:`lm_decode_step_paged`'s (the engine masks
    mid-prefill slots out of ``page_table`` / ``kv_len``), chunk inputs
    :func:`lm_prefill_chunk_paged`'s.  Within each layer the decode batch
    runs first, then the chunk; their page writes are disjoint.
    Returns (decode logits (B, 1, V), chunk logits (1, C, V), pools)."""
    _check_dense(cfg)
    token = token.long()
    xd = params["embed"][token]
    xc = params["embed"][chunk_tokens.long()]
    pos2 = positions.reshape(token.shape[0], 1).long()
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        layer_pools = _layer_pools(pools, b, pi)
        xd, _ = apply_attn_paged(lp["attn"], cfg, xd, pos2, pools=layer_pools,
                                 page_table=page_table, kv_len=kv_len,
                                 window=window, attn_fn=attn_fn)
        xc, _ = apply_attn_paged_prefill(
            lp["attn"], cfg, xc, pools=layer_pools, pt_row=pt_row,
            chunk_start=chunk_start, chunk_len=chunk_len, window=window,
            attn_fn=prefill_attn_fn)
        xd = apply_dense_ffn(lp["ffn"], xd, cfg.norm_eps)
        xc = apply_dense_ffn(lp["ffn"], xc, cfg.norm_eps)
    return _logits(cfg, params, xd), _logits(cfg, params, xc), pools
