"""Decoder LM of the dense and MoE families: the counterpart of
``repro/models/transformer.py`` (``init_lm``, ``lm_loss``).

Parameters are a flat dict keyed by the JAX tree's ``|``-joined paths.  As
in JAX, the layers at one position of the block period share stacked
leaves of leading dim ``n_blocks`` (``blocks|<pi>|attn|wq`` is
``(n_blocks, d, H·hd)``, ``blocks|<pi>|moe|shared|w_gate`` is
``(n_blocks, d, n_shared·ff)``); the forward pass walks the stack in a
Python loop where JAX scans it.  Each layer is attention then a dense FFN
(``ffn``) or an MoE FFN (``moe``), as ``layer_kinds`` says; the MoE
router's leaf is f32 inside a bf16 model, as in the reference.  The SSM,
hybrid, encoder-decoder and VLM families are not ported yet (ROADMAP.md).

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
from .moe import apply_moe

__all__ = ["param_specs", "param_meta", "init_lm", "lm_loss",
           "init_lm_cache", "lm_prefill", "lm_decode_step",
           "lm_decode_step_paged", "lm_prefill_chunk_paged",
           "lm_serve_step_mixed"]

# (shape, dtype, fan_in); fan_in None marks a zero-initialised leaf (norm
# weights, QKV biases)
Spec = Tuple[Tuple[int, ...], torch.dtype, object]

# the layer kinds of the dense and MoE families, which the port runs
_PORTED_KINDS = (("attn", "dense"), ("attn", "moe"))


def _check_family(cfg: ModelConfig):
    kinds = layer_kinds(cfg)[:block_period(cfg)]
    if cfg.family not in ("dense", "moe") or any(
            k not in _PORTED_KINDS for k in kinds):
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet; the port runs "
            "the dense and MoE families (ROADMAP.md)")
    return kinds


def _attn_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "wq": ((nb, d, H * hd), dt, d),
          "wk": ((nb, d, K * hd), dt, d),
          "wv": ((nb, d, K * hd), dt, d),
          "wo": ((nb, H * hd, d), dt, H * hd)}
    if cfg.qkv_bias:
        sp.update({"bq": ((nb, H * hd), dt, None),
                   "bk": ((nb, K * hd), dt, None),
                   "bv": ((nb, K * hd), dt, None)})
    if cfg.qk_norm:
        sp.update({"q_norm": ((nb, hd), dt, None),
                   "k_norm": ((nb, hd), dt, None)})
    return sp


def _ffn_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, ff = cfg.d_model, cfg.dense_d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "w_up": ((nb, d, ff), dt, d),
          "w_down": ((nb, ff, d), dt, ff)}
    if cfg.mlp_gated:
        sp["w_gate"] = ((nb, d, ff), dt, d)
    return sp


def _moe_specs(cfg: ModelConfig, nb: int) -> Dict[str, Spec]:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    sp = {"ln": ((nb, d), dt, None),
          "router": ((nb, d, E), torch.float32, d),
          "w_gate": ((nb, E, d, ff), dt, d),
          "w_up": ((nb, E, d, ff), dt, d),
          "w_down": ((nb, E, ff, d), dt, ff)}
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        sp.update({"shared|w_gate": ((nb, d, sff), dt, d),
                   "shared|w_up": ((nb, d, sff), dt, d),
                   "shared|w_down": ((nb, sff, d), dt, sff)})
    return sp


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every parameter's shape, dtype and init fan-in, keyed by path."""
    kinds = _check_family(cfg)
    nb = cfg.n_layers // len(kinds)
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    specs: Dict[str, Spec] = {
        "embed": ((cfg.vocab_size, d), dt, d),
        "final_ln": ((d,), dt, None),
        "lm_head": ((d, cfg.vocab_size), dt, d),
    }
    for pi, (_, ffn) in enumerate(kinds):
        subs = {"attn": _attn_specs(cfg, nb)}
        if ffn == "moe":
            subs["moe"] = _moe_specs(cfg, nb)
        else:
            subs["ffn"] = _ffn_specs(cfg, nb)
        for sub, sp in subs.items():
            specs.update({f"blocks|{pi}|{sub}|{name}": v
                          for name, v in sp.items()})
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
    init (std = 1/√fan_in) for matrices, zeros for norm weights and
    biases — the JAX package's scheme, drawn from a ``torch.Generator``
    (so the values differ from ``jax.random``'s; tests carry weights
    across instead).  A stacked leaf (``blocks|...``) is drawn one
    leading-index slice at a time into the allocated leaf, so the f32
    temporaries are one layer's, not the stack's."""
    params = {}
    specs = param_specs(cfg)
    dev = generator.device
    for path in sorted(specs):
        shape, dt, fan_in = specs[path]
        if fan_in is None:
            params[path] = torch.zeros(shape, dtype=dt, device=dev)
            continue
        std = 1.0 / math.sqrt(fan_in)
        if path.startswith("blocks|"):
            leaf = torch.empty(shape, dtype=dt, device=dev)
            for b in range(shape[0]):
                leaf[b] = _trunc_normal(shape[1:], generator) * std
            params[path] = leaf
        else:
            params[path] = (_trunc_normal(shape, generator) * std).to(dt)
    return params


def _layers(cfg: ModelConfig, params: Dict[str, torch.Tensor]
            ) -> List[Dict[str, Dict]]:
    """Per-layer ``{"attn": {...}, "ffn" | "moe": {...}}`` views of the
    stacked leaves (nested below, as ``moe["shared"]["w_gate"]``).
    ``unbind`` keeps one autograd node per stacked leaf, whose backward
    stacks the per-layer gradients."""
    period = block_period(cfg)
    nb = cfg.n_layers // period
    layers: List[Dict[str, Dict]] = [{} for _ in range(cfg.n_layers)]
    for path, leaf in params.items():
        parts = path.split("|")
        if parts[0] != "blocks":
            continue
        pi, keys = int(parts[1]), parts[2:]
        for b, w in enumerate(leaf.unbind(0)):
            node = layers[b * period + pi]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = w
    assert len(layers) == nb * period
    return layers


def _ffn(cfg: ModelConfig, lp: Dict, x: torch.Tensor, aux=None):
    """The layer's FFN with residual: (x, aux), ``aux`` plus the MoE
    layer's ``router_aux_coef · aux`` (None stays None for dense layers)."""
    if "moe" in lp:
        x, a = apply_moe(lp["moe"], cfg, x, cfg.norm_eps)
        return x, (a if aux is None else aux + a)
    return apply_dense_ffn(lp["ffn"], x, cfg.norm_eps), aux


def lm_loss(cfg: ModelConfig, params: Dict[str, torch.Tensor],
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token cross entropy of one agent, plus the MoE layers'
    load-balance losses.  batch: {tokens (B, S)}; the loss predicts
    tokens[1:] from the prefix, f32 logits through ``logsumexp``."""
    _check_family(cfg)
    tokens = batch["tokens"].long()
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = None
    for lp in _layers(cfg, params):
        x = apply_attn(lp["attn"], cfg, x, positions)
        x, aux = _ffn(cfg, lp, x, aux)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = (h @ params["lm_head"]).float()
    pred = logits[:, :-1]
    tgt = tokens[:, 1:]
    logz = torch.logsumexp(pred, dim=-1)
    gold = pred.gather(-1, tgt[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll if aux is None else nll + aux


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
    _check_family(cfg)
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
    _check_family(cfg)
    tokens = tokens.long()
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    per_layer = []
    for lp in _layers(cfg, params):
        x, cache = apply_attn(lp["attn"], cfg, x, positions, mode="prefill",
                              window=window)
        x, _ = _ffn(cfg, lp, x)
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
        x, _ = _ffn(cfg, lp, x)
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
    _check_family(cfg)
    token = token.long()
    x = params["embed"][token]
    pos2 = positions.reshape(token.shape[0], 1).long()
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged(lp["attn"], cfg, x, pos2,
                                pools=_layer_pools(pools, b, pi),
                                page_table=page_table, kv_len=kv_len,
                                window=window, attn_fn=attn_fn)
        x, _ = _ffn(cfg, lp, x)
    return _logits(cfg, params, x), pools


def lm_prefill_chunk_paged(cfg: ModelConfig, params, pools, tokens, pt_row,
                           chunk_start: int, chunk_len: int, *,
                           attn_fn: Callable, window: int = 0):
    """One chunked-prefill step for ONE slot: a C-token chunk of its
    prompt (padded to C) attends to the slot's earlier pages and is
    written into them.  tokens: (1, C); pt_row: (n_pages,).  Returns
    (logits (1, C, V), pools); logits rows ≥ chunk_len are padding."""
    _check_family(cfg)
    x = params["embed"][tokens.long()]
    for (_, b, pi), lp in zip(_stack_index(cfg), _layers(cfg, params)):
        x, _ = apply_attn_paged_prefill(
            lp["attn"], cfg, x, pools=_layer_pools(pools, b, pi),
            pt_row=pt_row, chunk_start=chunk_start, chunk_len=chunk_len,
            window=window, attn_fn=attn_fn)
        x, _ = _ffn(cfg, lp, x)
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
    runs first, then the chunk; their page writes are disjoint.  An MoE
    FFN routes the decode rows (idle slots included) and the chunk rows
    (padding included) in two separate calls, as the reference does, so
    each call's capacity is its own.
    Returns (decode logits (B, 1, V), chunk logits (1, C, V), pools)."""
    _check_family(cfg)
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
        xd, _ = _ffn(cfg, lp, xd)
        xc, _ = _ffn(cfg, lp, xc)
    return _logits(cfg, params, xd), _logits(cfg, params, xc), pools
