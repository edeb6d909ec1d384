"""Decoder LM of the dense family: the counterpart of
``repro/models/transformer.py`` (``init_lm``, ``lm_loss``).

Parameters are a flat dict keyed by the JAX tree's ``|``-joined paths.  As
in JAX, the layers at one position of the block period share stacked
leaves of leading dim ``n_blocks`` (``blocks|<pi>|attn|wq`` is
``(n_blocks, d, H·hd)``); the forward pass walks the stack in a Python loop
where JAX scans it.  The MoE, SSM, hybrid, encoder-decoder and VLM
families are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, block_period, layer_kinds
from .attention import apply_attn
from .layers import apply_dense_ffn, rms_norm

__all__ = ["param_specs", "param_meta", "init_lm", "lm_loss"]

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
