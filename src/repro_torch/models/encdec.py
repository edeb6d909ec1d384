"""Whisper-style encoder-decoder backbone: the counterpart of
``repro/models/encdec.py``.

The mel-spectrogram and conv feature extractor are a stub in both
packages: a batch's ``frontend`` holds precomputed frame embeddings
``(B, T, d_model)``.  The encoder is bidirectional self-attention then a
dense FFN per layer; the decoder is causal self-attention, cross
attention over the encoder's output, then the FFN.  Positions are
sinusoidal (computed on the fly, f32, cast to the activations' dtype),
so no layer applies RoPE.

Parameters keep the reference's tree paths, ``|``-joined:
``enc_blocks|attn|wq`` ``(n_enc_layers, d, H·hd)``, ``enc_blocks|ffn|...``,
``enc_ln``, ``dec_embed``, ``dec_blocks|{attn,xattn,ffn}|...``, ``dec_ln``
and ``lm_head``, each block leaf stacked with the layer count leading, so
:mod:`repro_torch.weights`, the bus layout and the checkpoints carry a
reference tree as they carry a decoder LM's.  The stacks are walked in a
Python loop where JAX scans them.

Serving: :func:`encdec_prefill` runs the encoder once and returns one
cache ``{k, v, xk, xv}`` a layer, stacked with the decoder's depth
leading and wrapped in a one-entry tuple like the decoder LM's caches
(the reference's is the bare dict); :func:`encdec_decode_step` writes
``k`` / ``v`` in place and reads the cross caches ``xk`` / ``xv``.  There
is no paged path, as in the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .attention import _qkv, apply_attn, init_kv_cache, sdpa_ref
from .layers import apply_dense_ffn, rms_norm
from .transformer import Spec, _attn_specs, _ffn_specs, init_from_specs

__all__ = ["encdec_param_specs", "init_encdec", "encdec_loss",
           "init_encdec_cache", "encdec_prefill", "encdec_decode_step"]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """``[sin, cos]`` of ``position · exp(−i·ln(10000)/(d/2 − 1))``, f32:
    ``(..., d)``."""
    half = d // 2
    # the f32 value of ln(10000) / (half − 1), as a host scalar: no
    # host-to-device copy (the training step is captured as a CUDA graph)
    step = float(np.log(np.float32(10000.0)) / np.float32(max(half - 1, 1)))
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=positions.device) * -step)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """Every parameter's shape, dtype and init fan-in, keyed by path
    (``dec_embed`` fans in over its d axis, ``lm_head`` over its rows, as
    ``init_encdec``)."""
    ne, nd, d = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    dt = getattr(torch, cfg.dtype)
    stacks = {
        "enc_blocks": {"attn": _attn_specs(cfg, ne),
                       "ffn": _ffn_specs(cfg, ne)},
        "dec_blocks": {"attn": _attn_specs(cfg, nd),
                       "xattn": _attn_specs(cfg, nd),
                       "ffn": _ffn_specs(cfg, nd)},
    }
    specs: Dict[str, Spec] = {
        "enc_ln": ((d,), dt, None),
        "dec_embed": ((cfg.vocab_size, d), dt, d),
        "dec_ln": ((d,), dt, None),
        "lm_head": ((d, cfg.vocab_size), dt, d),
    }
    for stack, subs in stacks.items():
        for sub, sp in subs.items():
            specs.update({f"{stack}|{sub}|{name}": v
                          for name, v in sp.items()})
    return specs


def init_encdec(cfg: ModelConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Random parameters on ``generator.device``, by the decoder LM's
    scheme (:func:`repro_torch.models.transformer.init_lm`): values differ
    from ``jax.random``'s, so tests carry weights across."""
    return init_from_specs(encdec_param_specs(cfg), generator)


def _unstack(params: Dict[str, torch.Tensor], stack: str, n: int
             ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Per-layer ``{"attn": {...}, "ffn": {...}[, "xattn": {...}]}`` views
    of the leaves under ``stack|``."""
    layers: List[Dict[str, Dict[str, torch.Tensor]]] = [{} for _ in range(n)]
    for path, leaf in params.items():
        parts = path.split("|")
        if parts[0] != stack:
            continue
        for b, w in enumerate(leaf.unbind(0)):
            layers[b].setdefault(parts[1], {})[parts[2]] = w
    return layers


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def _encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, T, d)`` (cast to the weights' dtype) → the encoder's
    output: per layer bidirectional attention with residual, then the
    dense FFN; the final ``enc_ln``."""
    frames = frames.to(params["enc_ln"].dtype)
    B, T, d = frames.shape
    pos = _positions(B, T, frames.device)
    x = frames + _sinusoid(pos, d).to(frames.dtype)
    H, hd = cfg.n_heads, cfg.hd
    for lp in _unstack(params, "enc_blocks", cfg.n_enc_layers):
        h = rms_norm(x, lp["attn"]["ln"], cfg.norm_eps)
        q, k, v = _qkv(lp["attn"], cfg, h, pos)
        out = sdpa_ref(q, k, v, causal=False)
        x = x + out.reshape(B, T, H * hd) @ lp["attn"]["wo"]
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    return rms_norm(x, params["enc_ln"], cfg.norm_eps)


def _cross_kv(cfg: ModelConfig, p_x, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross attention's keys and values: ``xattn``'s ``wk`` / ``wv``
    on the encoder output (not normed again), ``(B, T, K, hd)``."""
    B, T, _ = enc_out.shape
    K, hd = cfg.n_kv_heads, cfg.hd
    return ((enc_out @ p_x["wk"]).reshape(B, T, K, hd),
            (enc_out @ p_x["wv"]).reshape(B, T, K, hd))


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    x = params["dec_embed"][tokens.long()]
    return x + _sinusoid(positions, cfg.d_model).to(x.dtype)


def encdec_loss(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], *, remat: bool = True,
                remat_policy: str = "full") -> torch.Tensor:
    """Next-token cross entropy of the decoder over ``tokens`` (B, S) given
    the ``frontend`` frames: f32 logits, the mean of ``logsumexp − gold``
    over ``tokens[1:]``.  ``remat`` and ``remat_policy`` are taken and
    ignored, as the reference's ``encdec_loss`` ignores ``remat`` (the
    gradients are the same either way)."""
    del remat, remat_policy
    enc_out = _encode(cfg, params, batch["frontend"])
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = _embed(cfg, params, tokens, pos)
    for lp in _unstack(params, "dec_blocks", cfg.n_layers):
        x = apply_attn(lp["attn"], cfg, x, pos)
        x, _ = apply_attn(lp["xattn"], cfg, x, pos, mode="cross",
                          xattn_kv=_cross_kv(cfg, lp["xattn"], enc_out))
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    logits = (rms_norm(x, params["dec_ln"], cfg.norm_eps)
              @ params["lm_head"]).float()
    pred = logits[:, :-1]
    logz = torch.logsumexp(pred, dim=-1)
    gold = pred.gather(-1, tokens[:, 1:, None])[..., 0]
    return (logz - gold).mean()


def init_encdec_cache(cfg: ModelConfig, batch: int, length: int, *,
                      device=None) -> Tuple[Dict[str, torch.Tensor]]:
    """Zero caches ``({k, v, xk, xv},)``: ``k`` / ``v`` ``(L, batch,
    length, K, hd)``, ``xk`` / ``xv`` ``(L, batch, n_frontend_tokens, K,
    hd)`` (``device="meta"`` gives the shapes without allocating)."""
    L = cfg.n_layers
    one = dict(init_kv_cache(cfg, batch, length, device=device))
    x = init_kv_cache(cfg, batch, cfg.n_frontend_tokens, device=device)
    one.update(xk=x["k"], xv=x["v"])
    return ({k: v[None].expand(L, *v.shape).contiguous()
             for k, v in one.items()},)


def encdec_prefill(cfg: ModelConfig, params, tokens: torch.Tensor,
                   frames: torch.Tensor, *, window: int = 0):
    """The encoder over ``frames``, then the decoder over the prompt:
    (last-position logits (B, 1, V), caches ``({k, v, xk, xv},)``), the
    self-attention caches holding the prompt's S rows (the last ``window``
    in ring order with a window) and the cross caches the encoder's T."""
    enc_out = _encode(cfg, params, frames)
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = _embed(cfg, params, tokens, pos)
    per_layer = []
    for lp in _unstack(params, "dec_blocks", cfg.n_layers):
        x, kv = apply_attn(lp["attn"], cfg, x, pos, mode="prefill",
                           window=window)
        xk, xv = _cross_kv(cfg, lp["xattn"], enc_out)
        x, _ = apply_attn(lp["xattn"], cfg, x, pos, mode="cross",
                          xattn_kv=(xk, xv))
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
        per_layer.append({"k": kv["k"], "v": kv["v"], "xk": xk, "xv": xv})
    caches = ({name: torch.stack([c[name] for c in per_layer])
               for name in per_layer[0]},)
    logits = rms_norm(x[:, -1:], params["dec_ln"], cfg.norm_eps) \
        @ params["lm_head"]
    return logits, caches


def encdec_decode_step(cfg: ModelConfig, params, caches, token, pos, *,
                       window: int = 0):
    """One decode step at absolute position ``pos`` (the decoder's
    positions start at 0): the sinusoid at ``pos``, each layer's self
    attention writing its ``k`` / ``v`` row in place, cross attention over
    its ``xk`` / ``xv``.  Returns (logits (B, 1, V), caches)."""
    token = token.long()
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.long,
                           device=token.device)
    x = _embed(cfg, params, token, positions)
    (c,) = caches
    for li, lp in enumerate(_unstack(params, "dec_blocks", cfg.n_layers)):
        x, _ = apply_attn(lp["attn"], cfg, x, positions, mode="decode",
                          cache={"k": c["k"][li], "v": c["v"][li]},
                          window=window)
        x, _ = apply_attn(lp["xattn"], cfg, x, positions, mode="cross",
                          xattn_kv=(c["xk"][li], c["xv"][li]))
        x = apply_dense_ffn(lp["ffn"], x, cfg.norm_eps)
    logits = rms_norm(x, params["dec_ln"], cfg.norm_eps) @ params["lm_head"]
    return logits, caches
