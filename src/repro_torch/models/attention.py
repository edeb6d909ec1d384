"""GQA self-attention for training: the counterpart of the train-mode part
of ``repro/models/attention.py``.

Plain einsum and matmul, as the JAX training path is plain jnp (it trains
on ``sdpa_ref``, not on the Pallas flash kernel).  Logits and softmax are
f32, masked entries take ``-1e30``, and the output is cast back to the
query dtype.  Cached decode, cross attention and the paged serving paths
belong to the serving slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from .layers import rms_norm, rope

__all__ = ["sdpa_ref", "apply_attn"]

NEG_INF = -1e30


def sdpa_ref(q, k, v, *, causal: bool, window: int = 0) -> torch.Tensor:
    """Scaled dot-product attention with GQA head sharing.
    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); H % K == 0."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    qf = q.float().reshape(B, Sq, K, G, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf * scale, k.float())
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _qkv(p: Dict[str, torch.Tensor], cfg, x, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    v = (x @ p["wv"]).reshape(B, S, K, hd)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attn(p: Dict[str, torch.Tensor], cfg, x, positions, *,
               mode: str = "train", window: int = 0) -> torch.Tensor:
    """Pre-norm causal (or sliding-window) self-attention with residual."""
    if mode != "train":
        raise NotImplementedError(
            f"attention mode {mode!r} belongs to the serving slice, not "
            "ported yet (ROADMAP.md)")
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, positions)
    out = sdpa_ref(q, k, v, causal=True, window=window or cfg.sliding_window)
    B, S = h.shape[:2]
    return x + out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
