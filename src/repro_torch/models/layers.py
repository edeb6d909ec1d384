"""Shared building blocks: the counterpart of ``repro/models/layers.py``.

Plain functions on tensors; the parameters are dicts of tensors keyed as
in the JAX tree.  Numerics follow the JAX package: RMSNorm scales by
``(1 + w)`` in f32, RoPE rotates split halves with f32 angles.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "swiglu", "gelu_mlp", "apply_dense_ffn",
           "trunc_normal", "init_leaf"]

# Φ(±2) of the standard normal: the truncation bounds of the JAX init
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling), in
    one f32 buffer: a 3.2 G-element MoE leaf slice takes 12.9 GB, not
    three times that."""
    u = torch.empty(shape, dtype=torch.float32, device=generator.device)
    u.uniform_(2.0 * _LO - 1.0, 2.0 * _HI - 1.0, generator=generator)
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def init_leaf(shape, dtype: torch.dtype, init, generator: torch.Generator
              ) -> torch.Tensor:
    """One parameter leaf by its spec's ``init``: an int is the fan-in of
    the truncated-normal init (std = 1/√fan_in), None zeros, a callable
    ``(shape, device) → f32 tensor`` a constant init."""
    if init is None:
        return torch.zeros(shape, dtype=dtype, device=generator.device)
    if callable(init):
        return init(shape, generator.device).to(dtype)
    std = 1.0 / math.sqrt(init)
    return trunc_normal(shape, generator).mul_(std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs       # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, w_down):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def apply_dense_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    eps: float, reduce: Optional[Callable] = None
                    ) -> torch.Tensor:
    """Pre-norm FFN with residual: SwiGLU when the layer has ``w_gate``,
    else the ungated GELU MLP.  Under tensor parallelism ``w_gate`` /
    ``w_up`` hold the rank's columns and ``w_down`` its rows, and
    ``reduce`` sums the rank's partial product over the model axis BEFORE
    the residual (``x + psum(partial)``: x is counted once)."""
    h = rms_norm(x, p["ln"], eps)
    if "w_gate" in p:
        y = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    else:
        y = gelu_mlp(h, p["w_up"], p["w_down"])
    return x + (y if reduce is None else reduce(y))
