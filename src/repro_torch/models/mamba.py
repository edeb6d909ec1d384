"""Mamba-1 selective state-space block: the counterpart of
``repro/models/mamba.py`` (the falcon-mamba mixer).

The reference evaluates the recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` as a
chunked associative scan: within each chunk of ``chunk`` steps a
log-depth prefix (``jax.lax.associative_scan``), then a short loop over
the chunk boundaries that threads the carry.  It chose that "instead of
the CUDA fused selective-scan kernel", so there is no TPU kernel to port
here: the scan is plain PyTorch.  :func:`_associative_scan` is the same
recursion that ``jax.lax.associative_scan`` runs (combine adjacent pairs,
recurse, fill in the even elements, interleave), so the f32 products and
sums come in the reference's order.  The scan reads no value back to the
host and branches on no data, so the bus train step that runs it can be
captured in a CUDA graph.

Decode is the one-step recurrence on a fixed-size state: ``h`` (B, d_inner,
d_state) in f32 and the conv tail (B, conv − 1, d_inner).

Tensor parallelism: a rank of the model axis holds ``d_inner / M``
channels (``in_proj``'s paired columns of x and z, ``conv_w``,
``dt_proj``, ``dt_bias``, ``A_log``, ``D``, the rows of ``x_proj`` and
``out_proj``; :func:`repro_torch.models.transformer.lm_param_specs`) and
their state.  The scan runs per channel and needs no collective;
``reduce`` sums ``x_proj``'s and ``out_proj``'s row-parallel partials
over the model axis: two sums a layer.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import init_leaf, rms_norm

__all__ = ["SSM_STATE_LEAF_PATTERNS", "ssm_state_group_spec", "ssm_specs",
           "init_mamba", "init_ssm_cache", "ssm_scan_ref", "apply_mamba"]

# path patterns of the conv / SSM state-dynamics leaves (the causal conv
# stencil and the per-channel A_log, D, dt_bias); the projections
# (in / x / dt / out) stay in the dense group
SSM_STATE_LEAF_PATTERNS = ("ssm|conv_w", "ssm|conv_b", "ssm|A_log",
                           "ssm|D", "ssm|dt_bias")


def ssm_state_group_spec(gossip_every: int = 0, wire: str = "f32",
                         schedule: str = ""):
    """Policy-group spec of the conv / SSM state leaves: ``gossip_every=0``
    (the default) keeps each agent's recurrence dynamics local, ``k``
    gossips them every k-th step.  Reached through
    ``RunConfig.gossip_groups="ssm[:k]"``."""
    from repro_torch.core.bus import GroupSpec
    return GroupSpec("ssm_state", SSM_STATE_LEAF_PATTERNS,
                     gossip_every=gossip_every, wire=wire, schedule=schedule)


def _a_log_init(shape, device) -> torch.Tensor:
    """S4D-real A: ``log(1..d_state)`` in every channel."""
    s = shape[-1]
    a = torch.arange(1, s + 1, dtype=torch.float32, device=device)
    return torch.log(a).expand(shape).clone()


def _fill(value: float):
    def init(shape, device):
        return torch.full(shape, value, dtype=torch.float32, device=device)
    return init


def ssm_specs(cfg, nb: int) -> Dict[str, tuple]:
    """(shape, dtype, init) of one period position's stacked Mamba leaves,
    as ``init_mamba`` makes them: an int init is the truncated-normal
    fan-in, None zeros, a callable ``(shape, device) → f32 tensor`` one
    layer's constant.  ``dt_proj``, ``dt_bias``, ``A_log`` and ``D`` are
    f32 in any model dtype."""
    d, di, s, r, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    dt, f32 = getattr(torch, cfg.dtype), torch.float32
    return {"ln": ((nb, d), dt, None),
            "in_proj": ((nb, d, 2 * di), dt, d),
            "conv_w": ((nb, cw, di), dt, cw),
            "conv_b": ((nb, di), dt, None),
            "x_proj": ((nb, di, r + 2 * s), dt, di),
            "dt_proj": ((nb, r, di), f32, r),
            "dt_bias": ((nb, di), f32, _fill(-4.6)),   # softplus⁻¹(0.01)
            "A_log": ((nb, di, s), f32, _a_log_init),
            "D": ((nb, di), f32, _fill(1.0)),
            "out_proj": ((nb, di, d), dt, di)}


def init_mamba(cfg, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One Mamba layer's parameters on ``generator.device``, drawn by
    :func:`ssm_specs` (the model's ``init_lm`` draws the stacked leaves
    the same way)."""
    return {name: init_leaf(shape[1:], dt, init, generator)
            for name, (shape, dt, init) in sorted(ssm_specs(cfg, 1).items())}


def init_ssm_cache(cfg, batch: int, dtype=None, device=None,
                   d_inner: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero decode state of one layer: ``h`` (B, d_inner, d_state) f32 and
    the conv tail (B, conv − 1, d_inner) in ``dtype`` (f32 by default, as
    the reference's); ``d_inner`` the channels a tensor-parallel rank
    holds (default the config's)."""
    di = d_inner or cfg.d_inner
    return {"h": torch.zeros((batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                dtype=dtype or torch.float32, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence.  x: (B, S, di); w: (cw, di).
    Tap 0 first, then a running sum, as the reference's ``sum``.  Returns
    (out, the last cw − 1 input rows: the new conv state)."""
    cw, S = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                    # (B, S + cw − 1, di)
    out = xp[:, 0:S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, S:] if cw > 1 else pad
    return out + b, new_state


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Oracle: the sequential scan of ``h_t = a_t·h_{t−1} + b_t``.
    a, b: (B, S, di, s) f32; h0: (B, di, s).  Returns (hs, h_T)."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _combine(lhs, rhs):
    (al, bl), (ar, br) = lhs, rhs
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int
                ) -> torch.Tensor:
    """Elements ``e0 o0 e1 o1 …`` along ``axis`` (len(even) − len(odd) is
    0 or 1)."""
    n_odd = odd.shape[axis]
    pairs = torch.stack([even.narrow(axis, 0, n_odd), odd], dim=axis + 1)
    shape = list(even.shape)
    shape[axis] = 2 * n_odd
    out = pairs.reshape(shape)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, even.narrow(axis, n_odd, 1)], dim=axis)
    return out


def _strided(t: torch.Tensor, axis: int, start: int, stop: int
             ) -> torch.Tensor:
    """``t[start:stop:2]`` along ``axis`` (stop ≤ 0 counts from the end)."""
    idx = [slice(None)] * t.dim()
    idx[axis] = slice(start, t.shape[axis] + stop if stop <= 0 else stop, 2)
    return t[tuple(idx)]


def _associative_scan(elems: List[torch.Tensor], axis: int
                      ) -> List[torch.Tensor]:
    """Inclusive prefix of ``(a, b)`` pairs under :func:`_combine` along
    ``axis``: ``jax.lax.associative_scan``'s recursion, step for step."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = _combine([_strided(e, axis, 0, -1) for e in elems],
                       [_strided(e, axis, 1, 0) for e in elems])
    odd = _associative_scan(list(reduced), axis)
    if n % 2 == 0:
        even = _combine([e.narrow(axis, 0, e.shape[axis] - 1) for e in odd],
                        [_strided(e, axis, 2, 0) for e in elems])
    else:
        even = _combine(odd, [_strided(e, axis, 2, 0) for e in elems])
    even = [torch.cat([e.narrow(axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _chunked_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunked scan: an associative prefix within each
    chunk (from a zero state), then a loop over the chunks that threads
    the carry.  One chunk when ``chunk`` does not divide S.
    a, b: (B, S, di, s); h0: (B, di, s) → (hs, h_T)."""
    B, S, di, s = a.shape
    if S % chunk:
        chunk = S
    nc = S // chunk
    a_pref, h_pref = _associative_scan(
        [a.reshape(B, nc, chunk, di, s), b.reshape(B, nc, chunk, di, s)], 2)
    # the incoming state of each chunk: h_in(c + 1) = Πa(c)·h_in(c) + h_last(c)
    h_ins, h_in = [], h0
    for c in range(nc):
        h_ins.append(h_in)
        h_in = a_pref[:, c, -1] * h_in + h_pref[:, c, -1]
    hs = h_pref + a_pref * torch.stack(h_ins, dim=1)[:, :, None]
    # h_T is the last carry, the bits of hs[:, -1, -1], in a tensor of its
    # own: a view would keep all of hs alive in the prefill's caches
    return hs.reshape(B, S, di, s), h_in


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0): max(x, 0) + log1p(exp(−|x|))
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def apply_mamba(p: Dict[str, torch.Tensor], cfg, x: torch.Tensor, *,
                mode: str = "train", cache: Optional[Dict] = None,
                chunk: int = 256, reduce: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba block with pre-norm and residual: ``mode="train"`` scans the
    whole sequence (the prefill passes a zero ``cache`` and gets the final
    state back), ``"decode"`` takes one step (S = 1) from ``cache``.
    ``reduce`` sums a tensor-parallel rank's ``x_proj`` and ``out_proj``
    partials over the model axis (see the module's note).
    Returns (y, new cache or None); the cache passed in is not written."""
    resid = x
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    r, s = cfg.dt_rank, cfg.ssm_state
    xr, z = (h @ p["in_proj"]).chunk(2, dim=-1)        # (B, S, di) each
    conv_state = cache["conv"] if cache is not None else None
    xr, new_conv = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    xr = F.silu(xr)
    xp = xr @ p["x_proj"]
    if reduce is not None:
        xp = reduce(xp)
    dt_r, Bc, Cc = xp.split([r, s, s], dim=-1)
    dt = _softplus(dt_r.float() @ p["dt_proj"] + p["dt_bias"])  # (B, S, di)
    A = -torch.exp(p["A_log"])                          # (di, s)
    a = torch.exp(dt[..., None] * A)                    # (B, S, di, s)
    bx = (dt * xr.float())[..., None] * Bc.float()[..., None, :]
    if cache is not None:
        h0 = cache["h"]
    else:
        h0 = a.new_zeros((a.shape[0], a.shape[2], s))
    if mode == "decode":
        hT = a[:, 0] * h0 + bx[:, 0]                    # (B, di, s)
        y = torch.einsum("bds,bs->bd", hT, Cc[:, 0].float())[:, None]
    else:
        hs, hT = _chunked_scan(a, bx, h0, chunk)
        y = torch.einsum("btds,bts->btd", hs, Cc.float())
    y = y + p["D"] * xr.float()
    y = y.to(h.dtype) * F.silu(z)
    out = y @ p["out_proj"]
    if reduce is not None:
        out = reduce(out)
    new_cache = None
    if cache is not None:
        # a copy: the conv tail is a view of the padded input
        new_cache = {"h": hT, "conv": new_conv.to(cache["conv"].dtype,
                                                  copy=True)}
    return resid + out, new_cache
