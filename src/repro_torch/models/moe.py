"""Mixture-of-Experts FFN: the counterpart of ``repro/models/moe.py``.

Top-k router with softmax-renormalised weights, capacity-limited sort
dispatch (Switch / GShard: the ``T·k`` assignments sorted by expert id,
ranked within each expert, those past capacity ``C`` dropped), three
batched expert matmuls over ``(E, C, d)``, and the weighted combine; plus
the optional shared experts (DeepSeekMoE).  The reference's multi-device
``apply_moe_shard_map`` / ``set_moe_mesh`` are not ported (ROADMAP.md).

The reference's orders are kept where they decide the result:

* top-k ties go to the lower expert id (``jax.lax.top_k``): a stable
  descending sort;
* the dispatch order is a stable argsort of the expert ids, token-major,
  which decides which assignments are dropped past capacity;
* a token's k expert outputs are summed in ascending expert order, each
  sum rounded to the activation dtype (the reference's scatter-add).

Dispatch and combine are gathers, not scatters: each kept buffer slot has
exactly one source row (dropped slots hold zeros), and the combine reads
each token's k slots through the inverse of the sort.  So the layer is
deterministic on the card, reads no value back to the host, and can be
captured in a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import rms_norm, swiglu

__all__ = ["EXPERT_LEAF_PATTERNS", "expert_group_spec", "dispatch_plan",
           "apply_moe"]

# path patterns of the per-expert weights (leading expert dim E).  The
# router, the MoE layernorm and the shared experts gossip with the dense
# group: "moe|w_gate" does NOT match "moe|shared|w_gate".
EXPERT_LEAF_PATTERNS = ("moe|w_gate", "moe|w_up", "moe|w_down")


def expert_group_spec(gossip_every: int = 0, wire: str = "f32",
                      schedule: str = ""):
    """Policy-group spec of the expert weights: ``gossip_every=0`` (the
    default) keeps each agent's experts local, ``k`` gossips them every
    k-th step, optionally at a cheaper ``wire`` or on their own
    ``schedule``.  Reached through ``RunConfig.gossip_groups="moe[:k]"``."""
    from repro_torch.core.bus import GroupSpec
    return GroupSpec("experts", EXPERT_LEAF_PATTERNS,
                     gossip_every=gossip_every, wire=wire, schedule=schedule)


def _route(logits: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing: (weights (T, k) f32, expert ids (T, k), aux loss).

    The Switch load-balance loss ``E · Σ density · prob_density``, where
    ``density`` (the top-1 share) carries no gradient and
    ``prob_density`` (the mean router probability) does."""
    probs = torch.softmax(logits.float(), dim=-1)               # (T, E)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[:, :k], ids[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    E = logits.shape[-1]
    experts = torch.arange(E, device=logits.device)
    density = (idx[:, :1] == experts).float().mean(dim=0)
    prob_density = probs.mean(dim=0)
    aux = E * (density * prob_density).sum()
    return w, idx, aux


def dispatch_plan(idx: torch.Tensor, E: int, C: int) -> Dict[str, torch.Tensor]:
    """The capacity dispatch of expert ids ``idx`` (T, k) as index tensors.

    ``order``: the stable sort of the flat assignments by expert;
    ``keep`` (T·k,): sorted assignment within capacity; ``slot`` (T·k,):
    its buffer row ``e·C + rank`` (clamped for dropped ones); ``src``
    (E, C): the token whose row fills each buffer slot, with ``filled``
    marking the slots that have one; ``pos`` (T, k): each token's sorted
    positions in ascending expert order (the combine's reading order)."""
    T, k = idx.shape
    dev = idx.device
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = order // k
    experts = torch.arange(E, device=dev, dtype=e_sorted.dtype)
    starts = torch.searchsorted(e_sorted, experts)
    ends = torch.searchsorted(e_sorted, experts, right=True)
    rank = torch.arange(T * k, device=dev) - starts[e_sorted]
    keep = rank < C
    slot = e_sorted * C + rank.clamp(0, C - 1)
    at = starts[:, None] + torch.arange(C, device=dev)[None]    # (E, C)
    filled = at < ends[:, None]
    src = tok_sorted[at.clamp(max=T * k - 1)]
    # a token's experts are distinct and the sort is stable, so its sorted
    # positions in ascending order follow ascending expert ids
    pos = torch.argsort(order).reshape(T, k).sort(dim=1).values
    return {"order": order, "keep": keep, "slot": slot, "src": src,
            "filled": filled, "pos": pos}


def apply_moe(p: Dict, cfg, x: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (x + MoE(x), router_aux_coef · aux).

    ``p``: ``ln`` (d,), ``router`` (d, E) f32, ``w_gate`` / ``w_up`` (E, d,
    ff), ``w_down`` (E, ff, d), and ``shared`` {``w_gate``, ``w_up``,
    ``w_down``} when the model has shared experts.  Every one of the
    ``B·S`` rows is routed, padding rows too, as in the reference: they
    take capacity from the others."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    C = max(8, int(cfg.capacity_factor * T * k / E))      # slots per expert
    h = rms_norm(x, p["ln"], eps)
    flat = h.reshape(T, d)
    w, idx, aux = _route(flat @ p["router"].to(flat.dtype), k)
    plan = dispatch_plan(idx, E, C)

    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    buf = torch.where(plan["filled"][..., None], flat[plan["src"]], zero)
    g = F.silu(torch.bmm(buf, p["w_gate"]))
    u = torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(g * u, p["w_down"]).reshape(E * C, d)

    scale = (w.reshape(-1)[plan["order"]] * plan["keep"]).to(flat.dtype)
    gathered = out_buf[plan["slot"]] * scale[:, None]           # sorted order
    parts = gathered[plan["pos"]]                               # (T, k, d)
    combined = parts[:, 0]
    for j in range(1, k):
        combined = combined + parts[:, j]

    y = combined.reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        y = y + swiglu(h, sp["w_gate"], sp["w_up"], sp["w_down"])
    return x + y, cfg.router_aux_coef * aux
