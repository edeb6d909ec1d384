"""Mixture-of-Experts FFN: the counterpart of ``repro/models/moe.py``.

Top-k router with softmax-renormalised weights, capacity-limited sort
dispatch (Switch / GShard: the ``T·k`` assignments sorted by expert id,
ranked within each expert, those past capacity ``C`` dropped), three
batched expert matmuls over ``(E, C, d)``, and the weighted combine; plus
the optional shared experts (DeepSeekMoE).

Expert parallelism (the reference's ``set_moe_mesh`` /
``apply_moe_shard_map``): on a ``("data", "model")`` rank grid
(:func:`repro_torch.launch.mesh.make_moe_mesh`, or the one-process
:func:`~repro_torch.launch.mesh.make_sim_mesh`) a rank holds the experts
``[m·E/M, (m+1)·E/M)`` of its model index ``m``
(:func:`repro_torch.weights.expert_block`,
:func:`repro_torch.models.transformer.init_lm_rank`) and every other leaf
whole; ``set_moe_mesh(mesh, "shard_map")`` makes :func:`apply_moe` run
:func:`apply_moe_shard_map` on it.  A rank's expert block reaching
:func:`apply_moe` with no such grid registered raises.

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

__all__ = ["EXPERT_LEAF_PATTERNS", "expert_group_spec", "expert_axis",
           "dispatch_plan", "apply_moe", "apply_moe_shard_map",
           "set_moe_mesh"]

# path patterns of the per-expert weights (leading expert dim E).  The
# router, the MoE layernorm and the shared experts gossip with the dense
# group: "moe|w_gate" does NOT match "moe|shared|w_gate".
EXPERT_LEAF_PATTERNS = ("moe|w_gate", "moe|w_up", "moe|w_down")


def expert_axis(path: str):
    """The expert axis of the leaf at ``path``: 1 for a model's stacked
    expert leaf (``blocks|<pi>|moe|w_gate``: ``(n_blocks, E, ...)``), 0
    for a bare MoE layer's (``w_gate``: ``(E, ...)``), None for any other
    leaf (the router, the MoE norm and the shared experts:
    ``moe|shared|w_gate`` is no expert leaf)."""
    parts = path.split("|")
    if parts[-1] not in ("w_gate", "w_up", "w_down"):
        return None
    if len(parts) == 1:
        return 0
    if parts[-2] != "moe":
        return None
    return 1 if parts[0].endswith("blocks") else 0


def expert_group_spec(gossip_every: int = 0, wire: str = "f32",
                      schedule: str = ""):
    """Policy-group spec of the expert weights: ``gossip_every=0`` (the
    default) keeps each agent's experts local, ``k`` gossips them every
    k-th step, optionally at a cheaper ``wire`` or on their own
    ``schedule``.  Reached through ``RunConfig.gossip_groups="moe[:k]"``."""
    from repro_torch.core.bus import GroupSpec
    return GroupSpec("experts", EXPERT_LEAF_PATTERNS,
                     gossip_every=gossip_every, wire=wire, schedule=schedule)


# the grid the MoE FFN runs on, and how (see set_moe_mesh)
_MESH = {"mesh": None, "impl": "gspmd"}
MOE_IMPLS = ("gspmd", "shard_map")


def set_moe_mesh(mesh, impl: str = "gspmd") -> None:
    """Register the rank grid the MoE FFN runs on.  ``impl="shard_map"``
    makes :func:`apply_moe` run :func:`apply_moe_shard_map` on ``mesh``
    (a ``("data", "model")``
    :class:`~repro_torch.core.comm.GossipMesh`); ``"gspmd"`` only records
    the mesh and changes nothing: in the reference it adds sharding
    constraints for XLA's partitioner, which has no counterpart without a
    compiler.  ``set_moe_mesh(None)`` clears the registration."""
    if impl not in MOE_IMPLS:
        raise ValueError(f"impl {impl!r} not in {MOE_IMPLS}")
    _MESH["mesh"] = mesh
    _MESH["impl"] = impl


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


def _experts(flat, w, idx, wg, wu, wd, C: int) -> torch.Tensor:
    """Capacity dispatch, the expert FFN and the weighted combine over the
    experts of ``wg`` / ``wu`` / ``wd`` (``E_l`` of them): flat (T, d),
    routing weights ``w`` and expert ids ``idx`` (T, k), where id ``E_l``
    marks an assignment this rank does not serve (an expert of another
    rank).  The unserved ones sort last and take no slot; the owned ones
    are ranked among themselves, as in the reference's
    ``_dispatch_compute_combine``.  Returns the (T, d) combine, each
    token's served parts summed in ascending expert order."""
    T, d = flat.shape
    k = idx.shape[1]
    E_l = wg.shape[0]
    plan = dispatch_plan(idx, E_l + 1, C)
    order = plan["order"]
    keep = plan["keep"] & (idx.reshape(-1)[order] < E_l)
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    buf = torch.where(plan["filled"][:E_l, :, None], flat[plan["src"][:E_l]],
                      zero)
    g = F.silu(torch.bmm(buf, wg))
    u = torch.bmm(buf, wu)
    out_buf = torch.bmm(g * u, wd).reshape(E_l * C, d)

    scale = (w.reshape(-1)[order] * keep).to(flat.dtype)
    slot = plan["slot"].clamp(max=E_l * C - 1)
    gathered = out_buf[slot] * scale[:, None]                   # sorted order
    parts = gathered[plan["pos"]]                               # (T, k, d)
    combined = parts[:, 0]
    for j in range(1, k):
        combined = combined + parts[:, j]
    return combined


def apply_moe(p: Dict, cfg, x: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (x + MoE(x), router_aux_coef · aux).

    ``p``: ``ln`` (d,), ``router`` (d, E) f32, ``w_gate`` / ``w_up`` (E, d,
    ff), ``w_down`` (E, ff, d), and ``shared`` {``w_gate``, ``w_up``,
    ``w_down``} when the model has shared experts.  Every one of the
    ``B·S`` rows is routed, padding rows too, as in the reference: they
    take capacity from the others.  With a grid registered by
    ``set_moe_mesh(mesh, "shard_map")`` this is
    :func:`apply_moe_shard_map`; otherwise the expert leaves must hold all
    E experts (a rank's block raises)."""
    if _MESH["impl"] == "shard_map" and _MESH["mesh"] is not None:
        return apply_moe_shard_map(p, cfg, x, eps, _MESH["mesh"])
    E, k = cfg.n_experts, cfg.experts_per_token
    if p["w_gate"].shape[0] != E:
        raise ValueError(
            f"the expert leaves hold {p['w_gate'].shape[0]} of the config's "
            f"{E} experts: a rank's block runs only on its grid — register "
            "it with set_moe_mesh(mesh, 'shard_map')")
    B, S, d = x.shape
    T = B * S
    C = max(8, int(cfg.capacity_factor * T * k / E))      # slots per expert
    h = rms_norm(x, p["ln"], eps)
    flat = h.reshape(T, d)
    w, idx, aux = _route(flat @ p["router"].to(flat.dtype), k)
    combined = _experts(flat, w, idx, p["w_gate"], p["w_up"], p["w_down"], C)
    y = combined.reshape(B, S, d)
    if "shared" in p:
        sp = p["shared"]
        y = y + swiglu(h, sp["w_gate"], sp["w_up"], sp["w_down"])
    return x + y, cfg.router_aux_coef * aux


def apply_moe_shard_map(p: Dict, cfg, x: torch.Tensor, eps: float, mesh, *,
                        tp: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE FFN on a ``("data", "model")`` rank grid:
    the reference's ``apply_moe_shard_map``, one process a rank.

    ``p`` holds this rank's experts ``[m·E_l, (m+1)·E_l)`` (``E_l = E /
    M`` for model index ``m`` of ``M``) and every other leaf whole; ``x``
    is the caller's whole ``(B, S, d)`` on every rank.  With ``dp`` data
    ranks and ``T = B·S`` rows, ``use_dp = dp > 1 and T % dp == 0``: the
    rank routes the contiguous ``T / dp`` rows of its data index (else all
    T), with the capacity ``C = max(8, int(cf · T_l · k / E))`` of those
    ``T_l`` rows.  Routing runs on the replicated router; assignments to
    another rank's experts go unserved here and ranks count among the
    owned ones.  The rank's partial combine (its experts' parts in
    ascending expert order) is summed over the model axis — one
    activation-sized all-reduce — then, at ``use_dp``, aux is averaged
    over the data axis and the rows are all-gathered back to the whole
    ``(T, d)`` (the reference's GSPMD keeps them sharded instead).  The
    shared experts run on the whole ``h`` after the sum.

    ``tp=True`` is the tensor-parallel serving layout
    (:func:`repro_torch.models.transformer.lm_param_specs`): the shared
    experts hold the rank's columns of ``w_gate`` / ``w_up`` and rows of
    ``w_down``, and their partial is added to the routed partial before
    the one sum, which is tagged ``tp``; the reference's GSPMD sums the
    shared partial in an all-reduce of its own (ROADMAP §3).

    The gradient is the reference's: a replicated leaf's gradient is the
    whole one on every rank (the partial path's parts summed over the
    model axis, the data axis's rows summed over it, the aux term counted
    once), and the expert block's is its slice of the whole one.  On a
    CUDA tensor the sums run on the group's backend, through the host
    where ranks share a card over gloo."""
    from repro_torch.core import comm   # (core imports the kernels, which
    B, S, d = x.shape                   # import the models)
    E, k = cfg.n_experts, cfg.experts_per_token
    M, m = mesh.axis_size("model"), mesh.axis_index("model")
    if E % M:
        raise ValueError(f"{E} experts do not split over {M} model ranks")
    E_l = E // M
    if p["w_gate"].shape[0] != E_l:
        raise ValueError(
            f"the expert leaves hold {p['w_gate'].shape[0]} experts; model "
            f"rank {m} of {M} holds its block of {E_l} "
            "(repro_torch.weights.expert_block)")
    dp = mesh.axis_size("data") if "data" in mesh.axis_names else 1
    T = B * S
    use_dp = dp > 1 and T % dp == 0
    T_l = T // dp if use_dp else T
    C = max(8, int(cfg.capacity_factor * T_l * k / E))
    h = rms_norm(x, p["ln"], eps)
    flat = h.reshape(T, d)
    router, wg, wu, wd = p["router"], p["w_gate"], p["w_up"], p["w_down"]
    if use_dp:
        dg, di = mesh.group("data"), mesh.axis_index("data")
        flat = comm.shard_rows(flat, dg, dp, di)
        router, wg, wu, wd = (comm.sum_grads(t, dg, dp)
                              for t in (router, wg, wu, wd))
    w, idx, aux = _route(flat @ router.to(flat.dtype), k)
    if M > 1:
        mg = mesh.group("model")
        flat, w = comm.sum_grads(flat, mg, M), comm.sum_grads(w, mg, M)
    lo = m * E_l
    own = (idx >= lo) & (idx < lo + E_l)
    idx_local = torch.where(own, idx - lo, torch.full_like(idx, E_l))
    out = _experts(flat, w, idx_local, wg, wu, wd, C)
    shared = p.get("shared")
    if tp and shared is not None:
        out = out + swiglu(flat, shared["w_gate"], shared["w_up"],
                           shared["w_down"])
        shared = None
    if M > 1:
        out = comm.psum(out, mg, M, tag="tp" if tp else "moe")
    if use_dp:
        aux = comm.psum(aux, dg, dp) / dp
        out = comm.gather_rows(out, dg, dp, di)
    y = out.reshape(B, S, d)
    if shared is not None:
        y = y + swiglu(h, shared["w_gate"], shared["w_up"], shared["w_down"])
    return x + y, cfg.router_aux_coef * aux
