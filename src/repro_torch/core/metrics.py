"""Diagnostics: the counterpart of ``repro/core/metrics.py``.

Tree metrics reduce in f32 with ``sum``, one leaf at a time (a tree is a
``{path: tensor}`` dict or one tensor; leaves carry the agent axis).  The
bus metrics use that the bus pads are zero, so one reduction over the
``(A, rows, 128)`` buffer equals the per-leaf reduction over the tree;
they reduce at most ``_ROWS`` rows of the bus at a time, one agent's part
of them at a time, so that the f32 temporaries stay under ~1.5 GiB
whatever the bus (an agent's block of Pixtral-12B's one-layer bus is
6 GiB, and ``bus_consensus`` held three such temporaries).  A bus of at
most ``_ROWS`` rows reduces as one range, as before.

:func:`grad_norm_at_mean`, :func:`heterogeneity_zeta2` (the paper's
data-heterogeneity ζ²) and :func:`consensus_distance_from_dev` sum their
agent-stacked trees one agent's block of a leaf at a time, as the bus
metrics sum one agent's rows at a time (a leaf-sized f32 norm on the CPU
drifted 5e-4 relative).

The ``*_ranks`` forms take a state spread over ranks (each rank its
block of agents) and the sums that join them; they reduce leaf by leaf
too, so no f32 copy of a whole tree is ever held.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .mixing import tree_map

__all__ = ["tree_sqnorm", "agent_mean", "consensus_distance",
           "bus_consensus", "bus_grad_norm", "bus_consensus_ranks",
           "bus_grad_norm_ranks", "consensus_distance_ranks",
           "tree_grad_norm_ranks", "grad_norm_at_mean",
           "heterogeneity_zeta2", "consensus_distance_from_dev"]


def _leaves(tree):
    return list(tree.values()) if isinstance(tree, Mapping) else [tree]


def tree_sqnorm(tree) -> torch.Tensor:
    """Σ over leaves of Σ leaf², each leaf squared and summed in f32."""
    return sum(leaf.float().square().sum() for leaf in _leaves(tree))


def agent_mean(tree):
    """x̄ = (1/n) Σ_i x_i over the leading agent axis (kept, size 1), in
    each leaf's dtype."""
    return tree_map(lambda leaf: leaf.mean(dim=0, keepdim=True), tree)


def consensus_distance(tree) -> torch.Tensor:
    """‖X − X̄‖²_F, the paper's deviation term, in f32; the deviation of
    each leaf is taken in its own dtype, as in the JAX package."""
    return sum((leaf - leaf.mean(dim=0, keepdim=True)).float().square().sum()
               for leaf in _leaves(tree))


# rows of the bus reduced at a time (512 MiB of f32 an agent)
_ROWS = 1 << 20


def _row_ranges(bus: torch.Tensor):
    """``(A, ≤ _ROWS, 128)`` views of the bus, in row order."""
    return (bus[:, r:r + _ROWS] for r in range(0, bus.shape[1], _ROWS))


def _sq_sum(rows) -> torch.Tensor:
    return sum(r.float().square().sum() for r in rows)


def bus_consensus(bus: torch.Tensor) -> torch.Tensor:
    """‖X − X̄‖²_F over the agent axis, in f32."""
    total = 0
    for blk in _row_ranges(bus):
        mean = blk.float().mean(dim=0)
        total = total + _sq_sum(b.float() - mean for b in blk)
    return total


def bus_grad_norm(g_bus: torch.Tensor) -> torch.Tensor:
    """Global gradient norm over a packed gradient bus, in f32."""
    return sum(_sq_sum(blk) for blk in _row_ranges(g_bus)).sqrt()


def bus_consensus_ranks(bus: torch.Tensor, n_agents: int, agent_sum,
                        total_sum) -> torch.Tensor:
    """:func:`bus_consensus` of a bus spread over ranks: ``bus`` is this
    rank's block (its agents' rows, or a row shard of them);
    ``agent_sum(t)`` sums ``t`` over the ranks that hold the other agents
    of these rows and ``total_sum(t)`` a scalar over every rank.  The mean
    is the agents' sum over ``n_agents``, so the value equals the
    one-process one up to the order of the sums."""
    total = torch.zeros((), dtype=torch.float32, device=bus.device)
    for blk in _row_ranges(bus):
        mean = agent_sum(blk.float().sum(dim=0)) / n_agents
        total = total + _sq_sum(b.float() - mean for b in blk)
    return total_sum(total)


def bus_grad_norm_ranks(g_bus: torch.Tensor, total_sum) -> torch.Tensor:
    """:func:`bus_grad_norm` of a gradient bus spread over ranks
    (``total_sum`` sums a scalar over every rank)."""
    sq = sum(_sq_sum(blk) for blk in _row_ranges(g_bus))
    return total_sum(torch.as_tensor(sq, dtype=torch.float32,
                                     device=g_bus.device)).sqrt()


def _kept(tree, skip):
    """``tree``'s leaves but those whose path is in ``skip``."""
    if not skip:
        return _leaves(tree)
    return [v for p, v in tree.items() if p not in skip]


def consensus_distance_ranks(tree, n_agents: int, agent_sum,
                             total_sum, skip=()) -> torch.Tensor:
    """:func:`consensus_distance` of a tree spread over ranks: ``tree`` is
    this rank's ``(B, ...)`` block of every leaf; ``agent_sum(t)`` sums
    ``t`` over the ranks that hold the other agents and ``total_sum(t)`` a
    scalar over every rank.  Each leaf's agent mean is the f32 sum over
    the agents divided by ``n_agents``, rounded once to the leaf's dtype
    as ``leaf.mean(dim=0)`` rounds it, and the deviation is taken in that
    dtype, so the value equals the one-process one up to the order of the
    sums.  The paths in ``skip`` are left out on this rank (a leaf that
    every model rank holds whole counts on one of them only; the ranks
    that ``agent_sum`` joins skip alike)."""
    total = None
    for leaf in _kept(tree, skip):
        mean = (agent_sum(leaf.float().sum(dim=0, keepdim=True))
                / n_agents).to(leaf.dtype)
        part = (leaf - mean).float().square().sum()
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=_leaves(tree)[0].device)
    return total_sum(total)


def tree_grad_norm_ranks(grads, total_sum, skip=()) -> torch.Tensor:
    """The global gradient norm of a tree spread over ranks: this rank's
    :func:`tree_sqnorm` (but the paths in ``skip``), summed over every
    rank (``total_sum``)."""
    kept = _kept(grads, skip)
    sq = (sum(leaf.float().square().sum() for leaf in kept) if kept
          else torch.zeros((), dtype=torch.float32,
                           device=_leaves(grads)[0].device))
    return total_sum(sq).sqrt()


def _agent_sqnorm(tree) -> torch.Tensor:
    """Σ over leaves and over each leaf's leading agent axis of Σ
    block², each agent's block squared and summed in f32."""
    return sum(blk.float().square().sum() for leaf in _leaves(tree)
               for blk in leaf)


def grad_norm_at_mean(grad_fn, params) -> torch.Tensor:
    """‖∇f(x̄)‖², where ``grad_fn`` maps one agent's tree (x̄: each leaf's
    mean over its leading agent axis, which is dropped) to its gradient
    tree."""
    mean = tree_map(lambda leaf: leaf.mean(dim=0), params)
    return tree_sqnorm(grad_fn(mean))


def consensus_distance_from_dev(dev) -> torch.Tensor:
    """‖dev‖²_F of an agent-stacked deviation tree (each leaf ``(A,
    ...)``), in f32, one agent's block at a time."""
    return _agent_sqnorm(dev)


def heterogeneity_zeta2(per_agent_grads) -> torch.Tensor:
    """ζ² = (1/n) Σ_i ‖∇f_i − ∇f‖², the per-agent gradients (each leaf
    ``(n, ...)``) taken at one common point; ∇f is their agent mean, the
    deviation taken in each leaf's dtype."""
    n = _leaves(per_agent_grads)[0].shape[0]
    dev = tree_map(lambda g: g - g.mean(dim=0, keepdim=True),
                   per_agent_grads)
    return consensus_distance_from_dev(dev) / n
