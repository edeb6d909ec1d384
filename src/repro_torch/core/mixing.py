"""Mixing engines: apply W to a tensor whose leading axis is the agent axis.

The counterpart of ``repro/core/mixing.py`` for the engines that run with
every agent on one device (tests assert they agree):

* :func:`mix_dense`    — explicit ``W @ x`` over the agent axis; the oracle.
* :func:`mix_shifts`   — weighted sum of agent-axis rolls, one per
  :class:`~repro_torch.core.topology.ShiftTerm`.
* :func:`mix_ppermute` — the ``ppermute`` engine on one device.  In JAX,
  with all A agents on one device (``agents_per_device = A``, M = 1), every
  term's blocked roll needs no permute and reduces to a local roll of the
  agent axis; the weighted combine is then ONE fused ``gossip_axpy``
  kernel (``use_fused_kernel=True``) or the plain weighted sum.  Spreading
  agents over more than one device is multi-GPU gossip, not ported yet.

Roll semantics are ``x_new[i] = x[(i − shift) % n]``
(:meth:`Topology.term_sources`), which ``torch.roll(x, shift, 0)`` gives.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import ops as kops

from .topology import ShiftTerm, Topology

__all__ = ["mix_dense", "mix_shifts", "mix_ppermute", "make_mixer",
           "build_mixer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def mix_dense(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    """Oracle engine: dense W matmul over the agent axis; sub-f32 inputs
    accumulate in f32 and round once on the way out."""
    W = torch.as_tensor(topo.dense_matrix(), dtype=torch.float32,
                        device=x.device)
    flat = x.reshape(x.shape[0], -1)
    if x.dtype in _LOW_PRECISION:
        flat = flat.float()
    return (W.to(flat.dtype) @ flat).reshape(x.shape).to(x.dtype)


def mix_shifts(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    """W as a weighted sum of agent-axis rolls, accumulated in x's dtype."""
    A = x.shape[0]
    assert A == topo.n_agents, (A, topo.n_agents)
    P, D = topo.grid_shape()
    acc = None
    for t in topo.terms:
        if t.shift == 0 or (t.level == "flat" and A == 1):
            term = x * t.weight
        elif t.level == "flat":
            term = torch.roll(x, t.shift, 0) * t.weight
        else:
            # reshape the agent axis to the (P, D) grid; roll one sub-axis
            g = x.reshape((P, D) + tuple(x.shape[1:]))
            axis = 0 if t.level == "inter" else 1
            term = (torch.roll(g, t.shift, axis) * t.weight).reshape(x.shape)
        acc = term if acc is None else acc + term
    return acc


def _local_term(topo: Topology, x: torch.Tensor, t: ShiftTerm) -> torch.Tensor:
    """One term's payload when all agents share one device: the JAX
    engine's blocked roll with M = 1, which ships nothing."""
    if t.shift == 0 or topo.n_agents == 1:
        return x
    P, D = topo.grid_shape()
    if t.level == "flat":
        return torch.roll(x, t.shift, 0)
    if t.level == "inter":
        # an inter roll by s pods is the flat roll by s·D agents
        return torch.roll(x, t.shift * D, 0)
    g = x.reshape((P, D) + tuple(x.shape[1:]))
    return torch.roll(g, t.shift, 1).reshape(x.shape)


def mix_ppermute(topo: Topology, x: torch.Tensor, *,
                 agents_per_device: int,
                 use_fused_kernel: bool = False) -> torch.Tensor:
    """The ``ppermute`` engine with every agent on one device."""
    A = topo.n_agents
    if agents_per_device < 1 or A % agents_per_device:
        raise ValueError(f"agent count {A} must be a multiple of "
                         f"agents_per_device={agents_per_device}")
    n_devices = A // agents_per_device
    if n_devices != 1:
        raise NotImplementedError(
            f"ppermute gossip over {n_devices} devices (agents_per_device="
            f"{agents_per_device} < {A} agents) is multi-GPU gossip, which "
            "the port does not have yet (ROADMAP.md); pass "
            f"agents_per_device={A} to keep every agent on one device")
    payloads = [_local_term(topo, x, t) for t in topo.terms]
    weights = [float(t.weight) for t in topo.terms]
    if use_fused_kernel:
        return kops.gossip_axpy(payloads, weights)
    acc = None
    for w, p in zip(weights, payloads):
        term = w * p
        acc = term if acc is None else acc + term
    return acc


def make_mixer(topo: Topology, engine: str = "shifts", *,
               agents_per_device: int = 1,
               use_fused_kernel: bool = False) -> Callable:
    """Return ``mix(x) -> x``.  engine ∈ {"dense", "shifts", "ppermute"};
    ``agents_per_device`` and ``use_fused_kernel`` are read by the
    ppermute engine only, as in the JAX package."""
    if engine == "dense":
        return lambda x: mix_dense(topo, x)
    if engine == "shifts":
        return lambda x: mix_shifts(topo, x)
    if engine == "ppermute":
        return lambda x: mix_ppermute(topo, x,
                                      agents_per_device=agents_per_device,
                                      use_fused_kernel=use_fused_kernel)
    raise ValueError(f"unknown mixing engine: {engine}")


def build_mixer(topo: Topology, *, mode: str = "schedule",
                engine: str = "shifts", agents_per_device: int = 1,
                use_fused_kernel: bool = False) -> Callable:
    """Mixer for a static topology: ``mode="static"`` returns ``mix(x)``,
    ``mode="schedule"`` the step-indexed ``mix(x, step=0)`` the trainer
    calls (one round, so the step is ignored).  Time-varying schedules and
    the overlap mode are not ported yet (ROADMAP.md)."""
    if not isinstance(topo, Topology):
        raise NotImplementedError(
            f"gossip schedules other than a static topology are not ported "
            f"yet (got {type(topo).__name__}; see ROADMAP.md)")
    mix = make_mixer(topo, engine, agents_per_device=agents_per_device,
                     use_fused_kernel=use_fused_kernel)
    if mode == "static":
        return mix
    if mode == "schedule":
        return lambda x, step=0: mix(x)
    raise NotImplementedError(f"mixer mode {mode!r} is not ported yet "
                              "(ROADMAP.md); use 'static' or 'schedule'")
