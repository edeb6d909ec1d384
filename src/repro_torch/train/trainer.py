"""Decentralized trainer of the port: the packed-bus EDM path of
``repro/train/trainer.py``.

The train state carries all A agents::

    params : (A, rows, 128) f32 bus — x
    opt    : {"m": bus, "psi": bus}
    step   : int

A step unpacks each agent's parameters from the bus, takes the gradient of
THAT agent's loss (the JAX step's ``vmap(value_and_grad)``: each agent gets
the gradient of its own loss, the logged loss is the mean), packs the
gradients into one f32 bus, runs the EDM update as one fused kernel and the
gossip as one combine (``use_fused_kernel=True``), and reports the mean
loss, the consensus distance and the gradient norm.

Ported: the packed bus, static topologies, the dense/shifts/one-device
ppermute engines and ``gossip_every > 1``.  The tree-resident path, other
algorithms, time-varying schedules, overlap, wire codecs, policy groups,
LR schedules and multi-device gossip are listed in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as parambus
from repro_torch.core.metrics import bus_consensus, bus_grad_norm
from repro_torch.core.mixing import build_mixer
from repro_torch.core.optimizers import make_edm_bus
from repro_torch.core.topology import (Topology, exp_graph, fully_connected,
                                       hierarchical, ring, torus2d)
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.weights import params_to_bus

__all__ = ["Features", "resolve_features", "make_topology",
           "gossip_round_step", "bus_layout_for", "init_state",
           "losses_and_grads", "build_train_step"]

TrainState = Dict[str, object]


def make_topology(run: RunConfig, n_agents: int, pods: int = 1) -> Topology:
    if run.topology == "ring":
        return ring(n_agents)
    if run.topology == "exp":
        return exp_graph(n_agents)
    if run.topology == "full":
        return fully_connected(n_agents)
    if run.topology == "torus":
        return torus2d(pods if pods > 1 else 1, n_agents // max(pods, 1))
    if run.topology == "hier":
        assert pods >= 1
        return hierarchical(pods, n_agents // pods)
    raise ValueError(run.topology)


def gossip_round_step(step: int, gossip_every: int) -> int:
    """Round clock of the gossip schedule: advances once per executed
    gossip when ``gossip_every = k > 1``."""
    return step // gossip_every if gossip_every > 1 else step


@dataclasses.dataclass(frozen=True)
class Features:
    """What the train step runs (the packed-bus part of the JAX
    package's feature matrix)."""

    packed_bus: bool


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              "(see ROADMAP.md)")


def resolve_features(run: RunConfig) -> Features:
    """Resolve ``run`` to its :class:`Features`, as the JAX package does
    for the packed bus (explicit ``packed_bus`` wins; ``None`` turns it on
    for ``algorithm="edm"`` + ``gossip_engine="ppermute"``), and raise for
    every lever the port does not run yet."""
    if run.packed_bus is not None:
        packed = bool(run.packed_bus)
        if packed and run.algorithm != "edm":
            raise ValueError(f"packed_bus supports algorithm='edm', got "
                             f"{run.algorithm!r}")
    else:
        packed = (run.algorithm == "edm" and run.gossip_engine == "ppermute"
                  and run.agents in ("data", "pod"))
    if run.agents != "data":
        _not_ported(f"agents={run.agents!r} (shard-resident pod agents)")
    if run.overlap not in ("off", "", None):
        _not_ported(f"overlap={run.overlap!r}")
    if (run.wire or "f32") != "f32":
        _not_ported(f"wire={run.wire!r}")
    if run.gossip_groups:
        _not_ported("gossip_groups")
    if run.gossip_dtype not in ("float32", "", None):
        _not_ported(f"gossip_dtype={run.gossip_dtype!r}")
    if run.gossip_schedule not in ("static", "", None):
        _not_ported(f"gossip_schedule={run.gossip_schedule!r}")
    if run.warmup_steps or run.total_steps:
        _not_ported("the warmup_cosine LR schedule")
    return Features(packed)


def _require_bus(feats: Features) -> None:
    if not feats.packed_bus:
        _not_ported("the tree-resident (unpacked) train state: run "
                    "algorithm='edm' with gossip_engine='ppermute' or "
                    "packed_bus=True")


def bus_layout_for(model: Model, n_agents: int) -> parambus.BusLayout:
    """Bus layout of ``model``'s parameters with a leading agent axis,
    built from ``meta`` tensors (no allocation)."""
    lifted = {p: torch.empty((n_agents,) + tuple(t.shape), dtype=t.dtype,
                             device="meta")
              for p, t in model.meta().items()}
    return parambus.make_layout(lifted)


def init_state(model: Model, run: RunConfig, n_agents: int, *,
               seed: int = 0, params: Optional[Dict[str, torch.Tensor]] = None,
               device=None) -> TrainState:
    """All agents start from the same x(0) (the paper's initialization),
    packed ONCE into the bus.  ``params`` (one agent's parameter dict, e.g.
    from :mod:`repro_torch.weights`) replaces the random init from
    ``seed``.  ``device`` defaults to ``cuda`` and raises without one."""
    dev = resolve_device(device)
    _require_bus(resolve_features(run))
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {p: v.to(dev) for p, v in params.items()}
    x_bus = params_to_bus(bus_layout_for(model, n_agents), params, n_agents)
    opt = make_edm_bus(run.alpha, run.beta, mix=lambda t: t)
    return {"params": x_bus, "opt": opt.init(x_bus), "step": 0}


def losses_and_grads(model: Model, layout: parambus.BusLayout,
                     x_bus: torch.Tensor, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent losses ``(A,)`` and the f32 gradient bus: agent ``a``'s
    parameters are unpacked from row block ``a`` of ``x_bus`` (cast to
    their own dtypes), and the gradient of agent ``a``'s OWN loss on
    ``tokens[a]`` is packed into row block ``a`` of the gradient bus —
    the JAX step's ``vmap(value_and_grad(loss))``, one agent at a time."""
    g_bus = torch.zeros_like(x_bus)
    losses = []
    for a in range(x_bus.shape[0]):
        leaves = {p: v.detach().requires_grad_()
                  for p, v in parambus.unpack_agent(layout, x_bus, a).items()}
        loss = model.loss(leaves, {"tokens": tokens[a]})
        grads = torch.autograd.grad(loss, [leaves[p] for p in layout.paths])
        parambus.pack_agent(layout, g_bus, a, dict(zip(layout.paths, grads)))
        losses.append(loss.detach())
    return torch.stack(losses), g_bus


def build_train_step(model: Model, run: RunConfig, topo: Topology,
                     use_fused_kernel: bool = False, *,
                     device=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch
    tokens are ``(A, per_agent_batch, S)``.

    ``run.gossip_engine`` selects the mixer (the ``ppermute`` engine needs
    ``run.agents_per_device = A``: one device).  ``use_fused_kernel``
    routes the EDM update and the ppermute engine's combine through the
    CUDA kernels, one launch each per step.  The step consumes its input
    state: the new m and ψ are written over the old buffers.  ``device``
    defaults to ``cuda`` and raises without one; the state must live there.
    """
    dev = resolve_device(device)
    _require_bus(resolve_features(run))
    A = topo.n_agents
    layout = bus_layout_for(model, A)
    mix = build_mixer(topo, mode="schedule", engine=run.gossip_engine,
                      agents_per_device=run.agents_per_device,
                      use_fused_kernel=use_fused_kernel)
    every = run.gossip_every

    def opt_at(g_step: int, gossip: bool):
        step_mix = ((lambda t: mix(t, step=g_step)) if gossip
                    else (lambda t: t))   # local-EDM step: identity mixer
        return make_edm_bus(run.alpha, run.beta, step_mix,
                            use_fused_kernel=use_fused_kernel)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        x_bus = state["params"]
        if x_bus.device.type != dev.type:
            raise ValueError(f"train state is on {x_bus.device}, the step "
                             f"was built for {dev}")
        losses, g_bus = losses_and_grads(model, layout, x_bus,
                                         batch["tokens"])
        step = int(state["step"])
        gossip = every <= 1 or step % every == every - 1
        with torch.no_grad():
            opt = opt_at(gossip_round_step(step, every), gossip)
            new_x, new_opt = opt.step(x_bus, g_bus, state["opt"])
            metrics = {"loss": losses.mean(),
                       "consensus": bus_consensus(new_x),
                       "grad_norm": bus_grad_norm(g_bus)}
        return {"params": new_x, "opt": new_opt, "step": step + 1}, metrics

    return train_step
