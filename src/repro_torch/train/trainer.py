"""Decentralized trainer of the port: the packed-bus EDM path of
``repro/train/trainer.py``.

The train state carries all A agents::

    params : (A, rows, 128) f32 bus — x
    opt    : {"m": bus, "psi": bus}  (+ "e": bus, the wire's EF residual)
    step   : int

A step unpacks each agent's parameters from the bus, takes the gradient of
THAT agent's loss (the JAX step's ``vmap(value_and_grad)``: each agent gets
the gradient of its own loss, the logged loss is the mean), packs the
gradients into one f32 bus, runs the EDM update as one fused kernel and the
gossip as one combine (``use_fused_kernel=True``), and reports the mean
loss, the consensus distance and the gradient norm.

Ported: the packed bus, static topologies and the time-varying schedules
(``round_robin``, ``alt_hier``), the dense/shifts/one-device ppermute
engines, ``gossip_every > 1`` and the error-feedback gossip wire
(``wire`` bf16 / int8: the fused EDM + quantize kernel and the
dequantize-combine).  The tree-resident path, other algorithms, elastic
rounds, overlap, policy groups, LR schedules and multi-device gossip are
listed in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as parambus
from repro_torch.core.metrics import bus_consensus, bus_grad_norm
from repro_torch.core.mixing import build_mixer
from repro_torch.core.optimizers import (DecOptimizer, make_edm_bus,
                                         make_edm_bus_ef)
from repro_torch.core.schedule import GossipSchedule, make_schedule
from repro_torch.core.topology import (Topology, exp_graph, fully_connected,
                                       hierarchical, ring, torus2d)
from repro_torch.core.wire import WIRE_FORMATS, make_codec
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.weights import params_to_bus

__all__ = ["Features", "resolve_features", "make_topology",
           "make_gossip_schedule", "gossip_round_step", "bus_layout_for", "init_state",
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


def make_gossip_schedule(run: RunConfig, n_agents: int,
                         pods: int = 1) -> GossipSchedule:
    """``RunConfig`` → step-indexed gossip schedule: ``"static"`` wraps
    :func:`make_topology`'s W, ``"round_robin"`` / ``"alt_hier"`` build
    the time-varying schedules (``gossip_period`` / ``gossip_seed`` are
    their knobs).  Churn (elastic rounds) is not ported yet."""
    topo = (make_topology(run, n_agents, pods)
            if run.gossip_schedule in ("static", "", None) else None)
    return make_schedule(run.gossip_schedule, n_agents, topo=topo,
                         pods=pods, period=run.gossip_period,
                         seed=run.gossip_seed)


def gossip_round_step(step: int, gossip_every: int) -> int:
    """Round clock of the gossip schedule: advances once per executed
    gossip when ``gossip_every = k > 1``."""
    return step // gossip_every if gossip_every > 1 else step


@dataclasses.dataclass(frozen=True)
class Features:
    """What the train step runs (the packed-bus part of the JAX
    package's feature matrix).  ``wire``: the error-feedback gossip wire
    format ("f32" = the uncompressed wire)."""

    packed_bus: bool
    wire: str = "f32"


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
    fmt = run.wire or "f32"
    if fmt not in WIRE_FORMATS:
        raise ValueError(f"RunConfig.wire must be one of {WIRE_FORMATS}, "
                         f"got {fmt!r}")
    if fmt != "f32":
        if not packed:
            raise ValueError(
                "wire != 'f32' needs the packed bus (DESIGN §9): the codec "
                "and the bus-resident residual operate on the (A, rows, "
                "128) superbuffer")
        if run.gossip_dtype not in ("float32", "", None):
            raise ValueError(
                "wire != 'f32' is mutually exclusive with gossip_dtype != "
                "float32 (the error-feedback codec replaces the "
                "cast-on-wire lever)")
    if run.gossip_groups:
        _not_ported("gossip_groups")
    if run.gossip_dtype not in ("float32", "", None):
        _not_ported(f"gossip_dtype={run.gossip_dtype!r}")
    if run.warmup_steps or run.total_steps:
        _not_ported("the warmup_cosine LR schedule")
    return Features(packed, fmt)


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
    feats = resolve_features(run)
    _require_bus(feats)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {p: v.to(dev) for p, v in params.items()}
    x_bus = params_to_bus(bus_layout_for(model, n_agents), params, n_agents)
    opt_state = make_edm_bus(run.alpha, run.beta, mix=lambda t: t).init(x_bus)
    if feats.wire != "f32":
        # the EF residual, e(0) = 0: step 0 sends Q(φ(0))
        opt_state["e"] = torch.zeros_like(x_bus)
    return {"params": x_bus, "opt": opt_state, "step": 0}


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


def build_train_step(model: Model, run: RunConfig, topo,
                     use_fused_kernel: bool = False, *,
                     device=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch
    tokens are ``(A, per_agent_batch, S)``.

    ``topo`` is a :class:`Topology` or a
    :class:`~repro_torch.core.schedule.GossipSchedule` (one round per
    gossip, on the round clock :func:`gossip_round_step`).
    ``run.gossip_engine`` selects the mixer (the ``ppermute`` engine needs
    ``run.agents_per_device = A``: one device).  ``use_fused_kernel``
    routes the EDM update and the ppermute engine's combine through the
    CUDA kernels, one launch each per step.  With ``run.wire`` bf16 or
    int8 a gossip step runs :func:`make_edm_bus_ef` (the fused EDM +
    quantize kernel, then the decode-combine); a step that
    ``gossip_every > 1`` skips runs the plain EDM recursion and carries
    the residual ``e`` untouched.  The step consumes its input state: the
    new m, ψ (and e) are written over the old buffers.  ``device``
    defaults to ``cuda`` and raises without one; the state must live
    there.
    """
    dev = resolve_device(device)
    feats = resolve_features(run)
    _require_bus(feats)
    A = topo.n_agents
    layout = bus_layout_for(model, A)
    codec = (make_codec(feats.wire, layout.block_rows)
             if feats.wire != "f32" else None)
    mix = build_mixer(topo, mode="schedule", engine=run.gossip_engine,
                      agents_per_device=run.agents_per_device,
                      use_fused_kernel=use_fused_kernel, wire=codec)
    every = run.gossip_every

    def opt_at(g_step: int, gossip: bool) -> DecOptimizer:
        if not gossip:
            # local-EDM step: identity mixer; nothing goes on the wire, so
            # nothing is quantized and e carries to the next gossip step
            inner = make_edm_bus(run.alpha, run.beta, lambda t: t,
                                 use_fused_kernel=use_fused_kernel)
            if codec is None:
                return inner

            def local_step(x, g, st):
                x2, sub = inner.step(x, g, {"m": st["m"], "psi": st["psi"]})
                return x2, {**sub, "e": st["e"]}

            return DecOptimizer("edm_bus_local", inner.init, local_step)
        step_mix = lambda t: mix(t, step=g_step)
        if codec is None:
            return make_edm_bus(run.alpha, run.beta, step_mix,
                                use_fused_kernel=use_fused_kernel)
        return make_edm_bus_ef(run.alpha, run.beta, step_mix, codec,
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
