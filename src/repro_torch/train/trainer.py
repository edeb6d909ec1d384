"""Decentralized trainer of the port: the counterpart of
``repro/train/trainer.py`` with every agent on one device.

The train state carries all A agents, in one of two layouts:

* the packed bus (EDM only; the default for ``algorithm="edm"`` with the
  ``ppermute`` engine)::

      params : (A, rows, 128) f32 bus — x
      opt    : {"m": bus, "psi": bus}  (+ "e": bus, the wire's EF residual)
      step   : int

* the tree (every algorithm of ``ALGORITHMS``; ``packed_bus=False`` or
  any algorithm but EDM)::

      params : {path: (A, *shape)} in the leaves' dtypes
      opt    : the algorithm's state trees (m, psi, e, y, g_prev)
      step   : int

A step takes the gradient of each agent's OWN loss (the JAX step's
``vmap(value_and_grad)``: the logged loss is the mean), scales it by the
LR schedule (``warmup_steps`` / ``total_steps``: ``warmup_cosine`` as
gradient scaling), runs the optimizer and the gossip, and reports the mean
loss, the consensus distance and the gradient norm.  On the bus the EDM
update is one fused kernel and the gossip one combine
(``use_fused_kernel=True``); on the tree, one of each per leaf.

Ported: both layouts, static topologies and the time-varying schedules,
the dense/shifts/one-device ppermute engines, ``gossip_every > 1``,
``gossip_dtype`` (a cast gossip payload) and the error-feedback gossip
wire (bus only).  Elastic rounds, overlap, policy groups and multi-device
gossip are listed in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as parambus
from repro_torch.core.metrics import (bus_consensus, bus_grad_norm,
                                      consensus_distance, tree_sqnorm)
from repro_torch.core.mixing import accumulate_f32, build_mixer, tree_map
from repro_torch.core.optimizers import (DecOptimizer, make_edm_bus,
                                         make_edm_bus_ef, make_optimizer)
from repro_torch.core.schedule import GossipSchedule, make_schedule
from repro_torch.core.topology import (Topology, exp_graph, fully_connected,
                                       hierarchical, ring, torus2d)
from repro_torch.core.wire import WIRE_FORMATS, make_codec
from repro_torch.device import resolve_device
from repro_torch.models.api import Model
from repro_torch.optim import scale_grads, warmup_cosine
from repro_torch.weights import params_to_bus

__all__ = ["Features", "StaticBusStep", "resolve_features", "make_topology",
           "make_gossip_schedule", "gossip_round_step", "bus_layout_for",
           "init_state", "losses_and_grads", "tree_losses_and_grads",
           "build_train_step"]

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
    """What the train step runs (the JAX package's feature matrix, without
    overlap and groups).  ``packed_bus``: the bus-resident EDM step, else
    the tree.  ``wire``: the error-feedback gossip wire format ("f32" = the
    uncompressed wire)."""

    packed_bus: bool
    wire: str = "f32"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet "
                              "(see ROADMAP.md)")


def _is_f32(gossip_dtype) -> bool:
    return gossip_dtype in ("float32", "", None)


def resolve_features(run: RunConfig) -> Features:
    """Resolve ``run`` to its :class:`Features` with the JAX package's
    rules: an explicit ``packed_bus`` wins (True needs
    ``algorithm="edm"``); ``None`` turns the bus on for
    ``algorithm="edm"`` + ``gossip_engine="ppermute"``.  A wire other than
    f32 needs the bus and excludes a ``gossip_dtype`` cast.  Raises for
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
        if not _is_f32(run.gossip_dtype):
            raise ValueError(
                "wire != 'f32' is mutually exclusive with gossip_dtype != "
                "float32 (the error-feedback codec replaces the "
                "cast-on-wire lever)")
    if run.gossip_groups:
        _not_ported("gossip_groups")
    return Features(packed, fmt)


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
    """All agents start from the same x(0) (the paper's initialization):
    packed ONCE into the bus, or replicated into ``(A, *shape)`` leaves
    with the algorithm's state ``opt.init(params)``.  ``params`` (one
    agent's parameter dict, e.g. from :mod:`repro_torch.weights`) replaces
    the random init from ``seed``.  ``device`` defaults to ``cuda`` and
    raises without one."""
    dev = resolve_device(device)
    feats = resolve_features(run)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {p: v.to(dev) for p, v in params.items()}
    if not feats.packed_bus:
        tree = {p: v.unsqueeze(0).repeat((n_agents,) + (1,) * v.dim())
                for p, v in params.items()}
        opt = make_optimizer(run.algorithm, alpha=run.alpha, beta=run.beta,
                             mix=lambda t: t)
        return {"params": tree, "opt": opt.init(tree), "step": 0}
    x_bus = params_to_bus(bus_layout_for(model, n_agents), params, n_agents)
    opt_state = make_edm_bus(run.alpha, run.beta, mix=lambda t: t).init(x_bus)
    if feats.wire != "f32":
        # the EF residual, e(0) = 0: step 0 sends Q(φ(0))
        opt_state["e"] = torch.zeros_like(x_bus)
    return {"params": x_bus, "opt": opt_state, "step": 0}


GradMap = Optional[Callable[[Dict[str, torch.Tensor]],
                            Dict[str, torch.Tensor]]]


def losses_and_grads(model: Model, layout: parambus.BusLayout,
                     x_bus: torch.Tensor, tokens: torch.Tensor,
                     grad_map: GradMap = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent losses ``(A,)`` and the f32 gradient bus: agent ``a``'s
    parameters are unpacked from row block ``a`` of ``x_bus`` (cast to
    their own dtypes), and the gradient of agent ``a``'s OWN loss on
    ``tokens[a]`` — through ``grad_map`` (the LR schedule's scaling), in
    the leaves' dtypes — is packed into row block ``a`` of the gradient
    bus: the JAX step's ``vmap(value_and_grad(loss))``, one agent at a
    time."""
    g_bus = torch.zeros_like(x_bus)
    losses = []
    for a in range(x_bus.shape[0]):
        leaves = {p: v.detach().requires_grad_()
                  for p, v in parambus.unpack_agent(layout, x_bus, a).items()}
        loss = model.loss(leaves, {"tokens": tokens[a]})
        grads = dict(zip(layout.paths, torch.autograd.grad(
            loss, [leaves[p] for p in layout.paths])))
        if grad_map is not None:
            grads = grad_map(grads)
        parambus.pack_agent(layout, g_bus, a, grads)
        losses.append(loss.detach())
    return torch.stack(losses), g_bus


def tree_losses_and_grads(model: Model, params: Dict[str, torch.Tensor],
                          tokens: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tree version of :func:`losses_and_grads`: per-agent losses
    ``(A,)`` and ``{path: (A, *shape)}`` gradients in the leaves' dtypes,
    row ``a`` the gradient of agent ``a``'s own loss at its own
    parameters ``params[path][a]``."""
    grads = {p: torch.empty_like(v) for p, v in params.items()}
    losses = []
    for a in range(tokens.shape[0]):
        leaves = {p: v[a].detach().requires_grad_()
                  for p, v in params.items()}
        loss = model.loss(leaves, {"tokens": tokens[a]})
        for p, g in zip(leaves, torch.autograd.grad(loss,
                                                    list(leaves.values()))):
            grads[p][a].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses), grads


def _cast_mixer(mix: Callable, dtype: Optional[str]) -> Callable:
    """Gossip a payload cast to ``dtype`` (the ``gossip_dtype`` lever);
    :func:`accumulate_f32` restores the leaves' dtypes on the way out."""
    if _is_f32(dtype):
        return mix
    dt = getattr(torch, dtype)
    return accumulate_f32(lambda tree: mix(tree_map(lambda x: x.to(dt),
                                                    tree)))


@dataclasses.dataclass(frozen=True)
class StaticBusStep:
    """The bus step over a static state: what a CUDA graph captures
    (:func:`repro_torch.train.graphs.graph_train_step`).

    ``run(state, tokens, lr_scale)`` takes ``state["step"]``'s step,
    writes x', m', ψ' (and e') over the state's own buffers — a fused
    combine writes the new x into x's buffer, which is dead once φ exists;
    any other mix is copied there at the end — and
    returns the metrics as device tensors; ``state["step"]`` is left for
    the caller to advance.  ``lr_scale`` is a 0-d f32 tensor on the
    state's device holding ``lr_schedule(step)`` (None without a
    schedule), so the step reads the scale from device memory rather than
    from the host.  ``key(step)`` is what else the step depends on: the
    schedule round and whether it gossips."""

    run: Callable
    key: Callable[[int], Tuple[int, bool]]
    lr_schedule: Optional[Callable]


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
    CUDA kernels: one launch of each per step on the bus, one per leaf on
    the tree (the fused EDM update for ``algorithm="edm"`` only, as in the
    JAX package).  The mixer's transport is ``"auto"``, as in the JAX
    trainer: a flat ring's fused combine on the bus runs the ring kernel.  With ``run.wire`` bf16 or int8 a gossip step runs
    :func:`make_edm_bus_ef` (the fused EDM + quantize kernel, then the
    decode-combine); a step that ``gossip_every > 1`` skips runs the
    algorithm with the identity mixer (on the bus the plain EDM recursion,
    carrying the residual ``e`` untouched).  ``run.gossip_dtype`` casts
    the gossip payload; ``run.warmup_steps`` / ``run.total_steps`` turn on
    ``warmup_cosine`` as gradient scaling.  The bus step consumes its
    input state: the new m, ψ (and e) are written over the old buffers.
    ``device`` defaults to ``cuda`` and raises without one; the state must
    live there.

    On the bus the returned step carries ``train_step.static``, the same
    step over a static state (:class:`StaticBusStep`); on the tree it is
    None.
    """
    dev = resolve_device(device)
    feats = resolve_features(run)
    A = topo.n_agents
    layout = bus_layout_for(model, A) if feats.packed_bus else None
    codec = (make_codec(feats.wire, layout.block_rows)
             if feats.wire != "f32" else None)
    mix = build_mixer(topo, mode="schedule", engine=run.gossip_engine,
                      agents_per_device=run.agents_per_device,
                      use_fused_kernel=use_fused_kernel, wire=codec)
    every = run.gossip_every
    kw = (dict(use_fused_kernel=use_fused_kernel)
          if run.algorithm == "edm" else {})
    lr_sched = None
    if run.warmup_steps or run.total_steps:
        lr_sched = warmup_cosine(run.warmup_steps or 1,
                                 run.total_steps or 10**9)

    def grad_map(step: int, lr_scale=None) -> GradMap:
        if lr_sched is None:
            return None
        sched = lr_sched if lr_scale is None else (lambda _: lr_scale)
        return lambda grads: scale_grads(grads, step, sched)

    def bus_opt(g_step: int, gossip: bool, out=None) -> DecOptimizer:
        """The step's bus optimizer; a fused combine writes its mix into
        ``out`` when given (the static state's x)."""
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
        if codec is None:
            step_mix = (functools.partial(mix, step=g_step, out=out)
                        if _is_f32(run.gossip_dtype) else _cast_mixer(
                            functools.partial(mix, step=g_step),
                            run.gossip_dtype))
            return make_edm_bus(run.alpha, run.beta, step_mix,
                                use_fused_kernel=use_fused_kernel)
        return make_edm_bus_ef(run.alpha, run.beta,
                               functools.partial(mix, step=g_step, out=out),
                               codec, use_fused_kernel=use_fused_kernel)

    def tree_opt(g_step: int, gossip: bool) -> DecOptimizer:
        step_mix = (_cast_mixer(lambda t: mix(t, step=g_step),
                                run.gossip_dtype)
                    if gossip else (lambda t: t))
        return make_optimizer(run.algorithm, alpha=run.alpha, beta=run.beta,
                              mix=step_mix, **kw)

    def gossips(step: int) -> bool:
        return every <= 1 or step % every == every - 1

    def step_key(step: int) -> Tuple[int, bool]:
        rnd = (int(topo.round_index(gossip_round_step(step, every)))
               if isinstance(topo, GossipSchedule) else 0)
        return rnd, gossips(step)

    def bus_step(x, opt_state, tokens, step: int, out=None, lr_scale=None):
        """One bus step: ``(x', opt', metrics)``, x' written into ``out``
        when given."""
        losses, grads = losses_and_grads(model, layout, x, tokens,
                                         grad_map(step, lr_scale))
        with torch.no_grad():
            opt = bus_opt(gossip_round_step(step, every), gossips(step), out)
            new_x, new_opt = opt.step(x, grads, opt_state)
            metrics = {"loss": losses.mean(),
                       "consensus": bus_consensus(new_x),
                       "grad_norm": bus_grad_norm(grads)}
        return new_x, new_opt, metrics

    def static_run(state: TrainState, tokens, lr_scale=None) -> Dict:
        x, opt_state = state["params"], state["opt"]
        if (lr_sched is None) != (lr_scale is None):
            raise ValueError("lr_scale is the LR schedule's device scalar: "
                             "pass one exactly when the run has a schedule")
        new_x, new_opt, metrics = bus_step(x, opt_state, tokens,
                                           int(state["step"]), out=x,
                                           lr_scale=lr_scale)
        if new_x.data_ptr() != x.data_ptr():     # the mix was not fused
            x.copy_(new_x)
        if any(new_opt[k].data_ptr() != v.data_ptr()
               for k, v in opt_state.items()):
            raise RuntimeError("the static bus step left its state buffers")
        return metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        first = (params if feats.packed_bus
                 else next(iter(params.values())))
        if first.device.type != dev.type:
            raise ValueError(f"train state is on {first.device}, the step "
                             f"was built for {dev}")
        step = int(state["step"])
        if feats.packed_bus:
            new_x, new_opt, metrics = bus_step(params, state["opt"],
                                               batch["tokens"], step)
            return {"params": new_x, "opt": new_opt, "step": step + 1}, \
                metrics
        losses, grads = tree_losses_and_grads(model, params, batch["tokens"])
        if lr_sched is not None:
            grads = scale_grads(grads, step, lr_sched)
        with torch.no_grad():
            opt = tree_opt(gossip_round_step(step, every), gossips(step))
            new_x, new_opt = opt.step(params, grads, state["opt"])
            metrics = {"loss": losses.mean(),
                       "consensus": consensus_distance(new_x),
                       "grad_norm": tree_sqnorm(grads).sqrt()}
        return {"params": new_x, "opt": new_opt, "step": step + 1}, metrics

    train_step.static = (StaticBusStep(static_run, step_key, lr_sched)
                         if feats.packed_bus else None)
    return train_step
