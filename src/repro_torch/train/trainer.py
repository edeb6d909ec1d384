"""Decentralized trainer of the port: the counterpart of
``repro/train/trainer.py``, with every agent on one device or, on the bus,
a block of agents (or one agent's row shard) on each ``torch.distributed``
rank (``build_train_step(mesh=)``).

The train state carries all A agents, in one of two layouts:

* the packed bus (EDM only; the default for ``algorithm="edm"`` with the
  ``ppermute`` engine)::

      params : (A, rows, 128) f32 bus — x
      opt    : {"m": bus, "psi": bus}  (+ "e": bus, the wire's EF residual)
      step   : int
      pipeline : {"slot": (2, A, rows, 128), "parity": int}  (overlap only)

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

Ported: both layouts, static topologies, the time-varying schedules and
churn (an :class:`~repro_torch.core.elastic.ElasticSchedule`: liveness-
masked rounds, on the bus and on the tree), the dense/shifts/one-device
ppermute engines, ``gossip_every > 1``, ``gossip_dtype`` (a cast gossip
payload), the error-feedback gossip wire (bus only) and the overlapped
gossip pipeline (``overlap="delayed"``, bus only) with straggler plans,
and policy groups (``gossip_groups``, bus only: per-group cadence,
schedule and stateless wire over one bus, DESIGN §12).  Across ranks: the
bus step with any schedule, churn, the EF wire and ``gossip_every``, the
overlapped pipeline with straggler plans, and policy groups, one agent or
a block of agents a rank, or ``agents="pod"`` with row shards; the tree
path (every algorithm) with one agent or a block of agents a rank, any
schedule, churn, ``gossip_every`` and the ``gossip_dtype`` cast.  Under
tensor parallelism (a ``("data", "model")`` rank grid, the reference's
``state_specs`` layout: :func:`state_specs`, :func:`prepend_agent_axis`,
:func:`batch_spec_tree`): the tree path of the dense family, agents over
``data`` and every leaf of an agent split over ``model``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as parambus
from repro_torch.core.metrics import (bus_consensus, bus_consensus_ranks,
                                      bus_grad_norm, bus_grad_norm_ranks,
                                      consensus_distance,
                                      consensus_distance_ranks,
                                      tree_grad_norm_ranks, tree_sqnorm)
from repro_torch.core.elastic import DropPlan, ElasticSchedule, StragglerPlan
from repro_torch.core.mixing import (GroupPlan, accumulate_f32, build_mixer,
                                     make_group_mixer, tree_map)
from repro_torch.core.optimizers import (DecOptimizer, make_edm_bus,
                                         make_edm_bus_ef, make_optimizer)
from repro_torch.core.schedule import (GossipSchedule, StaticSchedule,
                                       make_schedule)
from repro_torch.core.topology import (Topology, exp_graph, fully_connected,
                                       hierarchical, ring, torus2d)
from repro_torch.core.wire import WIRE_FORMATS, WireCodec, make_codec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import edm_update_ref
from repro_torch.core import comm as coll
from repro_torch.core.comm import axes_group, gossip_agent_axes, rank_block
from repro_torch.core.sharding import P, shard_params
from repro_torch.models.api import Model, build_model
from repro_torch.models.transformer import (check_tp_split, check_tp_train,
                                            init_lm_rank)
from repro_torch.models.mamba import ssm_state_group_spec
from repro_torch.models.moe import expert_group_spec
from repro_torch.optim import scale_grads, warmup_cosine
from repro_torch.weights import params_to_bus

__all__ = ["Features", "StaticBusStep", "resolve_features",
           "resolve_group_specs", "make_topology", "make_gossip_schedule",
           "gossip_round_step", "bus_layout_for", "make_group_plans",
           "init_state", "losses_and_grads", "tree_losses_and_grads",
           "build_train_step", "prepend_agent_axis", "state_specs",
           "batch_spec_tree"]

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


def make_gossip_schedule(run: RunConfig, n_agents: int, pods: int = 1,
                         churn=None) -> GossipSchedule:
    """``RunConfig`` → step-indexed gossip schedule: ``"static"`` wraps
    :func:`make_topology`'s W, ``"round_robin"`` / ``"alt_hier"`` build
    the time-varying schedules (``gossip_period`` / ``gossip_seed`` are
    their knobs).

    ``churn`` (DESIGN §8) wraps the result in an
    :class:`~repro_torch.core.elastic.ElasticSchedule`: a
    :class:`~repro_torch.core.elastic.DropPlan`, or what
    ``DropPlan.from_json`` takes (a path, inline JSON, a dict).  The
    degraded schedule is checked against Assumption 1 per liveness epoch
    here, so a plan that breaks mixing fails at build time."""
    topo = (make_topology(run, n_agents, pods)
            if run.gossip_schedule in ("static", "", None) else None)
    sched = make_schedule(run.gossip_schedule, n_agents, topo=topo,
                          pods=pods, period=run.gossip_period,
                          seed=run.gossip_seed)
    if churn is not None:
        plan = churn if isinstance(churn, DropPlan) \
            else DropPlan.from_json(churn)
        sched = ElasticSchedule(sched, plan)
        sched.check_assumption1()
    return sched


def gossip_round_step(step: int, gossip_every: int) -> int:
    """Round clock of the gossip schedule: advances once per executed
    gossip when ``gossip_every = k > 1``."""
    return step // gossip_every if gossip_every > 1 else step


@dataclasses.dataclass(frozen=True)
class Features:
    """What the train step runs (the JAX package's feature matrix).
    ``packed_bus``: the bus-resident EDM step, else the tree.
    ``overlap``: the delayed gossip pipeline.  ``wire``: the
    error-feedback gossip wire format ("f32" = the uncompressed wire).
    ``groups``: the policy-group specs (empty: one default group, the
    ungrouped bus)."""

    packed_bus: bool
    overlap: bool = False
    wire: str = "f32"
    groups: Tuple[parambus.GroupSpec, ...] = ()


def _is_f32(gossip_dtype) -> bool:
    return gossip_dtype in ("float32", "", None)


def resolve_features(run: RunConfig) -> Features:
    """Resolve ``run`` to its :class:`Features` with the JAX package's
    rules: an explicit ``packed_bus`` wins (True needs
    ``algorithm="edm"``); ``None`` turns the bus on for
    ``algorithm="edm"`` + ``gossip_engine="ppermute"``.
    ``overlap="delayed"`` (DESIGN §6) needs the bus (one in-flight
    buffer), ``gossip_every == 1`` (a payload in flight every step) and no
    ``gossip_dtype`` cast (the wire codec composes instead).  A wire other
    than f32 needs the bus and excludes a ``gossip_dtype`` cast; policy
    groups need the bus and exclude the overlap, a run-level wire and the
    cast.  Raises ``ValueError`` for every combination they rule out."""
    if run.packed_bus is not None:
        packed = bool(run.packed_bus)
        if packed and run.algorithm != "edm":
            raise ValueError(f"packed_bus supports algorithm='edm', got "
                             f"{run.algorithm!r}")
    else:
        packed = (run.algorithm == "edm" and run.gossip_engine == "ppermute"
                  and run.agents in ("data", "pod"))
    if run.agents not in ("data", "pod"):
        raise ValueError(f"RunConfig.agents must be 'data' or 'pod', got "
                         f"{run.agents!r}")
    overlap = run.overlap not in ("off", "", None)
    if overlap:
        if run.overlap != "delayed":
            raise ValueError(f"RunConfig.overlap must be 'off' or "
                             f"'delayed', got {run.overlap!r}")
        if not packed:
            raise ValueError(
                "overlap='delayed' needs the packed bus (DESIGN §6): the "
                "in-flight payload is one (A, rows, 128) buffer, not a leaf "
                "set — use algorithm='edm' with gossip_engine='ppermute' or "
                "packed_bus=True")
        if run.gossip_every != 1:
            raise ValueError("overlap='delayed' composes with gossip_every=1 "
                             "only (the pipeline keeps a payload in flight "
                             "every step)")
        if not _is_f32(run.gossip_dtype):
            raise ValueError(
                "overlap='delayed' rejects the gossip_dtype cast lever (use "
                "the error-feedback wire codec RunConfig.wire instead, which "
                "composes)")
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
    groups = resolve_group_specs(run)
    if groups:
        if not packed:
            raise ValueError(
                "gossip_groups need the packed bus (DESIGN §12): policy "
                "groups are row ranges of the (A, rows, 128) superbuffer — "
                "use algorithm='edm' with gossip_engine='ppermute' or "
                "packed_bus=True")
        if run.gossip_every != 1:
            raise ValueError(
                "gossip_groups replace the run-level gossip_every: set "
                "gossip_every=1 and put the cadence on each group's "
                "gossip_every instead (DESIGN §12)")
        if overlap:
            raise ValueError(
                "gossip_groups do not compose with overlap='delayed' (the "
                "pipeline carries one whole-bus payload) — run "
                "overlap='off'")
        if fmt != "f32":
            raise ValueError(
                "gossip_groups exclude the run-level error-feedback wire "
                "(the EF residual is whole-bus); set per-group wire formats "
                "in the group specs instead (stateless quantization)")
        if not _is_f32(run.gossip_dtype):
            raise ValueError(
                "gossip_groups exclude the gossip_dtype cast lever; set "
                "per-group wire formats in the group specs instead")
    return Features(packed, overlap, fmt, groups)


def resolve_group_specs(run: RunConfig) -> Tuple[parambus.GroupSpec, ...]:
    """``RunConfig.gossip_groups`` → group specs, as the JAX package reads
    it: ``""`` (no groups: the ungrouped bus), a JSON list of specs (the
    ``--gossip-groups`` payload,
    :func:`repro_torch.core.bus.group_specs_from_json`), or
    comma-separated presets, one group each in the order given:
    ``moe[:k]`` puts the expert leaves in their own group
    (:func:`repro_torch.models.moe.expert_group_spec`), ``ssm[:k]`` the
    conv / SSM state leaves (:func:`repro_torch.models.mamba.
    ssm_state_group_spec`); ``k`` is the group's ``gossip_every``, 0 by
    default: never gossip.  Any other preset name raises ``ValueError``."""
    spec = (run.gossip_groups or "").strip()
    if not spec:
        return ()
    if spec.startswith("["):
        return parambus.group_specs_from_json(json.loads(spec))
    specs = []
    for tok in spec.split(","):
        name, _, every = tok.strip().partition(":")
        k = int(every) if every else 0
        if name == "moe":
            specs.append(expert_group_spec(gossip_every=k))
        elif name == "ssm":
            specs.append(ssm_state_group_spec(gossip_every=k))
        else:
            raise ValueError(
                f"unknown gossip-groups preset {name!r}: expected "
                "'moe[:k]', 'ssm[:k]', or a JSON list of group specs "
                '([{"name": ..., "match": [...], "gossip_every": ..., '
                '"wire": ...}, ...])')
    return tuple(specs)


# the reference's name in ``repro.train`` for the bus layout of a model
bus_layout_for = parambus.layout_of


def make_group_plans(run: RunConfig, layout: parambus.BusLayout,
                     sched: GossipSchedule, pods: int = 1
                     ) -> List[GroupPlan]:
    """A grouped layout's plans (:class:`~repro_torch.core.mixing.GroupPlan`).

    Every gossiping group gets a schedule — ``sched`` unless the group
    names its own, which is built by :func:`make_gossip_schedule` *without*
    churn, as the reference builds it (``repro/train/trainer.py:314``):
    under an :class:`~repro_torch.core.elastic.ElasticSchedule` the
    override group keeps mixing its full rounds while the others mix the
    degraded ones (ROADMAP.md §3).  Assumption 1 is re-checked for each
    group's schedule, so a policy that breaks mixing for any group fails
    here.  Opt-out groups get no schedule and no codec; a bf16 / int8
    group a stateless codec on the layout's ``block_rows``."""
    plans = []
    for g in layout.groups:
        if g.gossip_every == 0 or g.rows == 0:
            plans.append(GroupPlan(g))
            continue
        gsched = sched
        if g.schedule:
            gsched = make_gossip_schedule(
                dataclasses.replace(run, gossip_schedule=g.schedule),
                sched.n_agents, pods)
        gsched.check_assumption1()
        codec = (make_codec(g.wire, layout.block_rows)
                 if g.wire != "f32" else None)
        plans.append(GroupPlan(g, gsched, codec))
    return plans


# ---------------------------------------------------------------------------
# sharding specs (the reference's state_specs / batch_spec_tree)
# ---------------------------------------------------------------------------

def prepend_agent_axis(spec: P, agent_axis, fsdp_axis: Optional[str] = None
                       ) -> P:
    """The ``(A, *shape)`` leaf spec of a leaf spec: the agent axis over
    ``agent_axis``, and with ``fsdp_axis`` (``agents="pod"``) the first
    unsharded weight dim over it — a stacked block leaf's leading layer
    dim (entry 0 ``None`` of a longer spec) is skipped, as the
    reference's (sharding the stack would be layer parallelism).  A
    paired cut keeps its ``groups``."""
    entries = list(spec)
    if fsdp_axis is not None:
        start = 1 if (len(entries) > 1 and entries[0] is None) else 0
        for i in range(start, len(entries)):
            if entries[i] is None:
                entries[i] = fsdp_axis
                break
    return P(agent_axis, *entries, groups=spec.groups)


def state_specs(model: Model, run: RunConfig, multi_pod: bool) -> Dict:
    """The train state's partition specs under the run's agent
    granularity, the reference's ``state_specs``: on the packed bus one
    spec for every bus (``P(("pod", "data") or "data")`` with
    ``agents="data"``, the bus rows over ``data`` with ``agents="pod"``;
    the EF residual and the overlap pipeline's slots beside them); on the
    tree every leaf's :meth:`Model.param_specs` entry behind the agent
    axis (:func:`prepend_agent_axis`; ``agents="pod"``: the first free
    weight dim over ``data``), and every optimizer slot of
    ``run.algorithm`` as the parameters.  The step is replicated.  The
    encoder-decoder family's tree raises ``NotImplementedError`` (its
    param specs do).  The multi-rank step cuts a rank's tree state by
    these specs on a ``("data", "model")`` grid (:func:`init_state`
    ``mesh=``)."""
    feats = resolve_features(run)
    if feats.packed_bus:
        if run.agents == "pod":
            spec = P("pod" if multi_pod else None, "data")
        else:
            spec = P(("pod", "data") if multi_pod else "data")
        opt_specs = {"m": spec, "psi": spec}
        if feats.wire != "f32":
            opt_specs["e"] = spec
        specs = {"params": spec, "opt": opt_specs, "step": P()}
        if feats.overlap:
            specs["pipeline"] = {"slot": P(None, *spec), "parity": P()}
        return specs
    base = model.param_specs()
    if run.agents == "data":
        agent_axis, fsdp = ("pod", "data") if multi_pod else "data", None
    elif run.agents == "pod":
        agent_axis, fsdp = "pod" if multi_pod else None, "data"
    else:
        raise ValueError(run.agents)
    pspecs = {p: prepend_agent_axis(s, agent_axis, fsdp)
              for p, s in base.items()}
    slots = {"edm": ("m", "psi"), "edm_ef": ("m", "psi", "e"),
             "ed": ("m", "psi"), "dsgd": (), "dmsgd": ("m",),
             "dsgt": ("y", "g_prev"), "dsgt_hb": ("y", "g_prev", "m"),
             "decentlam": ("m",), "qg": ("m",)}[run.algorithm]
    return {"params": pspecs, "opt": {k: pspecs for k in slots},
            "step": P()}


def batch_spec_tree(model: Model, run: RunConfig, multi_pod: bool
                    ) -> Dict[str, P]:
    """The ``(A, b, ...)`` batch's specs, the reference's: the agent axis
    as the state's, with ``agents="pod"`` the per-agent batch over
    ``data``; a VLM's or an encoder-decoder model's ``frontend`` beside
    the tokens."""
    if run.agents == "data":
        agent_axis, inner = ("pod", "data") if multi_pod else "data", None
    else:
        agent_axis, inner = "pod" if multi_pod else None, "data"
    specs = {"tokens": P(agent_axis, inner, None)}
    if model.cfg.family in ("vlm", "encdec"):
        specs["frontend"] = P(agent_axis, inner, None, None)
    return specs


def _leaf_specs(model: Model, run: RunConfig) -> Dict[str, P]:
    """One agent's leaf specs of the tree state: :func:`state_specs`'
    parameter specs with the agent entry taken off."""
    return {p: P(*s[1:], groups=s.groups)
            for p, s in state_specs(model, run, False)["params"].items()}


def _model_axis(mesh) -> int:
    """The model axis's size of a rank grid (0: the grid has none)."""
    if mesh is None or "model" not in mesh.axis_names:
        return 0
    return mesh.axis_size("model")


def init_state(model: Model, run: RunConfig, n_agents: int, *,
               seed: int = 0, params: Optional[Dict[str, torch.Tensor]] = None,
               device=None, mesh=None,
               shard_axes: Optional[str] = None) -> TrainState:
    """All agents start from the same x(0) (the paper's initialization):
    packed ONCE into the bus, or replicated into ``(A, *shape)`` leaves
    with the algorithm's state ``opt.init(params)``.  ``params`` (one
    agent's parameter dict, e.g. from :mod:`repro_torch.weights`) replaces
    the random init from ``seed``.  Under ``overlap="delayed"`` the state
    also carries the pipeline (:func:`repro_torch.core.bus.make_pipeline`:
    x(0) in the live slot).  ``device`` defaults to ``cuda`` and
    raises without one.

    With ``mesh`` (a :class:`~repro_torch.core.comm.GossipMesh`) the
    state is this rank's: its ``(B, rows, 128)`` agent block of each bus,
    or with ``shard_axes`` its ``(1, rows / S, 128)`` row block (S the
    shard axis's size), or on the tree its ``(B, *shape)`` block of every
    leaf and optimizer slot, on the mesh's device unless ``device`` says
    otherwise — the blocks of the one-process state, bit for bit.  On a
    ``("data", "model")`` grid (tensor parallelism) each of those leaves
    is the rank's block under :func:`state_specs` (``init_lm_rank``'s
    draws, or ``shard_params`` of ``params``): a rank never holds the
    whole model."""
    if mesh is not None:
        return _rank_state(model, run, n_agents, seed, params,
                           device if device is not None else mesh.device,
                           mesh, shard_axes)
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
    x_bus = params_to_bus(bus_layout_for(model, n_agents, feats.groups),
                          params, n_agents)
    opt_state = make_edm_bus(run.alpha, run.beta, mix=lambda t: t).init(x_bus)
    if feats.wire != "f32":
        # the EF residual, e(0) = 0: step 0 sends Q(φ(0))
        opt_state["e"] = torch.zeros_like(x_bus)
    state = {"params": x_bus, "opt": opt_state, "step": 0}
    if feats.overlap:
        # φ(0) = x(0) in the live slot: step 0 is then the synchronous step
        # (W x(0) = x(0) at a replicated init)
        state["pipeline"] = parambus.make_pipeline(x_bus)
    return state


def _rank_state(model: Model, run: RunConfig, n_agents: int, seed: int,
                params, device, mesh, shard_axes) -> TrainState:
    """This rank's block of :func:`init_state`'s state: the bus's, or on
    the tree the B agents' leaves and the algorithm's ``opt.init`` of them
    (the reference's tree ``init_state``, restricted to the block)."""
    feats = resolve_features(run)
    _check_rank_features(feats, run, mesh, shard_axes, model)
    dev = resolve_device(device)
    _, B, s, S = rank_block(mesh, n_agents, shard_axes)
    M = _model_axis(mesh)
    if M and params is None:
        params = init_lm_rank(
            model.cfg, torch.Generator(device=dev).manual_seed(seed),
            mesh.axis_index("model"), M, specs=_leaf_specs(model, run))
    elif M:
        params = shard_params(params, _leaf_specs(model, run), mesh)
    elif params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {p: v.to(dev) for p, v in params.items()}
    if not feats.packed_bus:
        tree = {p: v.unsqueeze(0).repeat((B,) + (1,) * v.dim())
                for p, v in params.items()}
        opt = make_optimizer(run.algorithm, alpha=run.alpha, beta=run.beta,
                             mix=lambda t: t)
        return {"params": tree, "opt": opt.init(tree), "step": 0}
    layout = bus_layout_for(model, n_agents, feats.groups, S)
    x = params_to_bus(layout, params, B)
    if S > 1:
        x = x[:, s * layout.shard_rows:(s + 1) * layout.shard_rows].clone()
    opt_state = make_edm_bus(run.alpha, run.beta, mix=lambda t: t).init(x)
    if feats.wire != "f32":
        opt_state["e"] = torch.zeros_like(x)
    state = {"params": x, "opt": opt_state, "step": 0}
    if feats.overlap:
        state["pipeline"] = parambus.make_pipeline(x)
    return state


def _check_rank_features(feats: Features, run: RunConfig, mesh,
                         shard_axes: Optional[str], model: Model) -> None:
    """Raise for what the multi-rank step does not run: the tree's row
    shards (the reference asserts that ``shard_axes`` composes with the
    packed bus only), another engine than ppermute, a rank outside the
    mesh.  On a grid with a model axis (tensor parallelism: the tree,
    agents over ``data``, every leaf over ``model``) also
    ``agents="pod"`` (its per-layer FSDP, ``set_fsdp_constraint``, is
    queued), the packed bus and what rides on it — the overlap, the
    wires, policy groups (the reference's bus spec ``P(agent_axis)``
    holds the whole bus on every model rank, and its tree step lowers
    none of them) — a family whose TP loss is queued
    (``NotImplementedError``) and a config whose heads, FFN columns or
    vocabulary do not split whole over the axis."""
    M = _model_axis(mesh)
    if M:
        if run.agents == "pod":
            raise ValueError(
                "agents='pod' does not compose with a model axis: its "
                "per-layer FSDP over 'data' (the reference's "
                "set_fsdp_constraint) is queued in ROADMAP §1 item 8.7; "
                "tensor parallelism runs agents='data'")
        if feats.packed_bus:
            rides = [what for what, on in (
                ("overlap='delayed'", feats.overlap),
                (f"wire={feats.wire!r}", feats.wire != "f32"),
                ("gossip_groups", bool(feats.groups))) if on]
            raise ValueError(
                f"the packed bus{' with ' + ', '.join(rides) if rides else ''}"
                " does not compose with a model axis: tensor parallelism "
                "splits each agent's tree leaves over 'model' (run "
                "packed_bus=False, the tree; the bus and what rides on it "
                "are whole on every model rank in the reference)")
        check_tp_train(model.cfg)
        check_tp_split(model.cfg, M)
    if not feats.packed_bus and (run.agents == "pod"
                                 or shard_axes is not None):
        raise ValueError("agents='pod' (shard_axes) composes with the packed "
                         "bus only: the tree path splits agents over ranks, "
                         "never an agent's rows")
    if run.gossip_engine != "ppermute":
        raise ValueError(f"gossip across ranks runs the ppermute engine, "
                         f"got gossip_engine={run.gossip_engine!r}")
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the {mesh.shape} "
                         "mesh")


GradMap = Optional[Callable[[Dict[str, torch.Tensor]],
                            Dict[str, torch.Tensor]]]


def _agent_batch(batch: Dict[str, torch.Tensor], a: int
                 ) -> Dict[str, torch.Tensor]:
    """Agent ``a``'s slice of an agent-stacked batch (every key)."""
    return {k: v[a] for k, v in batch.items()}


def losses_and_grads(model: Model, layout: parambus.BusLayout,
                     x_bus: torch.Tensor, batch: Dict[str, torch.Tensor],
                     grad_map: GradMap = None, *, remat: bool = True,
                     remat_policy: str = "full"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent losses ``(A,)`` and the f32 gradient bus: agent ``a``'s
    parameters are unpacked from row block ``a`` of ``x_bus`` (cast to
    their own dtypes), and the gradient of agent ``a``'s OWN loss on its
    slice of ``batch`` (``tokens`` ``(A, b, S)`` and, for a VLM,
    ``frontend`` ``(A, b, P, d)``) — through ``grad_map`` (the LR
    schedule's scaling), in the leaves' dtypes — is packed into row block
    ``a`` of the gradient
    bus: the JAX step's ``vmap(value_and_grad(loss))``, one agent at a
    time.  ``remat`` / ``remat_policy`` go to ``model.loss`` (the run's
    ``RunConfig.remat`` / ``remat_policy``)."""
    g_bus = torch.zeros_like(x_bus)
    losses = []
    for a in range(x_bus.shape[0]):
        leaves = {p: v.detach().requires_grad_()
                  for p, v in parambus.unpack_agent(layout, x_bus, a).items()}
        loss = model.loss(leaves, _agent_batch(batch, a), remat=remat,
                          remat_policy=remat_policy)
        grads = dict(zip(layout.paths, torch.autograd.grad(
            loss, [leaves[p] for p in layout.paths])))
        if grad_map is not None:
            grads = grad_map(grads)
        parambus.pack_agent(layout, g_bus, a, grads)
        losses.append(loss.detach())
    return torch.stack(losses), g_bus


def tree_losses_and_grads(model: Model, params: Dict[str, torch.Tensor],
                          batch: Dict[str, torch.Tensor], *,
                          remat: bool = True,
                          remat_policy: str = "full"
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The tree version of :func:`losses_and_grads`: per-agent losses
    ``(A,)`` and ``{path: (A, *shape)}`` gradients in the leaves' dtypes,
    row ``a`` the gradient of agent ``a``'s own loss at its own
    parameters ``params[path][a]``."""
    grads = {p: torch.empty_like(v) for p, v in params.items()}
    losses = []
    for a in range(batch["tokens"].shape[0]):
        leaves = {p: v[a].detach().requires_grad_()
                  for p, v in params.items()}
        loss = model.loss(leaves, _agent_batch(batch, a), remat=remat,
                          remat_policy=remat_policy)
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

    ``run(state, batch, lr_scale)`` takes ``state["step"]``'s step,
    writes x', m', ψ' (and e', and under overlap the new payload into the
    pipeline's spare slot) over the state's own buffers — a fused combine
    writes the new x into x's buffer, which is dead once φ exists (under
    overlap x is not read at all); any other mix is copied there at the
    end — and returns the metrics as device tensors; ``state["step"]`` and
    the pipeline's parity are left for the caller to advance.
    ``lr_scale`` is a 0-d f32 tensor on the state's device holding
    ``lr_schedule(step)`` (None without a schedule), so the step reads the
    scale from device memory rather than from the host.  ``key(step)`` is
    what else the step depends on: the schedule round, whether it gossips
    and, under a straggler plan, whether a slot is late (the pipeline's
    parity is the state's).  ``prepare(step, device)``, where not None,
    writes what the step reads from device tables — the overlap
    combine's source table with the step's late slots — and is called
    before every replay."""

    run: Callable
    key: Callable[[int], Tuple]
    lr_schedule: Optional[Callable]
    prepare: Optional[Callable] = None


def _encode_ef_agents(codec: WireCodec, phi: torch.Tensor,
                      e: torch.Tensor, out=None):
    """The overlap pipeline's issue-time error-feedback encode of ``c = φ +
    e`` (the reference's ``encode_ef(codec, φ + e)``), one agent's row
    block at a time so that the codec's temporaries stay one block large
    (the scale tiles lie within a block, so the values are the whole bus's).
    The residual ``c − decode(payload)`` is written over ``e``; returns the
    payload, a bf16 bus or an int8 bus with its ``(A, n_tiles)`` scales,
    written into ``out`` when given (the peer table's slot across ranks)."""
    A, rows, lane = phi.shape
    if out is not None:
        q, scale = (out, None) if codec.fmt == "bf16" else out
    elif codec.fmt == "bf16":
        q = torch.empty(phi.shape, dtype=torch.bfloat16, device=phi.device)
        scale = None
    else:
        q = torch.empty(phi.shape, dtype=torch.int8, device=phi.device)
        scale = torch.empty((A, rows // codec.block_rows),
                            dtype=torch.float32, device=phi.device)
    for a in range(A):
        c = phi[a] + e[a]
        pay = codec.encode(c)
        e[a].copy_(c.sub_(codec.decode(pay)))
        if scale is None:
            q[a].copy_(pay)
        else:
            q[a].copy_(pay[0])
            scale[a].copy_(pay[1])
    return q if scale is None else (q, scale)


def build_train_step(model: Model, run: RunConfig, topo,
                     use_fused_kernel: bool = False, *,
                     straggler_plan: Optional[StragglerPlan] = None,
                     pods: int = 1, device=None, mesh=None,
                     shard_axes: Optional[str] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch
    tokens are ``(A, per_agent_batch, S)`` (a VLM's batch also carries
    ``frontend`` ``(A, per_agent_batch, n_frontend_tokens, d_model)``).

    ``topo`` is a :class:`Topology` or a
    :class:`~repro_torch.core.schedule.GossipSchedule` (one round per
    gossip, on the round clock :func:`gossip_round_step`); churn comes in
    as an :class:`~repro_torch.core.elastic.ElasticSchedule`, whose rounds
    of a degraded epoch are masked.
    ``run.gossip_engine`` selects the mixer (the ``ppermute`` engine needs
    ``run.agents_per_device = A``: one device).  ``use_fused_kernel``
    routes the EDM update and the ppermute engine's combine through the
    CUDA kernels: one launch of each per step on the bus, one per leaf on
    the tree (the fused EDM update for ``algorithm="edm"`` only, as in the
    JAX package); a masked round's combine is the source-table kernel.
    The mixer's transport is ``"auto"``, as in the JAX trainer: a flat
    ring's fused combine on the bus runs the ring kernel.  With
    ``run.wire`` bf16 or int8 a gossip step runs
    :func:`make_edm_bus_ef` (the fused EDM + quantize kernel, then the
    decode-combine); a step that ``gossip_every > 1`` skips runs the
    algorithm with the identity mixer (on the bus the plain EDM recursion,
    carrying the residual ``e`` untouched).  ``run.gossip_dtype`` casts
    the gossip payload; ``run.warmup_steps`` / ``run.total_steps`` turn on
    ``warmup_cosine`` as gradient scaling; ``run.remat`` /
    ``run.remat_policy`` recompute each layer of an agent's loss in the
    backward pass (:func:`~repro_torch.models.transformer.lm_loss`).  The
    bus step consumes its
    input state: the new m, ψ (and e) are written over the old buffers.

    With ``run.overlap="delayed"`` (DESIGN §6) the step is issue →
    compute → complete: the live pipeline payload φ(t) (with a wire, its
    EF encode ``φ(t) + e(t)``, the residual split off) is issued, the
    gradients are taken at φ(t), then the combine ``x(t) = W(t) φ̃(t)``
    (:func:`~repro_torch.core.mixing.make_overlap_mixer`) and the local
    EDM update on x(t), whose φ(t+1) goes into the pipeline's spare slot.
    ``straggler_plan`` (a :class:`~repro_torch.core.elastic.StragglerPlan`)
    composes with the overlap only: each step's late slots degrade to
    self-weight.

    With ``run.gossip_groups`` (DESIGN §12) the bus is laid out in policy
    groups and the gossip is :func:`~repro_torch.core.mixing.
    make_group_mixer` over :func:`make_group_plans` (``pods`` builds a
    group's own schedule): each gossiping group mixes its rows on its own
    cadence, schedule and stateless wire, the fused combines writing
    straight into x's rows; opt-out and off-cadence rows are copied from
    φ.  A step's graph key is then every gossiping group's (mixes,
    round) pair.

    ``device`` defaults to ``cuda`` and raises without one; the state must
    live there.  On the bus the returned step carries
    ``train_step.static``, the same step over a static state
    (:class:`StaticBusStep`); on the tree it is None.  On a grouped bus
    ``train_step.group_plans`` holds the step's plans (else None);
    ``train_step.peer_ring()`` is the multi-rank step's peer-pointer ring
    (:class:`~repro_torch.kernels.ring_peer.PeerRing`) once a step made
    it, else None.

    With ``mesh`` (a :class:`~repro_torch.core.comm.GossipMesh`, the
    twin of the reference's ``mesh=, agent_axes=``) the step runs this
    rank's share of the bus step (DESIGN §3–4, §7): the state is its
    :func:`init_state` ``mesh=`` block, the batch the global ``(A, b,
    ...)`` one, of which it takes its agents' rows; the per-agent loss and
    gradient, the EDM (and EF) update run on the local block, and the
    gossip is :func:`~repro_torch.core.mixing.mix_ranks` (a ring with
    fused kernels on the card: the peer-pointer ring kernel, φ written
    straight into its shared payload).  ``shard_axes`` (``agents="pod"``)
    names the mesh's row-shard axis: each rank holds ``(1, rows / S, 128)``
    of its agent's bus, the forward and backward run on the agent's bus
    all-gathered along that axis, and each shard keeps its own rows of the
    gradient.  The metrics are all-reduced (loss, consensus, gradient
    norm); ``agent_losses`` holds every agent's loss.  The overlapped
    pipeline across ranks starts the round's permutes (or publishes into
    the peer table, on the card) before the rank's forward and backward
    pass and waits on them after it (the recorder's ``backward`` /
    ``backward done`` marks bracket the pass); a straggler plan's late
    slots degrade to self-weight on every rank.  Policy groups run each
    group's schedule mixer across ranks on the rank's rows of the group.
    The tree step across ranks takes its agents' rows of the batch, their
    losses and gradients leaf by leaf, and runs the algorithm with the
    multi-rank mixer on its ``(B, *shape)`` leaves (the reference's
    ``mix_ppermute`` under a mesh, leaf by leaf; on the card the peer
    transports carry the rank's leaves packed into one f32 payload); its
    metrics are all-reduced the same way (the consensus leaf by leaf).
    The multi-rank step is eager (``train_step.static`` is None);
    ``train_step.transports()`` lists the peer transports its mixers made
    and ``train_step.close()`` frees them (collective).  The fused tree EDM
    across ranks consumes its input state, as the bus step does (m', ψ'
    and φ written over the state's m, ψ and x leaf by leaf, each gradient
    leaf dropped once used; the gradient norm is taken first): once such
    a step returns, the state passed in is invalid and only the returned
    one holds the run.

    On a grid with a ``"model"`` axis of M ranks (tensor parallelism:
    :func:`repro_torch.launch.mesh.make_gossip_mesh` ``model=M``, the
    reference's ``build_train_step`` jitted with ``in_shardings`` from
    :func:`state_specs` / :func:`batch_spec_tree`) the state is the tree's
    (:func:`init_state` ``mesh=``: each leaf the rank's block of its B
    agents' leaves), each agent's loss and backward run tensor-parallel
    over ``model`` (``build_model(cfg, mesh=grid)``'s loss: the dense
    family), the algorithm runs on the rank's blocks, and the gossip goes
    over the rank's ``data`` slice, each model column gossiping its own
    blocks (on the card through the peer transports, one pair a column).
    The metrics sum a split leaf's blocks over the grid and count a
    leaf that every model rank holds whole once (model index 0's).
    ``_check_rank_features`` raises for what does not compose with a
    model axis (the packed bus and what rides on it, ``agents="pod"``, a
    family whose TP loss is queued, a config that does not split).
    """
    dev = resolve_device(device)
    feats = resolve_features(run)
    A = topo.n_agents
    a0, B, shard, S = 0, A, 0, 1
    M = _model_axis(mesh)
    if mesh is not None:
        _check_rank_features(feats, run, mesh, shard_axes, model)
        if M:
            # the loss on the rank's blocks, tensor-parallel over 'model'
            model = build_model(model.cfg, model.decode_window, mesh=mesh)
        if (run.agents == "pod") != (shard_axes is not None):
            raise ValueError("agents='pod' runs with shard_axes= (the mesh's "
                             "row-shard axis) and agents='data' without")
        a0, B, shard, S = rank_block(mesh, A, shard_axes)
        agent_comm = axes_group(mesh, gossip_agent_axes(
            mesh, sharded=shard_axes is not None))
    elif run.agents == "pod":
        raise ValueError("agents='pod' runs across ranks: pass mesh= and "
                         "shard_axes= (repro_torch.launch.mesh."
                         "make_gossip_mesh(A, pods=A, shards=S))")
    layout = (bus_layout_for(model, A, groups=feats.groups, shards=S)
              if feats.packed_bus else None)
    grouped = layout is not None and layout.is_grouped
    # the leaves a rank leaves out of the grid's metric sums: those whole
    # on every model rank, but on model index 0
    replicated = frozenset(
        p for p, sp in _leaf_specs(model, run).items() if "model" not in sp
    ) if M and mesh.axis_index("model") else frozenset()
    codec = (make_codec(feats.wire, layout.block_rows)
             if feats.wire != "f32" else None)
    if straggler_plan is not None and not feats.overlap:
        raise ValueError("straggler_plan composes with overlap='delayed' "
                         "only (the synchronous step has no payload stack to "
                         "degrade)")
    mix_kw = dict(engine=run.gossip_engine,
                  agents_per_device=run.agents_per_device,
                  use_fused_kernel=use_fused_kernel, wire=codec)
    if mesh is not None:
        mix_kw.update(mesh=mesh, shard_axes=shard_axes)
    if feats.overlap:
        issue, complete = build_mixer(topo, mode="overlap", **mix_kw)
        if straggler_plan is not None and \
                straggler_plan.n_terms != complete.n_terms:
            raise ValueError(f"StragglerPlan.n_terms={straggler_plan.n_terms}"
                             f" must match the overlap payload stack arity "
                             f"K={complete.n_terms}")
    elif grouped:
        plans = make_group_plans(
            run, layout, topo if isinstance(topo, GossipSchedule)
            else StaticSchedule(topo), pods)
        mix = make_group_mixer(plans, engine=run.gossip_engine,
                               agents_per_device=run.agents_per_device,
                               use_fused_kernel=use_fused_kernel,
                               mesh=mesh, shard_axes=shard_axes)
        gossiping = [p for p in plans if p.sched is not None]
    else:
        mix = build_mixer(topo, mode="schedule", **mix_kw)
    every = run.gossip_every
    # across ranks the fused tree EDM consumes its inputs, as the bus step
    # does (a leaf held once: four full-width TP ranks' EDM fit one card)
    consume = (mesh is not None and use_fused_kernel
               and run.algorithm == "edm")
    kw = (dict(use_fused_kernel=use_fused_kernel, consume=consume)
          if run.algorithm == "edm" else {})
    # each agent's loss recomputes its layers in the backward pass as the
    # run asks, as the reference's agent_loss does
    remat = dict(remat=run.remat, remat_policy=run.remat_policy)
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
            phi_out = None
            if mesh is not None and _is_f32(run.gossip_dtype) \
                    and not grouped:
                # the peer ring's shared payload, once read (None: not
                # this step's transport)
                phi_out = functools.partial(mix.payload_for_write, g_step)
            return make_edm_bus(run.alpha, run.beta, step_mix,
                                use_fused_kernel=use_fused_kernel,
                                phi_out=phi_out)
        return make_edm_bus_ef(
            run.alpha, run.beta, functools.partial(mix, step=g_step, out=out),
            codec, use_fused_kernel=use_fused_kernel,
            # across ranks the EF kernel encodes into the peer table's slot
            payload_out=None if mesh is None
            else functools.partial(mix.payload_for_write, g_step))

    def tree_opt(g_step: int, gossip: bool) -> DecOptimizer:
        step_mix = (_cast_mixer(lambda t: mix(t, step=g_step),
                                run.gossip_dtype)
                    if gossip else (lambda t: t))
        return make_optimizer(run.algorithm, alpha=run.alpha, beta=run.beta,
                              mix=step_mix, **kw)

    def gossips(step: int) -> bool:
        return every <= 1 or step % every == every - 1

    def late_at(step: int):
        return (None if straggler_plan is None
                else straggler_plan.late_at(step))

    def group_key(plan: GroupPlan, step: int) -> Tuple[bool, int]:
        k = plan.group.gossip_every
        if k > 1 and step % k != k - 1:
            return False, -1
        return True, int(plan.sched.round_index(gossip_round_step(step, k)))

    def step_key(step: int) -> Tuple:
        if grouped:
            return tuple(group_key(p, step) for p in gossiping)
        rnd = (int(topo.round_index(gossip_round_step(step, every)))
               if isinstance(topo, GossipSchedule) else 0)
        if straggler_plan is None:
            return rnd, gossips(step)
        return rnd, gossips(step), bool(late_at(step).any())

    def grads_at(x, batch, step: int, lr_scale=None):
        """Per-agent losses and the gradient bus at ``x`` (this rank's
        agents across ranks; a shard's own rows of its agent's gradient,
        taken on the bus all-gathered along the shard axis)."""
        gmap = grad_map(step, lr_scale)
        if mesh is None:
            return losses_and_grads(model, layout, x, batch, gmap, **remat)
        local = {k: v[a0:a0 + B] for k, v in batch.items()}
        if S == 1:
            return losses_and_grads(model, layout, x, local, gmap, **remat)
        full = coll.all_gather(x, mesh.group(shard_axes), S, tag="forward")
        losses, g = losses_and_grads(model, layout,
                                     full.view(1, layout.rows, x.shape[-1]),
                                     local, gmap, **remat)
        del full
        rows = layout.shard_rows
        return losses, g[:, shard * rows:(shard + 1) * rows].clone()

    def step_metrics(losses, new_x, grads, grad_norm=None) -> Dict:
        if mesh is None:
            if not feats.packed_bus:
                return {"loss": losses.mean(),
                        "consensus": consensus_distance(new_x),
                        "grad_norm": tree_sqnorm(grads).sqrt()}
            return {"loss": losses.mean(),
                    "consensus": bus_consensus(new_x),
                    "grad_norm": bus_grad_norm(grads)}
        ranks, group = agent_comm
        agent_losses = coll.all_gather(losses, group, len(ranks),
                                       tag="metrics")

        def total(t):
            return coll.all_reduce(t, mesh.world_group, mesh.size)

        def agent_sum(t):
            return coll.all_reduce(t, group, len(ranks))

        if feats.packed_bus:
            consensus = bus_consensus_ranks(new_x, A, agent_sum, total)
            grad_norm = bus_grad_norm_ranks(grads, total)
        else:
            # on a model axis a split leaf's blocks sum over the grid, a
            # replicated leaf counts once: model index 0's
            consensus = consensus_distance_ranks(new_x, A, agent_sum, total,
                                                 skip=replicated)
            if grad_norm is None:
                grad_norm = tree_grad_norm_ranks(grads, total,
                                                 skip=replicated)
        return {"loss": agent_losses.mean(), "consensus": consensus,
                "grad_norm": grad_norm, "agent_losses": agent_losses}

    def bus_step(x, opt_state, batch, step: int, out=None, lr_scale=None):
        """One bus step: ``(x', opt', metrics)``, x' written into ``out``
        when given."""
        losses, grads = grads_at(x, batch, step, lr_scale)
        with torch.no_grad():
            opt = bus_opt(gossip_round_step(step, every), gossips(step), out)
            new_x, new_opt = opt.step(x, grads, opt_state)
            metrics = step_metrics(losses, new_x, grads)
        return new_x, new_opt, metrics

    def overlap_step(pipe, opt_state, batch, step: int, out=None,
                     lr_scale=None):
        """One delayed-pipeline step: ``(x(t), opt', metrics)``, φ(t+1)
        written into the pipeline's spare slot, x(t) into ``out`` when
        the combine is fused and ``out`` is given; the parity is the
        caller's to flip."""
        phi = parambus.pipeline_payload(pipe)
        m, psi = opt_state["m"], opt_state["psi"]
        with torch.no_grad():
            # ISSUE: the live payload (with a wire its EF encode, residual
            # split off into e) — on one card nothing ships
            slot = getattr(issue, "payload_for_write", None)
            payload = (phi if codec is None else _encode_ef_agents(
                codec, phi, opt_state["e"],
                None if slot is None else slot(step, phi)))
            payloads = issue(payload, step)
        # COMPUTE: gradients at the pre-mix local iterate φ(t), while the
        # payloads travel (the recorder's marks bracket the pass)
        coll.mark("backward")
        losses, grads = grads_at(phi, batch, step, lr_scale)
        coll.mark("backward done")
        with torch.no_grad():
            # COMPLETE: the combine x(t) = W(t) φ̃(t), late slots at
            # self-weight; then the local EDM update, φ(t+1) into the spare
            x_mixed = complete(payloads, step, late=late_at(step), out=out)
            del payloads, payload
            update = kops.edm_update_bus if use_fused_kernel \
                else edm_update_ref
            m_new, psi_new, _ = update(
                x_mixed, grads, m, psi, alpha=run.alpha, beta=run.beta,
                out=(m, psi, parambus.pipeline_spare(pipe)))
            metrics = step_metrics(losses, x_mixed, grads)
        new_opt = {**opt_state, "m": m_new, "psi": psi_new}
        return x_mixed, new_opt, metrics

    def static_run(state: TrainState, batch, lr_scale=None) -> Dict:
        x, opt_state = state["params"], state["opt"]
        if (lr_sched is None) != (lr_scale is None):
            raise ValueError("lr_scale is the LR schedule's device scalar: "
                             "pass one exactly when the run has a schedule")
        step = int(state["step"])
        if feats.overlap:
            new_x, new_opt, metrics = overlap_step(
                state["pipeline"], opt_state, batch, step, out=x,
                lr_scale=lr_scale)
        else:
            new_x, new_opt, metrics = bus_step(x, opt_state, batch, step,
                                               out=x, lr_scale=lr_scale)
        if new_x.data_ptr() != x.data_ptr():     # the mix was not fused
            x.copy_(new_x)
        if any(new_opt[k].data_ptr() != v.data_ptr()
               for k, v in opt_state.items()):
            raise RuntimeError("the static bus step left its state buffers")
        return metrics

    def static_prepare(step: int, device) -> None:
        complete.prepare(step, late_at(step), device)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = state["params"]
        first = (params if feats.packed_bus
                 else next(iter(params.values())))
        if first.device.type != dev.type:
            raise ValueError(f"train state is on {first.device}, the step "
                             f"was built for {dev}")
        step = int(state["step"])
        if feats.overlap:
            pipe = state["pipeline"]
            new_x, new_opt, metrics = overlap_step(pipe, state["opt"],
                                                   batch, step)
            return {"params": new_x, "opt": new_opt,
                    "pipeline": {"slot": pipe["slot"],
                                 "parity": 1 - int(pipe["parity"])},
                    "step": step + 1}, metrics
        if feats.packed_bus:
            new_x, new_opt, metrics = bus_step(params, state["opt"],
                                               batch, step)
            return {"params": new_x, "opt": new_opt, "step": step + 1}, \
                metrics
        # this rank's agents' rows of the batch across ranks
        local = (batch if mesh is None
                 else {k: v[a0:a0 + B] for k, v in batch.items()})
        losses, grads = tree_losses_and_grads(model, params, local, **remat)
        if lr_sched is not None:
            grads = scale_grads(grads, step, lr_sched)
        with torch.no_grad():
            # the step consumes the gradients: their norm first
            g_norm = (tree_grad_norm_ranks(grads, lambda t: coll.all_reduce(
                t, mesh.world_group, mesh.size), skip=replicated)
                if consume else None)
            opt = tree_opt(gossip_round_step(step, every), gossips(step))
            new_x, new_opt = opt.step(params, grads, state["opt"])
            metrics = step_metrics(losses, new_x, grads, g_norm)
        return {"params": new_x, "opt": new_opt, "step": step + 1}, metrics

    train_step.static = (StaticBusStep(
        static_run, step_key, lr_sched,
        static_prepare if feats.overlap else None)
        if feats.packed_bus and mesh is None else None)
    train_step.group_plans = plans if grouped else None
    mixer = complete if feats.overlap else mix
    peer = getattr(mixer, "peer", None) if mesh is not None else None
    train_step.peer_ring = lambda: None if peer is None else peer.ring
    train_step.transports = getattr(mixer, "transports", list)
    train_step.close = getattr(mixer, "close", lambda: None)
    return train_step
