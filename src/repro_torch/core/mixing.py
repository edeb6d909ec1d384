"""Mixing engines: apply W over the leading agent axis of a tensor or of
every leaf of a tree (a ``{path: tensor}`` dict), leaf by leaf.

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
  On a tree the combine is one ``gossip_axpy`` launch per leaf.

:func:`accumulate_f32` wraps a tree op so that sub-f32 leaves go up to
f32 and come back once on the way out: the dense engine's bf16 path and
the trainer's ``gossip_dtype`` payload cast.

Every engine takes one gossip *round* (a :class:`Topology`); a
time-varying :class:`~repro_torch.core.schedule.GossipSchedule` gets one
engine closure per round through :func:`make_schedule_mixer`, dispatched
by the step in Python.

With a wire codec (``wire=``, :class:`repro_torch.core.wire.WireCodec`)
the mixer takes the codec's *encoded* payload and returns the decoded f32
mix.  The ppermute engine rolls every payload component with the same
plan (the int8 data bus and its ``(A, n_tiles)`` scales together) and
folds the decode into the combine: the fused ``gossip_axpy_wire`` kernel
computes ``(w·scale)·q``, the plain path ``Σ w·decode(p)`` = ``w·(q·scale)``
as the JAX engine's, and the two round differently.  Dense and shifts
decode first and mix in f32.  Masked (elastic) rounds and the overlap
mode are not ported yet (ROADMAP.md).

The ppermute engine's ``transport`` (as in the JAX engine) picks how a
flat ±1 ring's neighbours reach the combine: ``"ppermute"`` rolls the
agent axis and combines the rolled copies; ``"ring_dma"`` runs the ring
kernel (:mod:`repro_torch.kernels.ring_dma`), which reads the neighbours'
row blocks in place, and raises ``ValueError`` on a payload it cannot
carry (not a ±1 ring, a wire payload, anything but an ``(A, rows, 128)``
f32 bus, agents spread over devices); ``"auto"`` takes the ring kernel
whenever the payload is eligible and the fused combine was asked for,
and rolls otherwise.  The JAX package guards its ring kernel behind
``REPRO_RING_DMA=1``: there it is a multi-device kernel with other
arithmetic, here it is bit-equal to the rolls plus ``gossip_axpy``, so
it needs no opt-in.  On CPU tensors the ring transport runs the rolls
plus the plain combine.

Every mixer takes ``out=``, a bus the fused combines (``gossip_axpy``,
its int8 twin, the ring kernel) write the mix into; it may alias no
payload.  The other paths return a new tensor and leave ``out`` alone,
so a caller that needs the mix in ``out`` copies when the result is
elsewhere (the static train step writes the new x over the old one so).

Roll semantics are ``x_new[i] = x[(i − shift) % n]``
(:meth:`Topology.term_sources`), which ``torch.roll(x, shift, 0)`` gives.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ring_dma

from .schedule import GossipSchedule, StaticSchedule
from .topology import ShiftTerm, Topology
from .wire import WireCodec

__all__ = ["TRANSPORTS", "mix_dense", "mix_shifts", "mix_ppermute",
           "wire_terms", "make_mixer", "make_schedule_mixer", "build_mixer",
           "accumulate_f32", "tree_map"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)
TRANSPORTS = ("auto", "ppermute", "ring_dma")


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a ``{path: tensor}`` dict, or on a tensor."""
    if isinstance(tree, Mapping):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


def accumulate_f32(fn: Callable) -> Callable:
    """Wrap a tree → tree op so that sub-f32 leaves go up to f32, ``fn``
    runs, and each result is cast back to its input leaf's dtype: the
    precision is lost once, on the way out."""

    def wrapped(tree):
        up = tree_map(lambda x: x.float() if x.dtype in _LOW_PRECISION
                      else x, tree)
        out = fn(up)
        if isinstance(tree, Mapping):
            return {k: out[k].to(tree[k].dtype) for k in tree}
        return out.to(tree.dtype)

    return wrapped


def _mix_leaf_dense(topo: Topology, x: torch.Tensor) -> torch.Tensor:
    W = torch.as_tensor(topo.dense_matrix(), dtype=torch.float32,
                        device=x.device)
    flat = x.reshape(x.shape[0], -1)
    return (W.to(flat.dtype) @ flat).reshape(x.shape)


def mix_dense(topo: Topology, x):
    """Oracle engine: dense W matmul over the agent axis; sub-f32 inputs
    accumulate in f32 and round once on the way out."""
    return accumulate_f32(lambda t: tree_map(
        lambda leaf: _mix_leaf_dense(topo, leaf), t))(x)


def mix_shifts(topo: Topology, x):
    """W as a weighted sum of agent-axis rolls, accumulated in each
    leaf's dtype."""
    return tree_map(lambda leaf: _mix_leaf_shifts(topo, leaf), x)


def _mix_leaf_shifts(topo: Topology, x: torch.Tensor) -> torch.Tensor:
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


def _no_f32(wire: Optional[WireCodec]) -> Optional[WireCodec]:
    """An f32 codec is no codec: the uncompressed wire."""
    return None if wire is None or wire.fmt == "f32" else wire


def wire_terms(topo: Topology, payload, wire: Optional[WireCodec] = None
               ) -> List:
    """The one-device ppermute engine's post-roll payloads, one per term:
    every component of a wire payload rolled with the same plan."""
    wire = _no_f32(wire)
    if wire is None:
        return [_local_term(topo, payload, t) for t in topo.terms]
    return [wire.map_payload(lambda l, t=t: _local_term(topo, l, t),
                             payload) for t in topo.terms]


def _check_transport(transport: str) -> None:
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; have "
                         f"{TRANSPORTS}")


def _ring_unfit(topo: Topology, x, agents_per_device: int,
                wire: Optional[WireCodec]) -> str:
    """Why the ring transport cannot carry this gossip, or '':
    :func:`repro_torch.kernels.ring_dma.ring_unfit` on an f32 payload
    (``x`` None checks the topology only)."""
    if wire is not None:
        return (f"takes f32 payloads; a {wire.fmt} wire payload goes "
                "through the decode-combine")
    return ring_dma.ring_unfit(topo, agents_per_device=agents_per_device,
                               payload=x)


def _use_ring(topo: Topology, x, agents_per_device: int,
              use_fused_kernel: bool, wire: Optional[WireCodec],
              transport: str) -> bool:
    """Whether this call's combine runs on the ring transport.  Forced
    ``"ring_dma"`` on a payload it cannot carry raises; ``"auto"`` takes
    it whenever the payload is eligible and the combine is fused."""
    _check_transport(transport)
    if transport == "ppermute":
        return False
    why = _ring_unfit(topo, x, agents_per_device, wire)
    if transport == "ring_dma":
        if why:
            raise ValueError(f"transport='ring_dma' {why}")
        return True
    return use_fused_kernel and not why


def mix_ppermute(topo: Topology, x, *, agents_per_device: int,
                 use_fused_kernel: bool = False,
                 wire: Optional[WireCodec] = None, transport: str = "auto",
                 out: Optional[torch.Tensor] = None):
    """The ``ppermute`` engine with every agent on one device, on a tensor
    or leaf by leaf on a tree (one combine per leaf).  With a non-f32
    ``wire``, ``x`` is the codec's payload of the bus and the result is
    the decoded f32 mix.  ``transport`` picks the rolls or the ring
    kernel; a fused combine of a tensor writes into ``out`` (module
    docstring)."""
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
    wire = _no_f32(wire)
    if _use_ring(topo, x, agents_per_device, use_fused_kernel, wire,
                 transport):
        terms = [(t.shift, float(t.weight)) for t in topo.terms]
        if isinstance(x, Mapping):
            return {k: kops.ring_combine(v, terms) for k, v in x.items()}
        return kops.ring_combine(x, terms, out=out)
    weights = [float(t.weight) for t in topo.terms]
    if wire is None:
        if isinstance(x, Mapping):
            return tree_map(lambda leaf: _combine(
                wire_terms(topo, leaf), weights, use_fused_kernel), x)
        return _combine(wire_terms(topo, x), weights, use_fused_kernel,
                        out=out)
    payloads = wire_terms(topo, x, wire)
    if use_fused_kernel:
        return kops.gossip_axpy_wire(payloads, weights, fmt=wire.fmt,
                                     block_rows=wire.block_rows, out=out)
    return _combine([wire.decode(p) for p in payloads], weights, False)


def _combine(payloads, weights, use_fused_kernel: bool,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Σ w·p``: one ``gossip_axpy`` launch (into ``out`` when given), or
    the plain weighted sum in the payloads' dtype (a new tensor)."""
    if use_fused_kernel:
        return kops.gossip_axpy(payloads, weights, out=out)
    acc = None
    for w, p in zip(weights, payloads):
        term = w * p
        acc = term if acc is None else acc + term
    return acc


def _check_round(topo) -> None:
    if not isinstance(topo, Topology):
        raise NotImplementedError(
            f"gossip round {type(topo).__name__} is not a Topology: masked "
            "(elastic) rounds are not ported yet (ROADMAP.md)")


def make_mixer(topo: Topology, engine: str = "shifts", *,
               agents_per_device: int = 1, use_fused_kernel: bool = False,
               wire: Optional[WireCodec] = None,
               transport: str = "auto") -> Callable:
    """Return ``mix(x, out=None) -> x``.  engine ∈ {"dense", "shifts",
    "ppermute"}; ``agents_per_device``, ``use_fused_kernel`` and
    ``transport`` are read by the ppermute engine only, as in the JAX
    package (a forced ``"ring_dma"`` on another engine, a wire or a
    topology that is not a ±1 ring raises here).  With a non-f32 ``wire``
    the mixer takes the codec's payload and returns the f32 mix; dense
    and shifts decode first."""
    _check_round(topo)
    _check_transport(transport)
    wire = _no_f32(wire)
    if transport == "ring_dma":
        why = (f"runs on the ppermute engine, not {engine!r}"
               if engine != "ppermute"
               else _ring_unfit(topo, None, agents_per_device, wire))
        if why:
            raise ValueError(f"transport='ring_dma' {why}")
    if engine in ("dense", "shifts"):
        base = mix_dense if engine == "dense" else mix_shifts
        if wire is None:
            return lambda x, out=None: base(topo, x)
        return lambda payload, out=None: base(topo, wire.decode(payload))
    if engine == "ppermute":
        return lambda x, out=None: mix_ppermute(
            topo, x, agents_per_device=agents_per_device,
            use_fused_kernel=use_fused_kernel, wire=wire,
            transport=transport, out=out)
    raise ValueError(f"unknown mixing engine: {engine}")


def make_schedule_mixer(sched: GossipSchedule, engine: str = "shifts", *,
                        agents_per_device: int = 1,
                        use_fused_kernel: bool = False,
                        wire: Optional[WireCodec] = None,
                        transport: str = "auto") -> Callable:
    """Step-indexed mixer over a schedule: ``mix(x, step=0, out=None)``
    applies round ``sched.round_index(step)`` through the chosen engine.
    Every round has its own engine closure; the step is a Python int, so
    the round is picked in Python."""
    mixers = [make_mixer(r, engine, agents_per_device=agents_per_device,
                         use_fused_kernel=use_fused_kernel, wire=wire,
                         transport=transport)
              for r in sched.rounds]
    if len(mixers) == 1:
        return lambda x, step=0, out=None: mixers[0](x, out=out)
    return lambda x, step=0, out=None: mixers[
        int(sched.round_index(int(step)))](x, out=out)


def build_mixer(sched, *, mode: str = "schedule", engine: str = "shifts",
                agents_per_device: int = 1, use_fused_kernel: bool = False,
                wire: Optional[WireCodec] = None,
                transport: str = "auto") -> Callable:
    """Single mixer entry point.  ``mode="static"`` takes a
    :class:`Topology` (or a period-1 schedule) and returns ``mix(x)``;
    ``mode="schedule"`` takes a
    :class:`~repro_torch.core.schedule.GossipSchedule` (a bare topology
    is wrapped static) and returns ``mix(x, step=0)``; both take
    ``out=``.  The overlap mode is not ported yet (ROADMAP.md)."""
    if mode == "overlap":
        raise NotImplementedError("mixer mode 'overlap' (the overlapped "
                                  "gossip pipeline) is not ported yet "
                                  "(ROADMAP.md)")
    kw = dict(agents_per_device=agents_per_device,
              use_fused_kernel=use_fused_kernel, wire=wire,
              transport=transport)
    if mode == "static":
        topo = sched
        if isinstance(sched, GossipSchedule):
            if sched.period != 1:
                raise ValueError(f"mode='static' needs a topology or a "
                                 f"period-1 schedule, got period "
                                 f"{sched.period}")
            topo = sched.rounds[0]
        return make_mixer(topo, engine, **kw)
    if mode == "schedule":
        if not isinstance(sched, GossipSchedule):
            _check_round(sched)
            sched = StaticSchedule(sched)
        return make_schedule_mixer(sched, engine, **kw)
    raise ValueError(f"unknown mixer mode: {mode!r} (expected 'static', "
                     "'schedule' or 'overlap')")
