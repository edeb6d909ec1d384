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
decode first and mix in f32.

A liveness-masked round (:class:`~repro_torch.core.elastic.MaskedTopology`,
DESIGN §8) has per-agent sources and weights.  ``dense`` applies its
``dense_matrix()``; ``shifts`` and the plain ppermute combine take the
reference's gather route (``x[src_k] · w_k``, accumulated in the leaf's
dtype); the fused ppermute combine runs the source-table kernel
(:func:`repro_torch.kernels.ops.table_combine`, one launch per leaf, the
``(K, A)`` tables in device memory); with a wire it is the table kernel on
the bf16 bus, or the int8 rows and scales gathered by the table into the
q8 combine (:func:`~repro_torch.kernels.ops.table_combine_wire`).
:func:`make_overlap_mixer` is the overlapped pipeline's phase-split mixer
(DESIGN §6), late slots included.

The ppermute engine's ``transport`` (as in the JAX engine) picks how a
flat ±1 ring's neighbours reach the combine: ``"ppermute"`` rolls the
agent axis and combines the rolled copies; ``"ring_dma"`` runs the ring
kernel (:mod:`repro_torch.kernels.ring_dma`), which reads the neighbours'
row blocks in place, and raises ``ValueError`` on a payload it cannot
carry (not a ±1 ring, a masked round, a wire payload, anything but an
``(A, rows, 128)`` f32 bus, agents spread over devices); ``"auto"``
takes the ring kernel whenever the payload is eligible and the fused
combine was asked for, and rolls otherwise.  The JAX package guards its ring kernel behind
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

:func:`make_group_mixer` mixes a policy-group bus (DESIGN §12): each
gossiping group runs these engines unchanged on its rows ``bus[:, r0:r1]``
with its own schedule, cadence and stateless wire codec, and the fused
combines read those rows and write the group's mix into ``out``'s rows in
place (agent-strided kernels); rows that do not mix on a step are copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ring_dma

from .elastic import is_masked
from .schedule import GossipSchedule, StaticSchedule
from .topology import ShiftTerm, Topology
from .wire import WireCodec

__all__ = ["TRANSPORTS", "mix_dense", "mix_shifts", "mix_ppermute",
           "wire_terms", "round_tables", "make_mixer", "make_schedule_mixer",
           "make_overlap_mixer", "build_mixer", "GroupPlan", "encode_rows",
           "make_group_mixer", "accumulate_f32", "tree_map"]

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


def _mix_leaf_dense(W, x: torch.Tensor) -> torch.Tensor:
    W = torch.as_tensor(W, dtype=torch.float32, device=x.device)
    flat = x.reshape(x.shape[0], -1)
    return (W.to(flat.dtype) @ flat).reshape(x.shape)


def _dense_with(W, x):
    """``W @ x`` over the agent axis of a tensor or tree; sub-f32 inputs
    accumulate in f32 and round once on the way out."""
    return accumulate_f32(lambda t: tree_map(
        lambda leaf: _mix_leaf_dense(W, leaf), t))(x)


def mix_dense(topo: Topology, x):
    """Oracle engine: dense W matmul over the agent axis (a masked round's
    ``dense_matrix()`` too); sub-f32 inputs accumulate in f32 and round
    once on the way out."""
    return _dense_with(topo.dense_matrix(), x)


def mix_shifts(topo: Topology, x):
    """W as a weighted sum of agent-axis rolls, accumulated in each
    leaf's dtype (a masked round: the gather route)."""
    if is_masked(topo):
        return _masked_mixer(topo, "shifts", 1, False, None)(x)
    return tree_map(lambda leaf: _mix_leaf_shifts(topo, leaf), x)


def round_tables(topo: Topology, n_slots: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """A round as a source table: ``(src, w)``, int32 and f32 ``(K, A)``
    arrays with ``src[k, a]`` the agent whose payload term k brings to
    agent a and ``w[k, a]`` its weight — a masked round's per-agent
    columns, else the term's weight for every agent.  ``n_slots`` > K pads
    with self slots of weight 0 (the overlap stack's arity)."""
    A = topo.n_agents
    K = max(n_slots, len(topo.terms))
    src = np.tile(np.arange(A, dtype=np.int32), (K, 1))
    w = np.zeros((K, A), np.float32)
    for k, t in enumerate(topo.terms):
        src[k] = topo.term_sources(t)
        w[k] = topo.term_weights(t) if is_masked(topo) else t.weight
    return src, w


def _capturing(device: torch.device) -> bool:
    """Is a CUDA graph being captured on ``device``'s current stream?"""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class _DeviceTables:
    """A mixer's source tables on a device: one ``(K, A)`` int32 / f32
    buffer pair per round (:func:`round_tables`), holding the round's
    table with the step's late slots (if any) swapped for the agent
    itself.  The buffers are made at the first eager call; eager calls
    write the table they need, while a captured CUDA graph reads the
    buffers as they are, so before a replay the step's table is written
    by :meth:`prepare` (outside the capture)."""

    def __init__(self, tables):
        self.host = tables                 # [(src, w)] per round, numpy
        self.bufs: Dict[tuple, list] = {}  # (round, device) -> [src, w, late]

    def table(self, r: int, late) -> Tuple[np.ndarray, np.ndarray]:
        src, w = self.host[r]
        if late is not None and late.any():
            src = src.copy()
            src[late] = np.arange(src.shape[1], dtype=np.int32)
        return src, w

    def prepare(self, r: int, late, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        key = None if late is None or not late.any() else tuple(late)
        buf = self.bufs.get((r, device))
        if buf is not None and buf[2] == key:
            return buf[0], buf[1]
        if _capturing(device):
            raise RuntimeError(
                f"round {r}: the tables for late slots {key} are not in "
                "the device buffers; write them before the capture or "
                "replay (complete.prepare)")
        src, w = (torch.from_numpy(a) for a in self.table(r, late))
        if buf is None:     # buffers of their own: later steps write them
            buf = [torch.empty_like(src, device=device).copy_(src),
                   torch.empty_like(w, device=device).copy_(w), key]
            self.bufs[(r, device)] = buf
        else:
            buf[0].copy_(src)
            buf[1].copy_(w)
            buf[2] = key
        return buf[0], buf[1]


def _gather(src: torch.Tensor, w: torch.Tensor, x: torch.Tensor
            ) -> torch.Tensor:
    """The reference's gather route for a masked round: ``Σₖ x[src_k] ·
    w_k`` agent by agent, the weights cast to the leaf's dtype and the sum
    accumulated in it."""
    bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
    acc = None
    for s_k, w_k in zip(src.long(), w.to(x.dtype)):
        term = x.index_select(0, s_k) * w_k.view(bshape)
        acc = term if acc is None else acc + term
    return acc


def _masked_mixer(topo: Topology, engine: str, agents_per_device: int,
                  use_fused_kernel: bool, wire: Optional[WireCodec]
                  ) -> Callable:
    """``mix(x, out=None)`` of a masked round on one device, with the
    round's tables of its own (:class:`_DeviceTables`).  ``shifts`` and
    the plain ppermute combine take the reference's gather route (decoded
    first under a wire); the fused ppermute combine is the source-table
    kernel, one launch per leaf (a wire payload through
    :func:`~repro_torch.kernels.ops.table_combine_wire`), writing into
    ``out`` when given."""
    if engine == "ppermute":
        _one_device(topo.n_agents, agents_per_device)
    fused = engine == "ppermute" and use_fused_kernel
    tables = _DeviceTables([round_tables(topo)])

    def tabs(t: torch.Tensor):
        return tables.prepare(0, None, t.device)

    def mix(x, out=None):
        if wire is not None:
            if not fused:
                dec = wire.decode(x)
                return _gather(*tabs(dec), dec)
            return kops.table_combine_wire(
                x, *tabs(wire.payload_leaves(x)[0]), fmt=wire.fmt,
                block_rows=wire.block_rows, out=out)
        if not fused:
            return tree_map(lambda leaf: _gather(*tabs(leaf), leaf), x)
        if isinstance(x, Mapping):
            return {k: kops.table_combine(v, *tabs(v)) for k, v in x.items()}
        return kops.table_combine(x, *tabs(x), out=out)

    return mix


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
    (``x`` None checks the topology only).  A masked round has per-agent
    sources, as in the reference (``mix_ppermute``'s ``not masked``)."""
    if is_masked(topo):
        return f"takes unmasked rings, got the masked round {topo.name}"
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


def _one_device(A: int, agents_per_device: int) -> None:
    """Raise unless ``agents_per_device`` puts all A agents on one device:
    more devices is multi-GPU gossip."""
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
    _one_device(topo.n_agents, agents_per_device)
    wire = _no_f32(wire)
    if is_masked(topo):
        return _masked_mixer(topo, "ppermute", agents_per_device,
                             use_fused_kernel, wire)(x, out=out)
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
        raise TypeError(f"gossip round {type(topo).__name__} is not a "
                        "repro_torch Topology (a masked round is its "
                        "MaskedTopology subclass)")


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
    if is_masked(topo) and engine in ("shifts", "ppermute"):
        return _masked_mixer(topo, engine, agents_per_device,
                             use_fused_kernel, wire)
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


def _late_mask(late, K: int) -> Optional[np.ndarray]:
    """A ``(K,)`` late mask (numpy, a tensor or a sequence) as numpy bools,
    or None."""
    if late is None:
        return None
    if isinstance(late, torch.Tensor):
        late = late.detach().cpu().numpy()
    late = np.asarray(late, dtype=bool).reshape(-1)
    if late.shape != (K,):
        raise ValueError(f"late mask of {late.shape[0]} slots, the payload "
                         f"stack has K = {K}")
    return late


def make_overlap_mixer(sched, engine: str = "ppermute", *,
                       agents_per_device: int = 1,
                       use_fused_kernel: bool = False,
                       wire: Optional[WireCodec] = None,
                       transport: str = "auto"):
    """Phase-split schedule mixer of the overlapped gossip pipeline
    (DESIGN §6): returns ``(issue, complete)`` with ``complete(issue(x,
    step), step)`` equal to the synchronous ``make_schedule_mixer(...)(x,
    step)`` on one payload ``x`` (the packed bus, or the codec's payload of
    it with ``wire``; the result is then the decoded f32 mix).

    K is the largest arity of any round; ``complete.n_terms`` is K and
    ``complete.self_index[r]`` the slot of round r's self payload (its
    shift-0 term, or the first weight-0 pad slot).
    ``complete(payloads, step, late=None, out=None)`` takes an optional
    ``(K,)`` late mask (:meth:`~repro_torch.core.elastic.StragglerPlan.
    late_at`): each late slot takes the round's self payload under the
    slot's own weight, ``W_eff = Σ_{k∉late} w_k P_k + (Σ_{k∈late} w_k) I``,
    so the late buffer is never multiplied.

    * ``dense`` / ``shifts``: no separable wire phase — ``issue`` is the
      identity and ``complete`` the full mix.  ``dense`` takes ``late``
      through the per-term W_eff oracle; ``shifts`` rejects it.
    * ``ppermute`` with every agent on one device: nothing ships, so
      ``issue`` hands on the live payload itself and ``complete`` runs the
      combine over it.  In the JAX package ``issue`` stacks the K
      permuted payloads, ``(K, A, ...)``, slot k of agent a holding
      agent ``src[k, a]``'s payload (the agent's own for a pad slot), and
      ``complete`` sums ``w[k, a] · stack[k, a]`` in slot order from
      ``w₀·o₀``.  Here slot k of agent a *is* row block ``src[k, a]`` of
      the payload, unchanged between the two calls, so reading it in
      place through the source table computes the same terms in the same
      order with the same roundings, and a late slot is a table entry
      (source: the agent itself).  The fused combine is the ring kernel
      for an unmasked ±1 ring round with no late slot (the pad slots as
      weight-0 self terms), else the source-table kernel (its tables in
      device buffers, :class:`_DeviceTables`; an int8 payload is gathered
      by the table into the q8 combine); the plain combine is the
      table's plain version on the decoded payload.  ``out=`` receives a
      fused combine's mix.  ``complete.prepare(step, late, device)``
      writes the step's tables into the device buffers, which a CUDA
      graph replay needs first (:mod:`repro_torch.train.graphs`).
    """
    wire = _no_f32(wire)
    _check_transport(transport)
    if transport == "ring_dma":
        raise ValueError("the overlap mixer takes transport 'auto' or "
                         "'ppermute' (the ring kernel is auto's choice)")
    if not isinstance(sched, GossipSchedule):
        _check_round(sched)
        sched = StaticSchedule(sched)
    for r in sched.rounds:
        _check_round(r)
    R = len(sched.rounds)
    K = max(len(r.terms) for r in sched.rounds)
    A = sched.n_agents

    def self_index(topo) -> int:
        si = next((k for k, t in enumerate(topo.terms) if t.shift == 0),
                  len(topo.terms))
        if si >= K:
            raise ValueError(f"{topo.name}: no self term and no pad slot to "
                             "degrade onto")
        return si

    selves = tuple(self_index(r) for r in sched.rounds)

    if engine != "ppermute":
        mix = make_schedule_mixer(sched, engine,
                                  agents_per_device=agents_per_device,
                                  use_fused_kernel=use_fused_kernel,
                                  wire=wire)
        Wk = Ik = None
        if engine == "dense":
            # per-term dense stacks: Wk = diag(wcol_k) P_k, Ik = diag(wcol_k)
            Wk = np.zeros((R, K, A, A), np.float32)
            Ik = np.zeros((R, K, A, A), np.float32)
            idx = np.arange(A)
            for r, topo in enumerate(sched.rounds):
                src, w = round_tables(topo)
                for k in range(len(topo.terms)):
                    Wk[r, k, idx, src[k]] = w[k]
                    Ik[r, k, idx, idx] = w[k]

        def complete(x, step=0, late=None, out=None):
            late = _late_mask(late, K)
            if late is None:
                return mix(x, step=step)
            if engine != "dense":
                raise ValueError("straggler degradation needs the ppermute "
                                 "or dense engine")
            if wire is not None:
                x = wire.decode(x)
            r = int(sched.round_index(int(step)))
            W_eff = np.where(late.reshape(K, 1, 1), Ik[r], Wk[r]).sum(
                axis=0, dtype=np.float32)
            return _dense_with(W_eff, x)

        complete.n_terms = K
        complete.self_index = selves
        complete.prepare = lambda step, late, device: None
        return (lambda x, step=0: x), complete

    _one_device(A, agents_per_device)
    tables = _DeviceTables([round_tables(r, K) for r in sched.rounds])
    pads = [[(int(t.shift), float(t.weight)) for t in r.terms]
            + [(0, 0.0)] * (K - len(r.terms)) for r in sched.rounds]

    def issue(x, step=0):
        return x

    def complete(payload, step=0, late=None, out=None):
        r = int(sched.round_index(int(step)))
        topo = sched.rounds[r]
        late = _late_mask(late, K)
        first = payload if wire is None else wire.payload_leaves(payload)[0]
        if not use_fused_kernel:        # the plain stack-and-combine
            x = payload if wire is None else wire.decode(payload)
            return kref.table_combine_ref(
                x, *tables.prepare(r, late, first.device))
        no_late = late is None or not late.any()
        if no_late and transport == "auto" and len(pads[r]) <= \
                ring_dma.MAX_TERMS and not _ring_unfit(
                    topo, payload, agents_per_device, wire):
            return kops.ring_combine(payload, pads[r], out=out)
        src, w = tables.prepare(r, late, first.device)
        if wire is None:
            return kops.table_combine(payload, src, w, out=out)
        return kops.table_combine_wire(payload, src, w, fmt=wire.fmt,
                                       block_rows=wire.block_rows, out=out)

    def prepare(step, late, device):
        """Write the tables of ``step`` (its round, ``late`` swapped in)
        into the device buffers the fused combine reads."""
        tables.prepare(int(sched.round_index(int(step))), _late_mask(late, K),
                       torch.device(device))

    complete.n_terms = K
    complete.self_index = selves
    complete.prepare = prepare
    return issue, complete


def build_mixer(sched, *, mode: str = "schedule", engine: str = "shifts",
                agents_per_device: int = 1, use_fused_kernel: bool = False,
                wire: Optional[WireCodec] = None,
                transport: str = "auto") -> Callable:
    """Single mixer entry point.  ``mode="static"`` takes a
    :class:`Topology` (or a period-1 schedule) and returns ``mix(x)``;
    ``mode="schedule"`` takes a
    :class:`~repro_torch.core.schedule.GossipSchedule` (a bare topology
    is wrapped static) and returns ``mix(x, step=0)``; both take
    ``out=``; ``mode="overlap"`` returns the ``(issue, complete)`` pair of
    :func:`make_overlap_mixer`."""
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
    if not isinstance(sched, GossipSchedule):
        _check_round(sched)
        sched = StaticSchedule(sched)
    if mode == "schedule":
        return make_schedule_mixer(sched, engine, **kw)
    if mode == "overlap":
        return make_overlap_mixer(sched, engine, **kw)
    raise ValueError(f"unknown mixer mode: {mode!r} (expected 'static', "
                     "'schedule' or 'overlap')")


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One policy group's mixing plan: the layout's
    :class:`~repro_torch.core.bus.BusGroup` (rows and cadence), its own
    :class:`~repro_torch.core.schedule.GossipSchedule` (None: the group
    opts out of gossip) and its stateless wire codec (None: f32)."""

    group: Any
    sched: Optional[GossipSchedule] = None
    wire: Optional[WireCodec] = None


def encode_rows(wire: WireCodec, seg: torch.Tensor):
    """A group's stateless wire payload of its rows ``seg`` (an ``(A,
    rows, 128)`` view of the bus): the codec's encode (no residual).  bf16
    is one cast (the payload itself); int8 encodes one agent's block at a
    time into the payload's buffers, so that the codec's temporaries stay
    one block large (the scale tiles lie within a block, so the payload is
    the whole group's encode)."""
    if wire.fmt == "bf16":
        return seg.to(torch.bfloat16)
    A, rows, _ = seg.shape
    q = torch.empty(seg.shape, dtype=torch.int8, device=seg.device)
    scale = torch.empty((A, rows // wire.block_rows), dtype=torch.float32,
                        device=seg.device)
    for a in range(A):
        qa, sa = wire.encode(seg[a])
        q[a].copy_(qa)
        scale[a].copy_(sa)
    return q, scale


def make_group_mixer(plans, *, engine: str = "ppermute",
                     agents_per_device: int = 1,
                     use_fused_kernel: bool = False) -> Callable:
    """Mixer of a policy-group bus (DESIGN §12): ``mix(bus, step=0,
    out=None) -> out``, the twin of the JAX package's
    ``make_group_mixer``.

    ``plans`` (:class:`GroupPlan`) cover the ``(A, rows, 128)`` bus with
    contiguous row ranges.  Per step:

    * an opt-out group (``gossip_every == 0`` or no schedule) builds no
      mixer: its rows are copied from ``bus`` into ``out``;
    * a ``gossip_every = k > 1`` group mixes on the steps with
      ``step % k == k − 1``, at round ``step // k`` of its schedule, and
      is copied on the others;
    * an every-step group mixes at round ``step``.

    A mixing group runs the unmodified one-device engines
    (:func:`make_schedule_mixer`) on its rows — the view ``bus[:, r0:r1]``,
    or with a bf16 / int8 wire that view's stateless payload
    (:func:`encode_rows`) — and they write its mix into ``out[:, r0:r1]``
    (the ring, table and combine kernels read and write the rows in place;
    any other result is copied there).  ``out`` (default: a new bus) may
    alias no byte of ``bus``; no step concatenates a bus."""
    plans = sorted(plans, key=lambda p: p.group.row)
    segments = []       # (row, rows, mixer or None, wire, cadence)
    cursor = 0
    for plan in plans:
        g = plan.group
        if g.row != cursor:
            raise ValueError(f"group {g.name!r} starts at row {g.row}, "
                             f"expected {cursor}: the plans must cover the "
                             "bus in contiguous row ranges")
        cursor = g.row + g.rows
        if g.rows == 0:
            continue
        if g.gossip_every == 0 or plan.sched is None:
            segments.append((g.row, g.rows, None, None, 0))
            continue
        wire = _no_f32(plan.wire)
        inner = make_schedule_mixer(plan.sched, engine,
                                    agents_per_device=agents_per_device,
                                    use_fused_kernel=use_fused_kernel,
                                    wire=wire)
        segments.append((g.row, g.rows, inner, wire, g.gossip_every))

    def mix(bus: torch.Tensor, step: int = 0,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if bus.dim() != 3 or bus.shape[1] != cursor:
            raise ValueError(f"the group mixer takes (A, {cursor}, 128) "
                             f"buses, got {tuple(bus.shape)}")
        if out is None:
            out = torch.empty_like(bus)
        step = int(step)
        for row, rows, inner, wire, k in segments:
            seg, dst = bus[:, row:row + rows], out[:, row:row + rows]
            if inner is None or (k > 1 and step % k != k - 1):
                dst.copy_(seg)
                continue
            payload = seg if wire is None else encode_rows(wire, seg)
            res = inner(payload, step=step // k if k > 1 else step, out=dst)
            if res is not dst:
                dst.copy_(res)
        return out

    return mix
