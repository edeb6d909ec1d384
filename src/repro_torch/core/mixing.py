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
  kernel (``use_fused_kernel=True``) or the plain weighted sum.
  On a tree the combine is one ``gossip_axpy`` launch per leaf.
* :func:`mix_ranks` — the ``ppermute`` engine across ``torch.distributed``
  ranks (a :class:`~repro_torch.core.comm.GossipMesh`, ``mesh=`` of the
  factories): this rank's agent block, one permute round a gossip term
  (the reference's wire plan, :func:`_make_permute_term`: literal
  source → target pairs, hierarchical terms on the ``pod`` / ``data``
  axis, blocked rolls of B > 1 agents a rank, row shards), the same
  combine kernels, so a multi-rank run is bit-equal to the one-process
  run; a flat ±1 ring of one f32 agent a rank on the card runs the
  peer-pointer ring kernel (:mod:`repro_torch.kernels.ring_peer`), any
  other round, wire (the int8 one through the peer q8 kernel), agent
  block or row shard the peer table kernels, a rank's tree (one agent or
  a block) packed into one f32 payload (:class:`TreePayload`).
  :func:`mix_dense_sharded` is the shard-resident dense oracle.

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
import torch.distributed as dist

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ring_dma
from repro_torch.kernels.ring_peer import PeerRing
from repro_torch.kernels.table_peer import MAX_BLOCK, MAX_SOURCES, PeerTable

from . import comm as coll
from .comm import axes_group, gossip_agent_axes
from .elastic import is_masked
from .schedule import GossipSchedule, StaticSchedule
from .topology import ShiftTerm, Topology
from .wire import WireCodec

__all__ = ["TRANSPORTS", "mix_dense", "mix_shifts", "mix_ppermute",
           "mix_ranks", "mix_dense_sharded", "TreePayload",
           "wire_terms", "round_tables", "make_mixer", "make_schedule_mixer",
           "make_overlap_mixer", "build_mixer", "rank_routes", "GroupPlan",
           "encode_rows",
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
    agents spread over ranks need a mesh (:func:`mix_ranks`)."""
    if agents_per_device < 1 or A % agents_per_device:
        raise ValueError(f"agent count {A} must be a multiple of "
                         f"agents_per_device={agents_per_device}")
    n_devices = A // agents_per_device
    if n_devices != 1:
        raise ValueError(
            f"ppermute gossip over {n_devices} devices (agents_per_device="
            f"{agents_per_device} < {A} agents) runs one rank per device: "
            "pass mesh= (repro_torch.launch.mesh.make_gossip_mesh) and this "
            f"rank's agent block, or agents_per_device={A} to keep every "
            "agent on one device")


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


# ---------------------------------------------------------------------------
# multi-rank gossip: one agent block per rank (DESIGN §3–4, §7)
# ---------------------------------------------------------------------------


def _agent_axis_info(topo: Topology, mesh, agent_axes):
    """Resolve ``agent_axes`` against the mesh, as the reference's: returns
    ``(names, sizes, split, B)`` — B agents per rank (blocked when > 1:
    contiguous blocks of B on M = A / B ranks); ``split`` when the
    topology's (P, D) grid maps 1:1 onto two mesh axes, so that inter and
    intra terms permute along one axis each."""
    names = (tuple(agent_axes) if isinstance(agent_axes, (tuple, list))
             else (agent_axes,))
    sizes = tuple(mesh.axis_size(n) for n in names)
    M = int(np.prod(sizes))
    if topo.n_agents % M:
        raise ValueError(f"agent count {topo.n_agents} must be a multiple of "
                         f"the mesh agent extent {M} (axes {names})")
    B = topo.n_agents // M
    if B != 1 and len(names) != 1:
        raise ValueError("blocked gossip (agents > ranks) needs a single "
                         "flat agent axis")
    split = (B == 1 and len(names) == 2 and topo.grid is not None
             and sizes == topo.grid_shape())
    return names, sizes, split, B


def _flat_index(mesh, names, sizes) -> int:
    """This rank's flat index along the agent axes (mixed radix)."""
    idx = 0
    for n, size in zip(names, sizes):
        idx = idx * size + mesh.axis_index(n)
    return idx


class _Joined:
    """The pending parts of one term's payload, joined along the agent axis
    when waited on (a blocked roll's boundary rows before its body)."""

    def __init__(self, parts):
        self.parts = parts

    def wait(self) -> torch.Tensor:
        return torch.cat([p.wait() for p in self.parts], 0)


def _blocked_roll(x, shift: int, bloc: int, n_ring: int, n_dev: int,
                  permute: Callable):
    """Blocked circulant roll, as the reference's: this rank's block of
    ``roll(x_global, shift)`` where each of ``n_ring`` consecutive ranks
    holds ``bloc`` consecutive elements of one ring (rings tile the
    ``n_dev`` ranks).  shift = q·bloc + r: rows ``[0, bloc − r)`` come from
    q hops back, the r boundary rows from q + 1 — at most two permutes; a
    part whose hop count is ≡ 0 (mod the ring) stays local, so a sub-block
    shift ships only its r boundary rows.  ``permute(part, pairs, i)``
    starts part i's permute; returns the roll pending (``wait()``)."""
    n_elems = bloc * n_ring
    s = shift % n_elems
    if s == 0:
        return coll.Pending(x)
    q, r = divmod(s, bloc)

    def perm(hops):
        hops %= n_ring
        return [(g * n_ring + (c - hops) % n_ring, d)
                for d in range(n_dev) for g, c in [divmod(d, n_ring)]]

    p1 = x[:bloc - r] if r else x
    p1 = permute(p1, perm(q), 0) if q % n_ring else coll.Pending(p1)
    if not r:
        return p1
    p2 = x[bloc - r:]
    p2 = permute(p2, perm(q + 1), 1) if (q + 1) % n_ring \
        else coll.Pending(p2)
    return _Joined([p2, p1])


def _make_permute_start(topo: Topology, mesh, names, sizes, split: bool,
                        B: int) -> Callable:
    """The per-term wire plan of the multi-rank engine: ``start(x, t, tag)``
    starts term ``t``'s permutes of this rank's agent block and returns
    them pending (``wait()`` gives the term's payload) — the one plan every
    multi-rank engine uses, as in the reference, so the engines cannot
    drift in what they put on the wire.  Each permute is one
    :func:`repro_torch.core.comm.ppermute_start` round with literal
    source → target pairs; ``tag`` tells apart the permutes a caller keeps
    in flight together (one a term and payload component)."""
    A = topo.n_agents
    M = A // B
    Pn, Dn = topo.grid_shape()
    ranks, group = axes_group(mesh, names)

    def flat(x, pairs, tag):
        return coll.ppermute_start(x, pairs, ranks, group, p2p_tag=tag)

    def start_blocked(x, t, tag):
        def part(p, pairs, i):
            return flat(p, pairs, 2 * tag + i)

        if t.level == "flat":
            return _blocked_roll(x, t.shift, B, M, M, part)
        if t.level == "inter":
            # an inter roll by s pods is the flat roll by s·D agents
            return _blocked_roll(x, t.shift * Dn, B, M, M, part)
        if B % Dn == 0:          # whole pods per rank: a local roll
            g = x.reshape((B // Dn, Dn) + tuple(x.shape[1:]))
            return coll.Pending(torch.roll(g, t.shift, 1).reshape(x.shape))
        if Dn % B:
            raise ValueError(f"blocked intra gossip needs pod size {Dn} and "
                             f"block {B} aligned")
        return _blocked_roll(x, t.shift, B, Dn // B, M, part)

    def start(x, t, tag: int = 0):
        if t.shift == 0 or A == 1:
            return coll.Pending(x)
        if B > 1:
            return start_blocked(x, t, tag)
        if split and t.level != "flat":
            ax, size = ((names[0], Pn) if t.level == "inter"
                        else (names[1], Dn))
            if size == 1:
                return coll.Pending(x)
            pairs = [((i - t.shift) % size, i) for i in range(size)]
            return coll.ppermute_start(x, pairs, mesh.ranks(ax),
                                       mesh.group(ax), p2p_tag=2 * tag)
        src = topo.term_sources(t)
        return flat(x, [(int(s_), d) for d, s_ in enumerate(src)], 2 * tag)

    return start


def _make_permute_term(topo: Topology, mesh, names, sizes, split: bool,
                       B: int) -> Callable:
    """``permute_term(x, t)``: term ``t``'s payload of this rank's agent
    block, its permutes (:func:`_make_permute_start`) started and waited
    on."""
    start = _make_permute_start(topo, mesh, names, sizes, split, B)
    return lambda x, t: start(x, t).wait()


# the leaf dtypes a tree payload carries: their upcast to f32 is exact, and
# the combine kernels round their f32 sums to them as one cast does
_TREE_DTYPES = (torch.float32, torch.bfloat16)


class TreePayload:
    """A rank's tree in the peer transports' ``(B, rows, 128)`` f32 payload
    (B agents a rank, every leaf ``(B, *shape)``): row block b holds agent
    b's leaves in sorted path order, each flattened and upcast to f32
    (exact for f32 and bf16 leaves) right after the last, the tail of the
    block zero.  :meth:`pack` writes a tree into a payload buffer (the
    transport's own shared one), :meth:`unpack` reads the combine's f32
    result back into the tree's leaves, rounding once to each leaf's
    dtype.  The combine kernels add the same terms in the same order with
    the same f32 roundings whatever the element's place, so one combine
    over the packed payload, then the rounding, equals one
    ``gossip_axpy`` a leaf (one ``table_combine`` on a masked round: f32
    accumulation in term order, one rounding to the leaf's dtype), bit for
    bit."""

    def __init__(self, tree: Mapping[str, torch.Tensor]):
        self.offsets: Dict[str, int] = {}
        n = 0
        for p in sorted(tree):
            self.offsets[p] = n
            n += tree[p][0].numel()
        self.numel = n              # one agent's elements
        B = len(next(iter(tree.values())))
        self.shape = (B, max(1, -(-n // ring_dma.LANE)), ring_dma.LANE)

    def pack(self, tree: Mapping[str, torch.Tensor],
             dst: torch.Tensor) -> torch.Tensor:
        flat = dst.view(self.shape[0], -1)      # a row of it an agent
        for p, o in self.offsets.items():
            leaf = tree[p]
            flat[:, o:o + leaf[0].numel()].view(leaf.shape).copy_(leaf)
        flat[:, self.numel:].zero_()
        return dst

    def unpack(self, src: torch.Tensor, like: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        flat = src.view(self.shape[0], -1)
        return {p: flat[:, self.offsets[p]:self.offsets[p] + v[0].numel()]
                .view(v.shape).to(v.dtype) for p, v in like.items()}


def _payload_unfit(x, wire: Optional[WireCodec] = None, B: int = 1) -> str:
    """Why ``x`` is no payload of the peer transports, or '': a ``(B,
    rows, 128)`` f32 bus block, the bf16 wire's ``(B, rows, 128)`` payload,
    the int8 wire's ``(q, scale)`` (``(B, rows, 128)`` int8, ``(B, rows //
    block_rows)`` f32), or a tree of B ≤ ``MAX_BLOCK`` agents' f32 / bf16
    leaves, each ``(B, ...)`` (:class:`TreePayload`)."""
    if isinstance(x, Mapping):
        bad = sorted(p for p, v in x.items()
                     if v.dtype not in _TREE_DTYPES or v.shape[:1] != (B,))
        if x and not bad and 1 <= B <= MAX_BLOCK:
            return ""
        return (f"needs a tree of 1..{MAX_BLOCK} agents' f32 / bf16 leaves "
                f"(B, ...), got "
                f"{[(p, str(x[p].dtype), tuple(x[p].shape)) for p in bad[:3]]}"
                f" at {B} agents a rank")
    want = torch.float32 if wire is None else wire.wire_dtype
    leaves = (x,) if wire is None else wire.payload_leaves(x)
    q = leaves[0]
    ok = (isinstance(q, torch.Tensor) and q.dim() == 3
          and q.shape[0] == B and q.shape[-1] == ring_dma.LANE
          and q.dtype == want)
    if ok and wire is not None and wire.fmt == "int8":
        sc = leaves[1]
        ok = (q.shape[1] % wire.block_rows == 0 and sc.dtype == torch.float32
              and tuple(sc.shape) == (B, q.shape[1] // wire.block_rows))
    if ok:
        return ""
    got = [(str(getattr(t, "dtype", type(t).__name__)),
            tuple(getattr(t, "shape", ()))) for t in leaves]
    scales = (" with its (B, rows // block_rows) f32 scales"
              if want == torch.int8 else "")
    return f"needs a ({B}, rows, 128) {want} payload{scales}, got {got}"


def _like_spec(like: torch.Tensor, wire: Optional[WireCodec]) -> Tuple:
    """The peer table's ``(shape, dtype, block_rows)`` for the payload of
    the f32 bus block ``like`` (the wire's encode of it)."""
    if wire is None:
        return tuple(like.shape), torch.float32, None
    return (tuple(like.shape), wire.wire_dtype,
            wire.block_rows if wire.fmt == "int8" else None)


def _payload_spec(x, wire: Optional[WireCodec]) -> Tuple:
    """The peer table's ``(shape, dtype, block_rows)`` for payload ``x``."""
    if isinstance(x, Mapping):
        return TreePayload(x).shape, torch.float32, None
    return _like_spec(x if wire is None else wire.payload_leaves(x)[0], wire)


def _peer_unfit(topo: Topology, mesh, x, names, B: int, shard_axes,
                wire: Optional[WireCodec]) -> str:
    """Why the peer-pointer ring cannot carry this rank's gossip, or '' —
    the reference's ``ring_dma_supported`` across devices: a flat ±1 ring,
    one agent per rank on one agent axis, every rank of it on this host
    (CUDA IPC opens no handle of another host), no wire, an unmasked
    round, a ``(1, rows, 128)`` f32 payload (a row shard's rows with
    ``shard_axes``: the ring is the ``pod``-axis slice through the rank)
    or a tree of one agent's f32 / bf16 leaves (``x`` None checks the
    rest)."""
    if is_masked(topo):
        return f"takes unmasked rings, got the masked round {topo.name}"
    if wire is not None:
        return f"takes f32 payloads, not the {wire.fmt} wire"
    if ring_dma.ring_plan(topo) is None:
        return f"needs a flat ±1 ring, got the {topo.name} topology"
    if B != 1 or len(names) != 1:
        return (f"needs one agent a rank on one agent axis, got {B} on "
                f"{names}")
    ranks, _ = axes_group(mesh, names)
    if not mesh.one_host(ranks):
        return (f"needs every rank of the ring on one host, got hosts "
                f"{sorted({mesh.hosts[r] for r in ranks})}")
    return "" if x is None else _payload_unfit(x)


def _exchange(mesh, ranks, handle: bytes):
    """Every rank of ``ranks``' IPC handle, in that order (a collective over
    the mesh's control group)."""
    got = [None] * dist.get_world_size(group=mesh.control)
    dist.all_gather_object(got, (dist.get_rank(), handle),
                           group=mesh.control)
    by_rank = dict(got)
    return [by_rank[r] for r in ranks]


class _PeerSlot:
    """The peer ring a schedule mixer's ring rounds share (made at the
    first call, collectively, with the payload's shape: the ring's ranks
    exchange their IPC handles over the mesh's control group)."""

    def __init__(self, mesh, names, B: int):
        self.mesh, self.names, self.B, self.ring = mesh, names, B, None

    def get(self, shape, device) -> PeerRing:
        shape = tuple(shape)
        if self.ring is None:
            ranks, _ = axes_group(self.mesh, self.names)
            ring = PeerRing(shape, device, ranks.index(dist.get_rank()),
                            len(ranks))
            ring.open(_exchange(self.mesh, ranks, ring.handle))
            self.ring = ring
        elif self.ring.shape != shape:
            raise ValueError(f"the peer ring holds {self.ring.shape} "
                             f"payloads, got {shape}")
        return self.ring

    def close(self) -> None:
        """Free the ring once every rank of it is done (collective)."""
        if self.ring is not None:
            torch.cuda.synchronize(self.ring.device)
            dist.barrier(group=self.mesh.control)
            self.ring.close()
            self.ring = None


class _TableSlot:
    """The peer table a mixer's table rounds share (made at the first call,
    collectively, as :class:`_PeerSlot`; every rank of the agent axes maps
    every other's payloads), for one payload spec ``(shape, dtype,
    block_rows)`` (:func:`_payload_spec`)."""

    def __init__(self, mesh, names):
        self.mesh, self.names, self.table = mesh, names, None

    def get(self, spec, device) -> PeerTable:
        shape, dtype, block_rows = spec
        spec = (tuple(shape), dtype, block_rows)
        if self.table is None:
            ranks, _ = axes_group(self.mesh, self.names)
            sizes = tuple(self.mesh.axis_size(n) for n in self.names)
            table = PeerTable(spec[0], device,
                              _flat_index(self.mesh, self.names, sizes),
                              len(ranks), dtype=dtype, block_rows=block_rows)
            table.open(_exchange(self.mesh, ranks, table.handle))
            self.table = table
        elif self.table.spec != spec:
            raise ValueError(f"the peer table holds {self.table.spec} "
                             f"payloads, got {spec}")
        return self.table

    def close(self) -> None:
        """Free the table once every rank of it is done (collective)."""
        if self.table is not None:
            torch.cuda.synchronize(self.table.device)
            dist.barrier(group=self.mesh.control)
            self.table.close()
            self.table = None


def _table_unfit(mesh, x, names, B: int, shard_axes,
                 wire: Optional[WireCodec]) -> str:
    """Why the peer table (:class:`repro_torch.kernels.table_peer.
    PeerTable`) cannot carry this rank's gossip, or '': at most
    ``MAX_BLOCK`` agents a rank, every rank of the agent axes on this host
    (at most 16), a payload of a spec the table takes — a ``(B, rows,
    128)`` f32 block (a row shard's rows with ``shard_axes``), the bf16 or
    int8 wire's payload of it, or a tree of the B agents' f32 / bf16 leaves
    (``x`` None checks the rest).  Any round fits: a ±1 ring, an
    exponential hop, a time-varying schedule's round, a masked round, late
    slots."""
    if not 1 <= B <= MAX_BLOCK:
        return f"takes 1..{MAX_BLOCK} agents a rank, got {B}"
    ranks, _ = axes_group(mesh, names)
    if len(ranks) > MAX_SOURCES:
        return f"maps at most {MAX_SOURCES} ranks, got {len(ranks)}"
    if not mesh.one_host(ranks):
        return (f"needs every rank of the agent axes on one host, got hosts "
                f"{sorted({mesh.hosts[r] for r in ranks})}")
    return "" if x is None else _payload_unfit(x, _no_f32(wire), B)


def _readers(src: np.ndarray, i: int, B: int = 1) -> List[int]:
    """The ranks whose columns of the ``(K, A)`` source table (B agents a
    rank) read an agent of rank ``i`` (itself left out)."""
    return [j for j in range(src.shape[1] // B) if j != i
            and (src[:, j * B:(j + 1) * B] // B == i).any()]


def _rank_cols(src: np.ndarray, w: np.ndarray, i: int, B: int):
    """Rank ``i``'s ``(K, B)`` columns of a round's source table."""
    return src[:, i * B:(i + 1) * B], w[:, i * B:(i + 1) * B]


def mix_ranks(topo: Topology, mesh, x, *, agent_axes=None,
              use_fused_kernel: bool = False,
              wire: Optional[WireCodec] = None, transport: str = "auto",
              shard_axes: Optional[str] = None,
              out: Optional[torch.Tensor] = None, _peer=None, _table=None):
    """The ``ppermute`` engine across ranks: the twin of the reference's
    ``mix_ppermute`` under a mesh.  ``x`` is this rank's agent block
    (``(B, ...)``, a tensor or a tree; with ``shard_axes`` its ``(1,
    rows/S, ...)`` row block; with a non-f32 ``wire`` the codec's payload of
    it).  ``agent_axes`` default to :func:`~repro_torch.core.comm.
    gossip_agent_axes` of the mesh.

    * B = 1: each term is one permute straight from
      :meth:`Topology.term_sources`; a hierarchical topology whose grid is
      the mesh's permutes along the ``pod`` or ``data`` axis (split), else
      along the flattened axes.  Blocked (B > 1): the blocked-roll plan
      (:func:`_blocked_roll`).  Row shards: the same permutes, each on the
      shard's own rows (no gather).
    * The combine is the one-device engine's (:func:`_combine`: one
      ``gossip_axpy`` launch when fused, the plain weighted sum else) on
      the permuted payloads in term order — so a multi-rank run is bit-equal
      to the one-process run.  A wire payload permutes component by
      component and decodes in the combine (``gossip_axpy_wire``).
    * A masked round at B = 1 permutes from its source maps and combines
      with this rank's weight column; at B > 1 its payload (each component)
      is all-gathered along the agent axes and the one-device masked mixer
      runs on it, keeping this rank's block (the reference's
      gather-and-index fallback).
    * ``transport``: on CUDA, a flat ±1 ring with one agent a rank and an
      f32 payload (a row shard's rows included: the ring is the
      ``pod``-axis slice), every rank of the ring on one host, runs the
      peer-pointer ring kernel (:class:`repro_torch.kernels.ring_peer.
      PeerRing`) when forced (``"ring_dma"``) or fused under ``"auto"``;
      any other gossip of ranks on one host fused under ``"auto"`` — an
      exponential hop, a masked round, a bf16 or int8 wire payload (its
      encoder writes it into the table's slot, :func:`make_schedule_mixer`'s
      ``payload_for_write``; else one copy), an agent block of B > 1
      (masked rounds included), a row shard — runs the peer table kernels
      (:class:`repro_torch.kernels.table_peer.PeerTable`: this rank's
      ``(K, B)`` columns of the round's source table; the q8 kernel on
      the int8 wire).  A tree goes through either as one payload
      (:class:`TreePayload`: its leaves packed into the transport's shared
      buffer, one combine, each leaf rounded back once), bit-equal to the
      per-leaf combines; a tree of B > 1 agents a rank through the table,
      a row block an agent.  On the CPU those transports are the permutes
      plus the plain combine.  Ranks that share one card have no NCCL:
      any other gossip raises there."""
    _check_transport(transport)
    if agent_axes is None:
        agent_axes = gossip_agent_axes(mesh, sharded=shard_axes is not None)
    names, sizes, split, B = _agent_axis_info(topo, mesh, agent_axes)
    if shard_axes is not None:
        if shard_axes in names:
            raise ValueError(f"shard axis {shard_axes!r} is an agent axis")
        if B != 1:
            raise ValueError("shard-resident gossip needs one agent per mesh "
                             "slice")
    wire = _no_f32(wire)
    masked = is_masked(topo)
    first = (next(iter(x.values())) if isinstance(x, Mapping)
             else x if wire is None else wire.payload_leaves(x)[0])
    why = _peer_unfit(topo, mesh, x if wire is None else None, names, B,
                      shard_axes, wire)
    if transport == "ring_dma" and why:
        raise ValueError(f"transport='ring_dma' {why}")
    on_card = first.device.type == "cuda"
    tree = TreePayload(x) if isinstance(x, Mapping) else None
    shape = tree.shape if tree is not None else getattr(x, "shape", ())
    if on_card and not why and (transport == "ring_dma" or (
            transport == "auto" and use_fused_kernel)):
        peer = (_peer or _PeerSlot(mesh, names, B)).get(shape, first.device)
        terms = [(t.shift, float(t.weight)) for t in topo.terms]
        if tree is None:
            return peer.combine(terms, out=out, payload=x)
        buf = tree.pack(x, peer.payload_for_write())
        return tree.unpack(peer.combine(terms, payload=buf), x)
    why_t = _table_unfit(mesh, x, names, B, shard_axes, wire)
    if on_card and not why_t and transport == "auto" and use_fused_kernel:
        table = (_table or _TableSlot(mesh, names)).get(
            _payload_spec(x, wire), first.device)
        src, w = round_tables(topo)
        i = table.me
        readers = _readers(src, i, B)
        if tree is None:
            table.publish(x, readers)
        else:
            tree.pack(x, table.slot_for_write(readers))
            table.publish(None, readers)
        res = table.combine(*_rank_cols(src, w, i, B),
                            out=out if tree is None else None)
        return res if tree is None else tree.unpack(res, x)
    if on_card and mesh.shared:
        raise ValueError(
            f"ranks share one card here ({first.device}), so there is no "
            f"NCCL: only the fused peer-pointer kernels carry their gossip; "
            f"the ring {why or 'needs use_fused_kernel=True'}, the table "
            f"{why_t or 'needs use_fused_kernel=True'}")
    permute_term = _make_permute_term(topo, mesh, names, sizes, split, B)
    weights = [float(t.weight) for t in topo.terms]
    if masked and B > 1:
        ranks, group = axes_group(mesh, names)
        glob = _masked_mixer(topo, "ppermute", topo.n_agents,
                             use_fused_kernel, wire)
        i = _flat_index(mesh, names, sizes)

        def gather(leaf):
            return coll.all_gather(leaf, group, len(ranks))

        full = (wire.map_payload(gather, x) if wire is not None
                else tree_map(gather, x))
        return tree_map(lambda v: v[i * B:(i + 1) * B], glob(full))
    if masked:
        # B = 1: the permutes come from the masked source maps (the generic
        # term_sources branch); the weights are this rank's column
        i = _flat_index(mesh, names, sizes)
        weights = [float(w) for w in round_tables(topo)[1][:, i]]
    if wire is not None:
        pays = [wire.map_payload(lambda l, t=t: permute_term(l, t), x)
                for t in topo.terms]
        if use_fused_kernel:
            return kops.gossip_axpy_wire(pays, weights, fmt=wire.fmt,
                                         block_rows=wire.block_rows, out=out)
        return _combine([wire.decode(p) for p in pays], weights, False)
    if isinstance(x, Mapping):
        return tree_map(lambda leaf: _combine(
            [permute_term(leaf, t) for t in topo.terms], weights,
            use_fused_kernel), x)
    return _combine([permute_term(x, t) for t in topo.terms], weights,
                    use_fused_kernel, out=out)


def mix_dense_sharded(topo: Topology, mesh, agent_axes, shard_axes, x):
    """Shard-resident dense oracle (DESIGN §7), the reference's: each rank
    all-gathers its own row block along the agent axes only (never the
    shard axis), applies the dense W to the gathered ``(A, rows/S, ...)``
    stack and keeps its own agent — row-sharded end to end.  ``x``: this
    rank's ``(1, rows/S, ...)`` block, or a tree of them."""
    names, sizes, _, B = _agent_axis_info(topo, mesh, agent_axes)
    if B != 1:
        raise ValueError("the shard-resident dense oracle needs one agent "
                         "per slice")
    if shard_axes is not None and shard_axes in names:
        raise ValueError(f"shard axis {shard_axes!r} is an agent axis")
    ranks, group = axes_group(mesh, names)
    i = _flat_index(mesh, names, sizes)
    W = topo.dense_matrix()

    def leaf(v):
        gathered = coll.all_gather(v, group, len(ranks))   # (A, rows/S, ...)
        return _dense_with(W, gathered)[i:i + 1]

    return tree_map(leaf, x)


def _check_round(topo) -> None:
    if not isinstance(topo, Topology):
        raise TypeError(f"gossip round {type(topo).__name__} is not a "
                        "repro_torch Topology (a masked round is its "
                        "MaskedTopology subclass)")


def _rank_mixer(topo: Topology, engine: str, mesh, shard_axes,
                use_fused_kernel: bool, wire: Optional[WireCodec],
                transport: str, peer: Optional[_PeerSlot],
                table: Optional[_TableSlot] = None) -> Callable:
    """``mix(x, out=None)`` of one round across ranks (:func:`mix_ranks`);
    only the ppermute engine runs on ranks."""
    if engine != "ppermute":
        raise ValueError(f"gossip across ranks runs the ppermute engine, not "
                         f"{engine!r} (the dense oracle across ranks is "
                         "mix_dense_sharded)")
    axes = gossip_agent_axes(mesh, sharded=shard_axes is not None)
    names, _, _, B = _agent_axis_info(topo, mesh, axes)
    if transport == "ring_dma":
        why = _peer_unfit(topo, mesh, None, names, B, shard_axes,
                          _no_f32(wire))
        if why:
            raise ValueError(f"transport='ring_dma' {why}")
    peer = peer or _PeerSlot(mesh, names, B)
    table = table or _TableSlot(mesh, names)
    return lambda x, out=None: mix_ranks(
        topo, mesh, x, agent_axes=axes, use_fused_kernel=use_fused_kernel,
        wire=wire, transport=transport, shard_axes=shard_axes, out=out,
        _peer=peer, _table=table)


def make_mixer(topo: Topology, engine: str = "shifts", *,
               agents_per_device: int = 1, use_fused_kernel: bool = False,
               wire: Optional[WireCodec] = None,
               transport: str = "auto", mesh=None,
               shard_axes: Optional[str] = None) -> Callable:
    """Return ``mix(x, out=None) -> x``.  engine ∈ {"dense", "shifts",
    "ppermute"}; ``agents_per_device``, ``use_fused_kernel`` and
    ``transport`` are read by the ppermute engine only, as in the JAX
    package (a forced ``"ring_dma"`` on another engine, a wire or a
    topology that is not a ±1 ring raises here).  With a non-f32 ``wire``
    the mixer takes the codec's payload and returns the f32 mix; dense
    and shifts decode first.

    ``mesh`` (a :class:`~repro_torch.core.comm.GossipMesh`, in place of
    the reference's ``mesh, agent_axes``) runs the round across ranks on
    this rank's agent block (:func:`mix_ranks`; the agent axes are the
    mesh's, ``shard_axes`` names its row-shard axis)."""
    _check_round(topo)
    _check_transport(transport)
    if mesh is not None:
        return _rank_mixer(topo, engine, mesh, shard_axes, use_fused_kernel,
                           wire, transport, None)
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
                        transport: str = "auto", mesh=None,
                        shard_axes: Optional[str] = None) -> Callable:
    """Step-indexed mixer over a schedule: ``mix(x, step=0, out=None)``
    applies round ``sched.round_index(step)`` through the chosen engine.
    Every round has its own engine closure; the step is a Python int, so
    the round is picked in Python.  Across ranks (``mesh``) the ring rounds
    share one peer ring and its other rounds on the card one peer table;
    ``mix.payload_for_write(step, like)`` gives the buffer a step's
    payload of the f32 bus block ``like`` should be written into, in the
    wire's form (the peer ring's, or the peer table's next slot, once the
    ranks that read its last payload are done; None when that step's
    round runs neither on this device).  ``mix.transports()`` lists the
    peer transports made so far, ``mix.close()`` frees them
    (collective)."""
    peer = table = None
    if mesh is not None:
        if engine != "ppermute":
            raise ValueError(f"gossip across ranks runs the ppermute engine, "
                             f"not {engine!r}")
        axes = gossip_agent_axes(mesh, sharded=shard_axes is not None)
        names, _, _, B = _agent_axis_info(sched.rounds[0], mesh, axes)
        peer = _PeerSlot(mesh, names, B)
        table = _TableSlot(mesh, names)
        mixers = [_rank_mixer(r, engine, mesh, shard_axes, use_fused_kernel,
                              wire, transport, peer, table)
                  for r in sched.rounds]
    else:
        mixers = [make_mixer(r, engine, agents_per_device=agents_per_device,
                             use_fused_kernel=use_fused_kernel, wire=wire,
                             transport=transport)
                  for r in sched.rounds]
    if len(mixers) == 1:
        mix = lambda x, step=0, out=None: mixers[0](x, out=out)  # noqa: E731
    else:
        mix = lambda x, step=0, out=None: mixers[  # noqa: E731
            int(sched.round_index(int(step)))](x, out=out)

    def payload_for_write(step: int, like: torch.Tensor):
        if peer is None or like.device.type != "cuda" or not (
                transport == "ring_dma"
                or (transport == "auto" and use_fused_kernel)):
            return None
        topo = sched.rounds[int(sched.round_index(int(step)))]
        wire_ = _no_f32(wire)
        if wire_ is None and not _peer_unfit(topo, mesh, like, peer.names,
                                             peer.B, shard_axes, None):
            return peer.get(like.shape, like.device).payload_for_write()
        if transport != "auto" or _table_unfit(mesh, None, peer.names,
                                               peer.B, shard_axes, wire_):
            return None
        tab = table.get(_like_spec(like, wire_), like.device)
        src, _ = round_tables(topo)
        return tab.slot_for_write(_readers(src, tab.me, peer.B))

    mix.payload_for_write = payload_for_write
    mix.peer = peer
    mix.transports = lambda: [t for t in (peer and peer.ring,
                                          table and table.table) if t]
    mix.close = lambda: [sl.close() for sl in (peer, table) if sl]
    return mix


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
                       transport: str = "auto", mesh=None,
                       shard_axes: Optional[str] = None):
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
    * ``ppermute`` across ranks (``mesh``, the reference's ppermute
      branch; :func:`_rank_overlap_mixer`): ``issue`` starts the round's
      permutes of this rank's block, one a term and payload component
      (:func:`_make_permute_start`), and returns them in flight; the
      caller's backward pass runs while they travel; ``complete`` waits
      on them, swaps each late slot for the self payload and combines
      with this rank's weight column (``gossip_axpy`` or its q8 twin).
      Ranks of one host on the card: ``issue`` publishes the payload (f32,
      or the wire's; B agents a rank) into the peer table
      (:class:`repro_torch.kernels.table_peer.PeerTable`, double
      buffered) and ``complete`` waits for its sources and runs the ring
      kernel (one f32 agent a rank, a ±1 ring round with no late slot),
      the q8 kernel (int8) or the table kernel.
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
        if mesh is not None:
            raise ValueError(f"gossip across ranks runs the ppermute engine, "
                             f"not {engine!r}")
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

    if mesh is not None:
        return _rank_overlap_mixer(sched, K, selves, mesh, shard_axes,
                                   use_fused_kernel, wire, transport)
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


@dataclasses.dataclass
class _Issued:
    """A round's payloads in flight across ranks: ``pending[k][c]`` is
    slot k's payload component c (a weight-0 pad slot: the unpermuted
    payload), or, with ``pending`` None, the payload published into the
    peer table."""

    round: int
    pending: Optional[list] = None


def _rank_overlap_mixer(sched: GossipSchedule, K: int, selves, mesh,
                        shard_axes, use_fused_kernel: bool,
                        wire: Optional[WireCodec], transport: str):
    """:func:`make_overlap_mixer`'s ``(issue, complete)`` across ranks."""
    axes = gossip_agent_axes(mesh, sharded=shard_axes is not None)
    infos = [_agent_axis_info(r, mesh, axes) for r in sched.rounds]
    names, sizes, _, B = infos[0]
    if shard_axes is not None:
        if shard_axes in names:
            raise ValueError(f"shard axis {shard_axes!r} is an agent axis")
        if B != 1:
            raise ValueError("shard-resident gossip needs one agent per mesh "
                             "slice")
    if B != 1 and any(is_masked(r) for r in sched.rounds):
        raise ValueError("masked overlap gossip needs one agent per rank "
                         "(B = 1), as the reference's")
    starts = [_make_permute_start(r, mesh, *info)
              for r, info in zip(sched.rounds, infos)]
    i = _flat_index(mesh, names, sizes)
    tabs = [round_tables(r, K) for r in sched.rounds]
    # this rank's weight column (the first agent's of its block: an
    # unmasked round weighs every agent alike); pad slots weigh 0
    cols = [[float(v) for v in w[:, i * B]] for _, w in tabs]
    ring_terms = [[(int(t.shift), float(t.weight)) for t in r.terms]
                  + [(0, 0.0)] * (K - len(r.terms)) for r in sched.rounds]
    # the ring kernel on the table's slots: one f32 agent a rank, an
    # unmasked ±1 ring round (and, per step, no late slot)
    ringed = [wire is None and B == 1 and not is_masked(r)
              and ring_dma.ring_plan(r) is not None
              and K <= ring_dma.MAX_TERMS for r in sched.rounds]
    table = _TableSlot(mesh, names)

    def round_of(step) -> int:
        return int(sched.round_index(int(step)))

    def issue(x, step=0):
        r = round_of(step)
        first = x if wire is None else wire.payload_leaves(x)[0]
        if first.device.type == "cuda":
            why = _table_unfit(mesh, x, names, B, shard_axes, wire)
            if not why and transport == "auto" and use_fused_kernel:
                table.get(_payload_spec(x, wire), first.device).publish(
                    x, _readers(tabs[r][0], i, B))
                coll.mark("peer publish")
                return _Issued(r)
            if mesh.shared:
                raise ValueError(
                    f"ranks share one card here ({first.device}), so there "
                    "is no NCCL: only the fused peer-pointer kernels carry "
                    f"their gossip, and the peer table "
                    f"{why or 'needs use_fused_kernel=True'}")
        comps = (x,) if wire is None else wire.payload_leaves(x)
        nc = len(comps)
        terms = sched.rounds[r].terms
        pending = [[starts[r](c, t, k * nc + ci) for ci, c in enumerate(comps)]
                   for k, t in enumerate(terms)]
        pending += [[coll.Pending(c) for c in comps]
                    for _ in range(K - len(terms))]
        return _Issued(r, pending)

    def complete(payloads: _Issued, step=0, late=None, out=None):
        r = round_of(step)
        if payloads.round != r:
            raise ValueError(f"complete at round {r} of payloads issued at "
                             f"round {payloads.round}")
        late = _late_mask(late, K)
        no_late = late is None or not late.any()
        if payloads.pending is None:        # the peer table
            src, w = _rank_cols(*tabs[r], i, B)
            if not no_late:                 # a late source is never read
                src = src.copy()
                src[late] = np.arange(i * B, (i + 1) * B)
            coll.mark("peer combine")
            return table.table.combine(
                src, w, out=out,
                ring_terms=ring_terms[r] if ringed[r] and no_late else None)
        slots = [[p.wait() for p in comp] for comp in payloads.pending]
        if not no_late:
            # the late slots take the round's self payload BEFORE the
            # combine, under their own weights (the reference's order)
            slots = [slots[selves[r]] if late[k] else sl
                     for k, sl in enumerate(slots)]
        if wire is None:
            return _combine([sl[0] for sl in slots], cols[r],
                            use_fused_kernel, out=out)
        pays = [wire.payload_from_leaves(sl) for sl in slots]
        if use_fused_kernel:
            return kops.gossip_axpy_wire(pays, cols[r], fmt=wire.fmt,
                                         block_rows=wire.block_rows, out=out)
        return _combine([wire.decode(p) for p in pays], cols[r], False)

    def payload_for_write(step, like: torch.Tensor):
        """The peer table slot step ``step``'s payload of the f32 block
        ``like`` should be written (encoded) into, once its last readers
        are done; None off the card's peer table."""
        if like.device.type != "cuda" or transport != "auto" or \
                not use_fused_kernel or _table_unfit(mesh, None, names, B,
                                                     shard_axes, wire):
            return None
        tab = table.get(_like_spec(like, wire), like.device)
        return tab.slot_for_write(_readers(tabs[round_of(step)][0], i, B))

    issue.payload_for_write = payload_for_write
    complete.n_terms = K
    complete.self_index = selves
    complete.transports = lambda: [t for t in (table.table,) if t]
    complete.close = table.close
    return issue, complete


def rank_routes(sched: GossipSchedule, mesh, device, *,
                use_fused_kernel: bool, wire: Optional[WireCodec] = None,
                shard_axes: Optional[str] = None,
                overlap: bool = False) -> List[str]:
    """The gossip each round of ``sched`` takes across ranks on ``device``
    (transport ``"auto"``): ``"ring_peer"`` (the peer ring kernel),
    ``"table_peer"`` (the peer table kernel: f32 or the bf16 wire, any
    agent block), ``"table_peer_q8"`` (the int8 wire's peer q8 kernel) or
    ``"permutes"`` (gloo on the CPU, NCCL across cards; ranks that share
    one card raise there).  Under ``overlap`` a ring round's ring kernel
    runs on the peer table's slots, and a round with a late slot takes
    the table kernel."""
    wire = _no_f32(wire)
    axes = gossip_agent_axes(mesh, sharded=shard_axes is not None)
    table_route = ("table_peer_q8" if wire is not None and wire.fmt == "int8"
                   else "table_peer")
    out = []
    for r in sched.rounds:
        names, _, _, B = _agent_axis_info(r, mesh, axes)
        table_ok = not _table_unfit(mesh, None, names, B, shard_axes, wire)
        if torch.device(device).type != "cuda" or not use_fused_kernel:
            out.append("permutes")
        elif (table_ok and wire is None and B == 1 and not is_masked(r)
              and ring_dma.ring_plan(r) is not None) if overlap \
                else not _peer_unfit(r, mesh, None, names, B, shard_axes,
                                     wire):
            out.append("ring_peer")
        else:
            out.append(table_route if table_ok else "permutes")
    return out


def build_mixer(sched, *, mode: str = "schedule", engine: str = "shifts",
                agents_per_device: int = 1, use_fused_kernel: bool = False,
                wire: Optional[WireCodec] = None,
                transport: str = "auto", mesh=None,
                shard_axes: Optional[str] = None) -> Callable:
    """Single mixer entry point.  ``mode="static"`` takes a
    :class:`Topology` (or a period-1 schedule) and returns ``mix(x)``;
    ``mode="schedule"`` takes a
    :class:`~repro_torch.core.schedule.GossipSchedule` (a bare topology
    is wrapped static) and returns ``mix(x, step=0)``; both take
    ``out=``; ``mode="overlap"`` returns the ``(issue, complete)`` pair of
    :func:`make_overlap_mixer`.  ``mesh`` / ``shard_axes`` run every mode
    across ranks (:func:`mix_ranks`, :func:`_rank_overlap_mixer`)."""
    kw = dict(agents_per_device=agents_per_device,
              use_fused_kernel=use_fused_kernel, wire=wire,
              transport=transport)
    rank_kw = dict(mesh=mesh, shard_axes=shard_axes) if mesh is not None \
        else {}
    if mode == "static":
        topo = sched
        if isinstance(sched, GossipSchedule):
            if sched.period != 1:
                raise ValueError(f"mode='static' needs a topology or a "
                                 f"period-1 schedule, got period "
                                 f"{sched.period}")
            topo = sched.rounds[0]
        return make_mixer(topo, engine, **kw, **rank_kw)
    if not isinstance(sched, GossipSchedule):
        _check_round(sched)
        sched = StaticSchedule(sched)
    if mode == "schedule":
        return make_schedule_mixer(sched, engine, **kw, **rank_kw)
    if mode == "overlap":
        return make_overlap_mixer(sched, engine, **kw, **rank_kw)
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


def encode_rows(wire: WireCodec, seg: torch.Tensor, out=None):
    """A group's stateless wire payload of its rows ``seg`` (an ``(A,
    rows, 128)`` view of the bus): the codec's encode (no residual).  bf16
    is one cast (the payload itself); int8 encodes one agent's block at a
    time into the payload's buffers, so that the codec's temporaries stay
    one block large (the scale tiles lie within a block, so the payload is
    the whole group's encode).  ``out``: the buffers to encode into (the
    peer table's slot across ranks), else new ones."""
    if wire.fmt == "bf16":
        return seg.to(torch.bfloat16) if out is None else out.copy_(seg)
    A, rows, _ = seg.shape
    q, scale = out if out is not None else (
        torch.empty(seg.shape, dtype=torch.int8, device=seg.device),
        torch.empty((A, rows // wire.block_rows), dtype=torch.float32,
                    device=seg.device))
    for a in range(A):
        qa, sa = wire.encode(seg[a])
        q[a].copy_(qa)
        scale[a].copy_(sa)
    return q, scale


def make_group_mixer(plans, *, engine: str = "ppermute",
                     agents_per_device: int = 1,
                     use_fused_kernel: bool = False, mesh=None,
                     shard_axes: Optional[str] = None) -> Callable:
    """Mixer of a policy-group bus (DESIGN §12): ``mix(bus, step=0,
    out=None) -> out``, the twin of the JAX package's
    ``make_group_mixer``.

    ``plans`` (:class:`GroupPlan`) cover the ``(A, rows, 128)`` bus with
    contiguous row ranges.  Per step:

    * an opt-out group (``gossip_every == 0`` or no schedule) builds no
      mixer: its rows are copied from ``bus`` into ``out`` (across ranks it
      makes no collective);
    * a ``gossip_every = k > 1`` group mixes on the steps with
      ``step % k == k − 1``, at round ``step // k`` of its schedule, and
      is copied on the others (shipping nothing);
    * an every-step group mixes at round ``step``.

    A mixing group runs the unmodified engines (:func:`make_schedule_mixer`)
    on its rows — the view ``bus[:, r0:r1]``, or with a bf16 / int8 wire
    that view's stateless payload (:func:`encode_rows`; across ranks on
    the card encoded straight into the group's own peer table slot) — and
    they write
    its mix into ``out[:, r0:r1]`` (the ring, table and combine kernels
    read and write the rows in place; any other result is copied there).
    ``out`` (default: a new bus) may alias no byte of ``bus``; no step
    concatenates a bus.

    ``mesh`` / ``shard_axes`` run each group's schedule mixer across ranks
    (:func:`mix_ranks`) on this rank's block: ``bus`` is the rank's ``(B,
    rows, 128)`` agent block, or with ``shard_axes`` its row shard, whose
    rows of each group (the group's range met with the shard's) mix as the
    whole group's would — the gossip is row by row.  ``mix.transports()``
    lists the peer transports the groups made, ``mix.close()`` frees them
    (collective)."""
    plans = sorted(plans, key=lambda p: p.group.row)
    groups = []         # (row, rows, mixer or None, wire, cadence)
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
            groups.append((g.row, g.rows, None, None, 0))
            continue
        wire = _no_f32(plan.wire)
        inner = make_schedule_mixer(plan.sched, engine,
                                    agents_per_device=agents_per_device,
                                    use_fused_kernel=use_fused_kernel,
                                    wire=wire, mesh=mesh,
                                    shard_axes=shard_axes)
        groups.append((g.row, g.rows, inner, wire, g.gossip_every))
    lo, total = 0, cursor
    if mesh is not None and shard_axes is not None:
        total = cursor // mesh.axis_size(shard_axes)
        lo = mesh.axis_index(shard_axes) * total
    segments = []       # the groups' rows of this block, block-relative
    for row, rows, inner, wire, k in groups:
        r0, r1 = max(row, lo), min(row + rows, lo + total)
        if r1 > r0:
            segments.append((r0 - lo, r1 - r0, inner, wire, k))

    def mix(bus: torch.Tensor, step: int = 0,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if bus.dim() != 3 or bus.shape[1] != total:
            raise ValueError(f"the group mixer takes (A, {total}, 128) "
                             f"buses, got {tuple(bus.shape)}")
        if out is None:
            out = torch.empty_like(bus)
        step = int(step)
        for row, rows, inner, wire, k in segments:
            seg, dst = bus[:, row:row + rows], out[:, row:row + rows]
            if inner is None or (k > 1 and step % k != k - 1):
                dst.copy_(seg)
                continue
            at = step // k if k > 1 else step
            payload = seg if wire is None else encode_rows(
                wire, seg, inner.payload_for_write(at, seg))
            res = inner(payload, step=at, out=dst)
            if res is not dst:
                dst.copy_(res)
        return out

    inners = [g[2] for g in groups if g[2] is not None]
    mix.transports = lambda: [t for m in inners
                              for t in getattr(m, "transports", list)()]
    mix.close = lambda: [m.close() for m in inners if hasattr(m, "close")]
    return mix
