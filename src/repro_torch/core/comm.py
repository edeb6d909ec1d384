"""The rank grid and its collectives: what the multi-rank engines, the
trainer and the checkpoints share (the JAX package's counterpart is a
``jax.sharding.Mesh`` and XLA's collectives).

* :class:`GossipMesh` — a rank grid carrying the agent grid: its shape,
  axis names and, per axis, the process group of this rank's slice along
  it (the ranks that differ from this one in that coordinate only), so
  that a gossip term on one axis of a hierarchical grid stays on that
  axis's ranks.  :func:`repro_torch.launch.mesh.make_gossip_mesh` builds
  one; :func:`gossip_agent_axes`, :func:`axes_group` and
  :func:`rank_block` read it.
* The collectives: :func:`ppermute` — one ``jax.lax.ppermute``: a
  permutation of one axis's ranks, as ``(source, target)`` pairs of axis
  indices, run as one ``torch.distributed.batch_isend_irecv`` round —
  :func:`ppermute_start` starts that round and returns it
  :class:`Pending`, whose :meth:`Pending.wait` gives the received buffer
  (the overlapped pipeline starts a step's permutes before its backward
  pass and waits on them after it; ``ppermute`` is the two back to back);
  :func:`all_gather` — the tiled all-gather along one axis's ranks;
  :func:`all_reduce` — a sum over the grid's (or an axis's) ranks.
* The differentiable forms the expert-parallel MoE layer
  (:func:`repro_torch.models.moe.apply_moe_shard_map`) makes its
  collectives with, each the counterpart of a ``shard_map`` primitive and
  its transpose: :func:`psum` — the sum, whose gradient passes through
  unchanged (the downstream value is the same on every rank of the
  group); :func:`sum_grads` — the identity, whose gradient is summed over
  the group (JAX's ``pbroadcast`` of a replicated operand into a
  rank-varying computation); :func:`gather_rows` — the tiled all-gather,
  whose gradient is this rank's rows (:func:`gather_last`: the same along
  the last dim); :func:`shard_rows` — this rank's contiguous rows, whose
  gradient is all-gathered.  Their collectives carry the tag ``moe``; the
  tensor-parallel forward and its backward
  (:class:`repro_torch.core.sharding.TensorParallel`) sum with
  :func:`psum` and :func:`sum_grads` and gather with :func:`gather_last`
  under the tag ``tp``.

Inside :func:`recording` each collective appends a :class:`Collective` —
its kind (the HLO names: ``collective-permute``, ``all-gather``,
``all-reduce``), shape, dtype, group size and the bytes it moves from
this rank — and a permute notes whether its operand is (a view of) an
all-gather's result (``from_gather``: what the reference's HLO pin rules
out for shard-resident gossip).  A permute a rank makes to itself moves
nothing and is not recorded.  :mod:`repro_torch.launch.collectives`
counts such a record as the reference's ``hlo_analysis`` counts HLO.
The record keeps a clock: each collective notes the tick it was made at
(``started``) and, for a permute, the tick it was waited on at
(``waited``); :func:`mark` puts a named tick into the record
(``Recording.marks``), so a test can place a step's permutes against its
backward pass, as the reference's latency-hiding window does.

On a CUDA tensor a collective runs on the group's own backend (NCCL);
under gloo a CUDA operand is staged through the host (the control plane
of ranks that share one card: metrics, the all-gather of a fallback).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["GossipMesh", "gossip_agent_axes", "axes_group", "rank_block",
           "KINDS", "Collective", "Recording", "recording", "mark",
           "Pending", "ppermute_start", "ppermute", "all_gather",
           "all_reduce", "psum", "sum_grads", "gather_rows", "gather_last",
           "shard_rows"]


@dataclasses.dataclass(frozen=True)
class GossipMesh:
    """A rank grid carrying the agent grid.  ``shape`` / ``axis_names``
    are the grid (``("data",)``, ``("pod", "data")``); ``rank`` is this
    process's flat index in it (row-major), ``coords`` its coordinates
    (None outside the grid: a world larger than the grid leaves its last
    ranks out, as the reference builds over the first devices).
    ``slices[i]`` are the ranks of this rank's slice along axis ``i`` in
    axis order and ``groups[i]`` their process group; ``world_group`` is
    the grid's own; ``control`` the gloo group beside NCCL (the default
    group's backend otherwise).  ``agents_per_device`` is B, ``shards`` S
    (> 1: each agent spans a pod of S row shards).  ``shared``: more of
    this host's ranks run than it has cards; ``hosts[r]`` is the host
    name of grid rank r (empty outside the grid)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_agents: int
    agents_per_device: int
    shards: int
    rank: int
    coords: Optional[Tuple[int, ...]]
    slices: Tuple[Tuple[int, ...], ...]
    groups: tuple
    world_group: object
    control: object
    device: torch.device
    backend: str
    shared: bool
    hosts: Tuple[str, ...] = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis(name)]

    def group(self, name: str):
        return self.groups[self.axis(name)]

    def ranks(self, name: str) -> Tuple[int, ...]:
        return self.slices[self.axis(name)]

    def one_host(self, ranks: Sequence[int]) -> bool:
        """Do the grid ranks ``ranks`` all run on one host?"""
        return len({self.hosts[r] for r in ranks}) <= 1


def gossip_agent_axes(mesh: GossipMesh, sharded: bool = False):
    """The agent axes the gossip engines take on ``mesh``, as the
    reference's: ``sharded=True`` reads a pods × shards grid, where only
    'pod' carries agents ('data' is the row-shard axis: pass it as
    ``shard_axes``); else every 'pod' / 'data' axis, a name when there is
    one."""
    if sharded:
        if not ("pod" in mesh.axis_names and "data" in mesh.axis_names):
            raise ValueError(f"a sharded mesh has 'pod' and 'data' axes, "
                             f"got {mesh.axis_names}")
        return "pod"
    names = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    if not names:
        raise ValueError(f"no agent axis in {mesh.axis_names}")
    return names if len(names) > 1 else names[0]


def axes_group(mesh: GossipMesh, names):
    """``(ranks, group)`` of the flattened agent axes ``names`` (a name or
    a tuple, as :func:`gossip_agent_axes` gives them): one axis's slice
    through this rank, or the whole grid when two axes carry agents."""
    names = names if isinstance(names, tuple) else (names,)
    if len(names) == 1:
        return mesh.ranks(names[0]), mesh.group(names[0])
    return tuple(range(mesh.size)), mesh.world_group


def rank_block(mesh: GossipMesh, n_agents: int,
               shard_axes: Optional[str] = None) -> Tuple[int, int, int, int]:
    """``(first agent, B, shard, S)`` of this rank: it holds agents ``[a0,
    a0 + B)`` and, with ``shard_axes``, row shard ``s`` of ``S`` of them."""
    names = gossip_agent_axes(mesh, sharded=shard_axes is not None)
    names = names if isinstance(names, tuple) else (names,)
    idx, M = 0, 1
    for n in names:
        idx = idx * mesh.axis_size(n) + mesh.axis_index(n)
        M *= mesh.axis_size(n)
    if n_agents % M:
        raise ValueError(f"agent count {n_agents} must be a multiple of the "
                         f"mesh agent extent {M} (axes {names})")
    B = n_agents // M
    if shard_axes is None:
        return idx * B, B, 0, 1
    return idx * B, B, mesh.axis_index(shard_axes), mesh.axis_size(shard_axes)


# ---------------------------------------------------------------------------
# the collectives and their record
# ---------------------------------------------------------------------------

KINDS = ("collective-permute", "all-gather", "all-reduce")


@dataclasses.dataclass
class Collective:
    """One collective a rank made: its HLO kind, operand shape and dtype,
    the size of its group, the bytes it moved from this rank (a permute
    ships its operand; an all-gather ``(g − 1) / g`` of its result; an
    all-reduce ``2 (g − 1) / g`` of its operand: the reference's factors),
    a tag naming its caller's purpose (``gossip``, ``forward``,
    ``metrics``, ``checkpoint``, ``moe``: the expert-parallel layer's sums
    and gathers, ``tp``: the tensor-parallel forward's), for a permute whether the operand came
    out of an all-gather, and the record's ticks when it was made
    (``started``) and waited on (``waited``: the same tick for a
    collective that returns done)."""

    kind: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    group_size: int
    nbytes: int
    tag: str = ""
    from_gather: bool = False
    started: int = -1
    waited: int = -1


class Recording(list):
    """The collectives of a :func:`recording` block, in the order they were
    made, and ``marks``: ``(name, tick)`` pairs put in by :func:`mark`."""

    def __init__(self):
        super().__init__()
        self.marks: List[Tuple[str, int]] = []
        self.clock = 0

    def tick(self) -> int:
        self.clock += 1
        return self.clock


_REC: List[Optional[Recording]] = [None]
# all-gather results while recording (weak: a view keeps its base alive,
# so a live entry is a gathered tensor some tensor may still read)
_GATHERED: List[weakref.ref] = []


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record this rank's collectives while the block runs; yields the
    :class:`Recording` they are appended to."""
    prev, prev_g = _REC[0], list(_GATHERED)
    _REC[0] = Recording()
    _GATHERED.clear()
    try:
        yield _REC[0]
    finally:
        _REC[0] = prev
        _GATHERED[:] = prev_g


def mark(name: str) -> None:
    """Put the tick ``name`` into the record (nothing outside
    :func:`recording`)."""
    if _REC[0] is not None:
        _REC[0].marks.append((name, _REC[0].tick()))


def _record(kind: str, t: torch.Tensor, group_size: int, tag: str,
            from_gather: bool = False, pending: bool = False
            ) -> Optional[Collective]:
    rec = _REC[0]
    if rec is None:
        return None
    b = t.numel() * t.element_size()
    if kind == "all-gather":
        nbytes = b * (group_size - 1) // group_size
    elif kind == "all-reduce":
        nbytes = 2 * b * (group_size - 1) // group_size
    else:
        nbytes = b
    tick = rec.tick()
    c = Collective(kind, tuple(t.shape), t.dtype, group_size, nbytes, tag,
                   from_gather, tick, -1 if pending else tick)
    rec.append(c)
    return c


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _from_gather(t: torch.Tensor) -> bool:
    """Is ``t`` (a view of) an all-gather's result that is still alive?"""
    ptr = _storage(t)
    return any(g() is not None and _storage(g()) == ptr for g in _GATHERED)


def _staged(t: torch.Tensor, group) -> bool:
    """Does this collective go through the host?  A CUDA tensor on a gloo
    group does."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


class Pending:
    """A started permute: :meth:`wait` finishes its send and receive and
    returns the received buffer (``value`` itself when nothing ships)."""

    def __init__(self, value: torch.Tensor, reqs=(),
                 record: Optional[Collective] = None):
        self.value, self._reqs, self._record = value, list(reqs), record

    def wait(self) -> torch.Tensor:
        for req in self._reqs:
            req.wait()
        self._reqs = []
        if self._record is not None and self._record.waited < 0:
            rec = _REC[0]
            self._record.waited = rec.tick() if rec is not None else 0
        return self.value


def ppermute_start(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
                   ranks: Sequence[int], group, tag: str = "gossip",
                   p2p_tag: int = 0) -> Pending:
    """Start ``jax.lax.ppermute`` along one axis: ``pairs`` are ``(source,
    target)`` axis indices of a permutation, ``ranks`` the axis's global
    ranks in axis order and ``group`` their process group.  This rank's
    send of ``x`` to its target and receive from its source are issued;
    the returned :class:`Pending` waits on them and gives what the source
    sent (zeros when this rank is no target, as in JAX).  Permutes in
    flight together between the same two ranks take distinct ``p2p_tag``
    values (the same on both sides), so that each receive matches its
    send."""
    me = ranks.index(dist.get_rank())
    dst = next((d for s, d in pairs if s == me), None)
    src = next((s for s, d in pairs if d == me), None)
    if dst == me and src == me:
        return Pending(x)
    if _staged(x, group):
        raise RuntimeError(
            "a permute of CUDA tensors needs NCCL, and ranks that share one "
            "card run gloo: only the peer-pointer kernels carry their "
            "gossip (repro_torch.kernels.ring_peer, table_peer)")
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops, record = [], None
    if dst is not None:
        record = _record("collective-permute", x, len(ranks), tag,
                         _from_gather(x), pending=True)
        ops.append(dist.P2POp(dist.isend, x, ranks[dst], group=group,
                              tag=p2p_tag))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, ranks[src], group=group,
                              tag=p2p_tag))
    return Pending(out, dist.batch_isend_irecv(ops), record)


def ppermute(x: torch.Tensor, pairs: Sequence[Tuple[int, int]],
             ranks: Sequence[int], group, tag: str = "gossip"
             ) -> torch.Tensor:
    """:func:`ppermute_start` and its wait, back to back: this rank sends
    ``x`` to its target and returns what its source sent (zeros when it is
    no target, as in JAX)."""
    return ppermute_start(x, pairs, ranks, group, tag).wait()


def all_gather(x: torch.Tensor, group, group_size: int,
               tag: str = "gossip", dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim`` over ``group``'s ranks, in rank order
    (a CUDA tensor on a gloo group through the host)."""
    x = x.contiguous()
    src = x.cpu() if _staged(x, group) else x
    parts = [torch.empty_like(src) for _ in range(group_size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim).to(x.device)
    _record("all-gather", out, group_size, tag)
    if _REC[0] is not None:
        _GATHERED.append(weakref.ref(out))
    return out


def all_reduce(t: torch.Tensor, group, group_size: int,
               tag: str = "metrics") -> torch.Tensor:
    """Sum of ``t`` over ``group``'s ranks (a new tensor on ``t``'s
    device; a CUDA tensor on a gloo group through the host)."""
    buf = t.detach().to("cpu" if _staged(t, group) else t.device,
                        copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    _record("all-reduce", buf, group_size, tag)
    return buf.to(t.device)


# ---------------------------------------------------------------------------
# differentiable forms (the expert-parallel MoE layer, the TP loss)
# ---------------------------------------------------------------------------

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, group_size, tag):
        return all_reduce(t, group, group_size, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, group_size, tag):
        ctx.args = (group, group_size, tag)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, group_size, index, tag, dim):
        ctx.n, ctx.index, ctx.dim = t.shape[dim], index, dim
        return all_gather(t, group, group_size, tag, dim=dim)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.index * ctx.n
        return (g.narrow(ctx.dim, r0, ctx.n), None, None, None, None, None)


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, group_size, index, tag):
        ctx.args = (group, group_size, tag)
        rows = t.shape[0] // group_size
        return t[index * rows:(index + 1) * rows]

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None


def psum(t: torch.Tensor, group, group_size: int,
         tag: str = "moe") -> torch.Tensor:
    """``jax.lax.psum`` over ``group``'s ranks: the forward sum of
    :func:`all_reduce`, and a gradient that passes through unchanged —
    the result feeds a value that every rank of the group computes alike,
    so each rank's cotangent is already the whole one."""
    return _Psum.apply(t, group, group_size, tag)


def sum_grads(t: torch.Tensor, group, group_size: int,
              tag: str = "moe") -> torch.Tensor:
    """The identity, whose gradient is summed over ``group``'s ranks: a
    value the group holds alike, entering a computation that differs
    from rank to rank (the transpose of JAX's ``pbroadcast``)."""
    return _SumGrads.apply(t, group, group_size, tag)


def gather_rows(t: torch.Tensor, group, group_size: int, index: int,
                tag: str = "moe") -> torch.Tensor:
    """The tiled all-gather of ``t``'s rows over ``group`` (this rank's
    block at ``index``); the gradient is this rank's rows of the
    cotangent, which every rank of the group holds alike."""
    return _Gather.apply(t, group, group_size, index, tag, 0)


def gather_last(t: torch.Tensor, group, group_size: int, index: int,
                tag: str = "tp") -> torch.Tensor:
    """:func:`gather_rows` along ``t``'s last dim: the tiled all-gather of
    the ranks' column blocks in rank order (this rank's at ``index``),
    whose gradient is this rank's columns of the cotangent — every rank
    of the group holds the whole cotangent of the same loss, so no sum is
    needed (the vocab-parallel logits of the tensor-parallel loss)."""
    return _Gather.apply(t, group, group_size, index, tag, t.dim() - 1)


def shard_rows(t: torch.Tensor, group, group_size: int, index: int,
               tag: str = "moe") -> torch.Tensor:
    """Block ``index`` of ``group_size`` contiguous row blocks of ``t``
    (which every rank of the group holds alike); the gradient is the
    all-gather of the blocks' cotangents."""
    return _ShardRows.apply(t, group, group_size, index, tag)
