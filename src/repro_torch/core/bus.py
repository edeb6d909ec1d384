"""ParamBus: the packed ``(A, rows, 128)`` buffer of the per-agent parameters.

The counterpart of ``repro/core/bus.py``: layouts with policy groups, and
the overlap pipeline's double-buffered slots (:func:`make_pipeline`).
Parameters, gradients and the EDM state ``m``/``ψ`` of all A agents each
live in ONE buffer under a static layout, so the optimizer step is one
fused kernel launch over the whole bus and the gossip is one combine.

Layout contract (identical to the JAX package's, so buses are byte-equal):

* leaves are ordered as ``jax.tree_util.tree_flatten`` orders the JAX
  parameter tree — dict keys sorted, tuple entries by index
  (:func:`leaf_paths`); the port's parameters are a flat dict keyed by the
  ``|``-joined paths (``blocks|0|attn|wq``);
* every leaf starts on an 8-row boundary of 128 lanes;
* the total row count is rounded up to a multiple of ``block_rows``
  (:data:`BLOCK_ROWS`, 512 or ``REPRO_BLOCK_ROWS``) — one tail pad;
* pad elements are zero and stay zero under the EDM update and any doubly
  stochastic mix (both map 0 → 0);
* the bus dtype is f32; leaves are cast on pack and restored to their own
  dtype on unpack (bf16 leaves round-trip exactly).

Policy groups (DESIGN §12): the bus is a few named **groups**, each a
contiguous row range rounded up to ``block_rows`` on its own, with its own
gossip policy (:class:`GroupSpec`: cadence ``gossip_every``, 0 opting the
group out of gossip; wire format; schedule).  A leaf joins the first spec
whose pattern matches its ``|``-joined path; leaves no spec matches fall
into a trailing ``"dense"`` group.  Slots are then in group order, not path
order: every function here places a leaf by its ``slot.row``.  The default
(no specs) is one ``"dense"`` group over the whole bus, whose slots and
rows are those of the ungrouped layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import torch

from repro_torch.kernels.edm_update import BLOCK_ROWS, LANE

__all__ = ["LANE", "BLOCK_ROWS", "LeafSlot", "GroupSpec", "BusGroup",
           "BusLayout", "padded_rows", "group_specs_from_json",
           "leaf_paths", "make_layout", "layout_of", "pack_tree",
           "unpack_tree", "pack_agent", "unpack_agent", "leaf_views",
           "make_pipeline", "pipeline_payload", "pipeline_spare",
           "pipeline_advance"]

_SUBLANE = 8


def padded_rows(n_elems: int, align: int = _SUBLANE) -> int:
    """Rows of 128 lanes holding ``n_elems``, rounded up to ``align`` rows."""
    rows = -(-n_elems // LANE)
    return -(-rows // align) * align


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Placement of one leaf: rows ``[row, row + rows)`` of the bus, i.e.
    elements ``[row·128, row·128 + size)`` of an agent's flat view.
    ``shape``/``dtype`` are the per-agent leaf's (agent axis stripped)."""

    row: int
    rows: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """The gossip policy of one set of leaves (DESIGN §12).

    ``match``: substring patterns tested against each leaf's ``|``-joined
    path (``("|ffn|",)`` matches every block's MLP); an empty tuple is a
    catch-all; a callable ``path -> bool`` is accepted too.
    ``gossip_every``: 1 gossips every step, k > 1 on the steps with
    ``step % k == k − 1`` (on the group's own round clock ``step // k``),
    0 never (the rows stay local and ship nothing).  ``wire``: the group's
    payload format, ``"f32"``, ``"bf16"`` or ``"int8"`` (stateless: no
    error-feedback residual).  ``schedule``: a gossip-schedule name that
    overrides the run's (``""`` inherits it)."""

    name: str
    match: Union[Tuple[str, ...], Callable[[str], bool]] = ()
    gossip_every: int = 1
    wire: str = "f32"
    schedule: str = ""

    def __post_init__(self):
        if self.gossip_every < 0:
            raise ValueError(f"group {self.name!r}: gossip_every must be "
                             f">= 0, got {self.gossip_every}")
        if self.wire not in ("f32", "bf16", "int8"):
            raise ValueError(f"group {self.name!r}: wire must be f32, bf16 "
                             f"or int8, got {self.wire!r}")
        if not callable(self.match):
            object.__setattr__(self, "match", tuple(self.match))

    def matches(self, path: str) -> bool:
        if callable(self.match):
            return bool(self.match(path))
        return any(p in path for p in self.match) if self.match else True

    @property
    def catch_all(self) -> bool:
        return not callable(self.match) and not self.match


@dataclasses.dataclass(frozen=True)
class BusGroup:
    """A resolved policy group: rows ``[row, row + rows)`` of the bus
    holding the slots ``slots`` (indices into ``layout.slots``), under one
    policy.  ``rows`` is a multiple of ``block_rows`` (0 when no leaf
    matched), so every group is a whole number of kernel tiles."""

    name: str
    row: int
    rows: int
    slots: Tuple[int, ...]
    gossip_every: int = 1
    wire: str = "f32"
    schedule: str = ""

    @property
    def elems(self) -> int:
        """Padded elements the group ships per agent per permute."""
        return self.rows * LANE


def group_specs_from_json(obj: Any) -> Tuple[GroupSpec, ...]:
    """Group specs from a parsed ``--gossip-groups`` JSON list:
    ``[{"name": ..., "match": [...], "gossip_every": ..., "wire": ...,
    "schedule": ...}, ...]``; ``match`` may be one pattern or a list."""
    if not isinstance(obj, (list, tuple)):
        raise ValueError(f"gossip groups must be a JSON list of specs, got "
                         f"{type(obj).__name__}")
    specs = []
    for d in obj:
        if not isinstance(d, dict) or "name" not in d:
            raise ValueError(f"a group spec is an object with a 'name', got "
                             f"{d!r}")
        match = d.get("match", ())
        if isinstance(match, str):
            match = (match,)
        specs.append(GroupSpec(
            name=str(d["name"]), match=tuple(match),
            gossip_every=int(d.get("gossip_every", 1)),
            wire=str(d.get("wire", "f32")),
            schedule=str(d.get("schedule", ""))))
    return tuple(specs)


@dataclasses.dataclass(frozen=True)
class BusLayout:
    """Static bus layout: ``slots[i]`` places the leaf at ``paths[i]``;
    ``groups`` are the policy groups, contiguous in row order."""

    paths: Tuple[str, ...]
    slots: Tuple[LeafSlot, ...]
    rows: int                  # incl. tail pad; % (block_rows · shards) == 0
    block_rows: int
    dtype: torch.dtype = torch.float32
    groups: Tuple[BusGroup, ...] = ()
    shards: int = 1            # row shards of the shard-resident mode

    @property
    def shard_rows(self) -> int:
        """Rows each row shard owns (``rows / shards``): a whole number of
        ``block_rows`` tiles by construction (DESIGN §7)."""
        return self.rows // self.shards

    @property
    def is_grouped(self) -> bool:
        """True when the layout carries a policy other than the default:
        more than one populated group, or one group whose cadence, wire or
        schedule is not the default.  Other layouts take the ungrouped
        mixing path."""
        live = [g for g in self.groups if g.rows]
        if len(live) > 1:
            return True
        return any(g.gossip_every != 1 or g.wire != "f32" or g.schedule
                   for g in live)

    @property
    def logical_elems(self) -> int:
        """Elements that carry data (excludes alignment and tail pad)."""
        return sum(s.size for s in self.slots)

    @property
    def padded_elems(self) -> int:
        """Bus elements per agent (rows × 128)."""
        return self.rows * LANE


def _path_key(path: str):
    # numeric components are tuple indices (ordered by value), the others
    # dict keys (ordered as strings) — jax.tree_util's flatten order
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c)
                 for c in path.split("|"))


def leaf_paths(tree: Mapping[str, object]) -> List[str]:
    """The ``|``-joined paths of ``tree`` in JAX flatten order."""
    return sorted(tree, key=_path_key)


_LAYOUT_CACHE: Dict[tuple, BusLayout] = {}


def make_layout(tree: Mapping[str, torch.Tensor], *,
                block_rows: Optional[int] = None,
                groups: Optional[Tuple[GroupSpec, ...]] = None,
                shards: int = 1) -> BusLayout:
    """Layout for ``tree`` (built once, then taken from a cache keyed on
    the leaves' shapes and dtypes, ``block_rows`` and the specs), whose
    leaves are shaped ``(A, *leaf_shape)`` (anything with ``.shape`` and
    ``.dtype``: ``meta`` tensors build a layout without allocating).  The
    agent axis is stripped, so trees that differ only in A share a layout.

    ``groups``: policy-group specs.  Each leaf joins the first spec that
    matches its path; without a catch-all spec a trailing ``"dense"``
    group takes the rest.  Groups occupy contiguous row ranges in spec
    order, each rounded up to ``block_rows`` on its own.  ``None`` (or one
    catch-all spec) gives the ungrouped layout: one group, and the slots
    and rows of the path-order packing.

    ``shards`` (the shard-resident mode, DESIGN §7) rounds each group up to
    ``block_rows · shards`` rows instead, as the reference does, so that
    the row axis splits into ``shards`` blocks that are whole kernel tiles
    (``shard_rows``); ``shards=1`` is the layout above, byte for byte."""
    block_rows = block_rows or BLOCK_ROWS
    if block_rows <= 0 or block_rows % _SUBLANE:
        raise ValueError(f"block_rows must be a positive multiple of "
                         f"{_SUBLANE}, got {block_rows}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    paths = leaf_paths(tree)
    if not paths:
        raise ValueError("cannot build a bus layout for an empty tree")
    specs = tuple(groups) if groups else (GroupSpec("dense"),)
    if not any(s.catch_all for s in specs):
        specs = specs + (GroupSpec("dense"),)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate group names: {names}")
    key = (tuple((p, tuple(tree[p].shape[1:]), tree[p].dtype)
                 for p in paths), block_rows, specs, shards)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    quantum = block_rows * shards
    members: List[List[int]] = [[] for _ in specs]
    for i, path in enumerate(paths):
        gi = next((gi for gi, spec in enumerate(specs)
                   if spec.matches(path)), None)
        members[gi].append(i)
    slots: List[Optional[LeafSlot]] = [None] * len(paths)
    resolved = []
    base = 0
    for spec, idxs in zip(specs, members):
        row = base
        for i in idxs:
            leaf = tree[paths[i]]
            if leaf.dim() < 1 or not leaf.dtype.is_floating_point:
                raise ValueError(f"{paths[i]}: bus leaves are floating and "
                                 f"carry a leading agent axis, got "
                                 f"{leaf.dtype} {tuple(leaf.shape)}")
            shape = tuple(leaf.shape[1:])
            size = 1
            for s in shape:
                size *= s
            rows = padded_rows(size)
            slots[i] = LeafSlot(row, rows, shape, leaf.dtype, size)
            row += rows
        grows = -(-(row - base) // quantum) * quantum
        resolved.append(BusGroup(spec.name, base, grows, tuple(idxs),
                                 spec.gossip_every, spec.wire, spec.schedule))
        base += grows
    layout = BusLayout(tuple(paths), tuple(slots), base, block_rows,
                       groups=tuple(resolved), shards=shards)
    _LAYOUT_CACHE[key] = layout
    return layout


def layout_of(model, n_agents: int,
              groups: Optional[Tuple[GroupSpec, ...]] = None,
              shards: int = 1, *,
              block_rows: Optional[int] = None) -> BusLayout:
    """Layout for a :class:`~repro_torch.models.api.Model`'s parameter
    tree with a leading agent axis of ``n_agents`` — shape-only (the
    model's ``meta`` tensors), no allocation.  ``groups`` are the
    policy-group specs (usually ``resolve_features(run).groups``; empty:
    the ungrouped layout), ``shards`` the row shards of the shard-resident
    mode (``agents="pod"``, DESIGN §7); the trainer's ``bus_layout_for``
    is this function."""
    lifted = {p: torch.empty((n_agents,) + tuple(t.shape), dtype=t.dtype,
                             device="meta")
              for p, t in model.meta().items()}
    return make_layout(lifted, block_rows=block_rows,
                       groups=tuple(groups) if groups else None,
                       shards=shards)


def _copy_in(layout: BusLayout, flat: torch.Tensor, tree, lead: tuple):
    for path, slot in zip(layout.paths, layout.slots):
        leaf = tree[path]
        if tuple(leaf.shape) != lead + slot.shape:
            raise ValueError(f"{path}: shape {tuple(leaf.shape)}, layout "
                             f"expects {lead + slot.shape}")
        start = slot.row * LANE
        flat[..., start:start + slot.size] = leaf.reshape(lead + (slot.size,))


def pack_tree(layout: BusLayout, tree: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """Pack ``tree`` (leaves ``(A, *shape)``) into a new ``(A, rows, 128)``
    bus of the layout's dtype, on the leaves' device; pads are zero."""
    first = tree[layout.paths[0]]
    A = first.shape[0]
    flat = torch.zeros(A, layout.padded_elems, dtype=layout.dtype,
                       device=first.device)
    _copy_in(layout, flat, tree, (A,))
    return flat.view(A, layout.rows, LANE)


def pack_agent(layout: BusLayout, bus: torch.Tensor, agent: int,
               tree: Mapping[str, torch.Tensor]) -> None:
    """Write one agent's leaves (no agent axis) into row block ``agent`` of
    ``bus`` in place.  Pad elements are left as they are."""
    _copy_in(layout, bus[agent].view(layout.padded_elems), tree, ())


def _views(layout: BusLayout, flat: torch.Tensor, lead: tuple
           ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, slot in zip(layout.paths, layout.slots):
        start = slot.row * LANE
        seg = flat[..., start:start + slot.size].reshape(lead + slot.shape)
        out[path] = seg.to(slot.dtype)
    return out


def unpack_tree(layout: BusLayout, bus: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_tree`: ``{path: (A, *shape)}`` in each leaf's
    dtype.  Leaves whose dtype is the bus's are views of the bus."""
    A, rows, lane = bus.shape
    if rows != layout.rows or lane != LANE:
        raise ValueError(f"bus {tuple(bus.shape)} does not match layout rows "
                         f"{layout.rows}")
    return _views(layout, bus.view(A, rows * LANE), (A,))


def unpack_agent(layout: BusLayout, bus: torch.Tensor, agent: int
                 ) -> Dict[str, torch.Tensor]:
    """One agent's leaves (no agent axis) from row block ``agent``."""
    return _views(layout, bus[agent].view(layout.padded_elems), ())


def leaf_views(layout: BusLayout, bus: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """``{path: (A, *shape)}`` views of the bus in the bus dtype (no cast
    back to the leaf's dtype): per-leaf diagnostics without an unpack."""
    A, rows, lane = bus.shape
    if rows != layout.rows or lane != LANE:
        raise ValueError(f"bus {tuple(bus.shape)} does not match layout rows "
                         f"{layout.rows}")
    flat = bus.view(A, rows * LANE)
    return {path: flat[:, s.row * LANE:s.row * LANE + s.size].view(
        (A,) + s.shape) for path, s in zip(layout.paths, layout.slots)}


# ---------------------------------------------------------------------------
# double-buffered pipeline slots (DESIGN §6)
# ---------------------------------------------------------------------------
#
# The overlapped gossip pipeline carries its in-flight payload in the train
# state: ``slot`` is a (2, A, rows, 128) stack of two buses and ``parity``
# (a Python int) picks the LIVE one.  Step t gossips slot[parity], writes
# the new payload φ' into slot[1 − parity] and flips the parity, so the
# buffer the combine reads is never the one the EDM update writes.

def make_pipeline(bus: torch.Tensor) -> dict:
    """Initial pipeline state: ``bus`` (φ(0) = x(0)) in the live slot,
    zeros in the spare, parity 0."""
    if bus.dim() != 3 or bus.shape[-1] != LANE:
        raise ValueError(f"the pipeline holds (A, rows, {LANE}) buses, got "
                         f"{tuple(bus.shape)}")
    slot = torch.zeros((2,) + tuple(bus.shape), dtype=bus.dtype,
                       device=bus.device)
    slot[0].copy_(bus)
    return {"slot": slot, "parity": 0}


def pipeline_payload(pipe: dict) -> torch.Tensor:
    """The live in-flight payload ``slot[parity]`` (a view)."""
    return pipe["slot"][int(pipe["parity"])]


def pipeline_spare(pipe: dict) -> torch.Tensor:
    """The spare slot ``slot[1 − parity]`` (a view): where the step's new
    payload goes."""
    return pipe["slot"][1 - int(pipe["parity"])]


def pipeline_advance(pipe: dict, phi_new: torch.Tensor) -> dict:
    """Write the next payload into the spare slot (nothing to copy when it
    is that slot already) and flip the parity."""
    spare = pipeline_spare(pipe)
    if phi_new.data_ptr() != spare.data_ptr():
        spare.copy_(phi_new)
    return {"slot": pipe["slot"], "parity": 1 - int(pipe["parity"])}
