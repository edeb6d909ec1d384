"""ParamBus: the packed ``(A, rows, 128)`` buffer of the per-agent parameters.

The counterpart of ``repro/core/bus.py`` (ungrouped layouts), with the
overlap pipeline's double-buffered slots (:func:`make_pipeline`).  Parameters,
gradients and the EDM state ``m``/``ψ`` of all A agents each live in ONE
buffer under a static layout, so the optimizer step is one fused kernel
launch over the whole bus and the gossip is one combine.

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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.kernels.edm_update import BLOCK_ROWS, LANE

__all__ = ["LANE", "BLOCK_ROWS", "LeafSlot", "BusLayout", "padded_rows",
           "leaf_paths", "make_layout", "pack_tree", "unpack_tree",
           "pack_agent", "unpack_agent", "leaf_views", "make_pipeline",
           "pipeline_payload", "pipeline_spare", "pipeline_advance"]

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
class BusLayout:
    """Static bus layout: ``slots[i]`` places the leaf at ``paths[i]``."""

    paths: Tuple[str, ...]
    slots: Tuple[LeafSlot, ...]
    rows: int                  # incl. tail pad; rows % block_rows == 0
    block_rows: int
    dtype: torch.dtype = torch.float32

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


def make_layout(tree: Mapping[str, torch.Tensor], *,
                block_rows: Optional[int] = None) -> BusLayout:
    """Layout for ``tree``, whose leaves are shaped ``(A, *leaf_shape)``
    (anything with ``.shape`` and ``.dtype``: ``meta`` tensors build a
    layout without allocating).  The agent axis is stripped."""
    block_rows = block_rows or BLOCK_ROWS
    if block_rows <= 0 or block_rows % _SUBLANE:
        raise ValueError(f"block_rows must be a positive multiple of "
                         f"{_SUBLANE}, got {block_rows}")
    paths = leaf_paths(tree)
    if not paths:
        raise ValueError("cannot build a bus layout for an empty tree")
    slots = []
    row = 0
    for path in paths:
        leaf = tree[path]
        if leaf.dim() < 1 or not leaf.dtype.is_floating_point:
            raise ValueError(f"{path}: bus leaves are floating and carry a "
                             f"leading agent axis, got {leaf.dtype} "
                             f"{tuple(leaf.shape)}")
        shape = tuple(leaf.shape[1:])
        size = 1
        for s in shape:
            size *= s
        rows = padded_rows(size)
        slots.append(LeafSlot(row, rows, shape, leaf.dtype, size))
        row += rows
    total = -(-row // block_rows) * block_rows
    return BusLayout(tuple(paths), tuple(slots), total, block_rows)


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
