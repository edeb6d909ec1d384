"""Partition specs and the tensor-parallel layout across ranks: the
counterpart of the reference's ``jax.sharding.PartitionSpec`` trees
(``lm_param_specs``, ``lm_cache_specs``, ``serve_param_specs``,
``paged_pool_specs``) and of what GSPMD makes of them under
``jax.jit(in_shardings=…)``.

* :class:`PartitionSpec` (``P``) — one entry per tensor dim: ``None``
  (replicated), a mesh axis name, or a tuple of names (the dim split over
  their flattened product, e.g. ``("pod", "data")``), as the reference's.
* :func:`block_bounds` — the one place the layout is computed: along
  each split dim the contiguous block ``[i·n/c, (i+1)·n/c)`` of the
  rank's flat index ``i`` of ``c`` on the named axes (row-major, as a
  ``jax.sharding.Mesh`` lays out its devices); under a spec of ``groups``
  g > 1 that block of each of the dim's g equal parts (a *paired* cut).
  A dim that does not divide raises ``ValueError``.  :func:`cut` takes
  such a block of a tensor or an array, :func:`leaf_block` one leaf's,
  :func:`shard_params` every leaf of a flat ``{path: tensor or array}``
  dict (:func:`repro_torch.weights.tp_block` cuts a numpy tree or an npz
  with it), and ``init_lm_rank`` keeps its bounds of each draw;
  :func:`gather_params` is the inverse (all-gathers over the model
  axis).
* :class:`TensorParallel` — the model axis of a ``("data", "model")``
  rank grid (:func:`repro_torch.launch.mesh.make_moe_mesh`) as the dense
  forward uses it: the sum over the model axis of a row-parallel
  product's partials (``wo``, ``w_down``), the vocab-parallel embedding
  lookup (the rank's rows, zeros for the rest, one sum) and the
  all-gather of the vocab-parallel logits.  Its collectives are
  :func:`repro_torch.core.comm.psum` and
  :func:`~repro_torch.core.comm.all_gather`, tagged ``tp``.

Whole heads: the reference's GSPMD may split ``wq``'s columns anywhere and
reshard; the port splits on head boundaries only, so that a rank holds
query heads ``[r·H/M, (r+1)·H/M)`` and KV heads ``[r·K/M, (r+1)·K/M)``
and GQA's ``h // G`` pairing stays on the rank
(:func:`repro_torch.models.transformer.check_tp_split`).

Paired cuts: a Mamba block's ``in_proj`` is one ``(d, 2·d_inner)`` leaf
whose columns are split in two, x and z.  The reference's ``P(None,
"model")`` hands rank r the r-th contiguous block of all ``2·d_inner``
columns, so that x and z channels do not pair on a rank, and GSPMD
reshards; one process a rank cannot.  Its spec here is the same ``P``
with ``groups=2``: rank r takes the r-th block of x's columns and the
same block of z's, one ``(d, 2·d_inner/M)`` leaf.  ``groups`` takes no
part in equality, so the spec trees compare equal to the reference's
path by path.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["PartitionSpec", "P", "mesh_coords", "block_bounds", "cut",
           "leaf_block", "shard_params", "gather_params", "TensorParallel"]


class PartitionSpec(tuple):
    """A tensor's partition over mesh axes: one entry a dim, ``None`` or an
    axis name or a tuple of axis names; trailing dims it does not name are
    replicated.  ``groups`` g > 1 makes each split dim's cut *paired*: the
    rank's block of each of the dim's g equal parts (see the module's
    note); it is not compared by ``==``."""

    def __new__(cls, *entries, groups: int = 1):
        self = super().__new__(cls, entries)
        self.groups = groups
        return self

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        if self.groups == 1:
            return f"P{tuple.__repr__(self)}"
        return f"P{tuple.__repr__(self)[:-1]}, groups={self.groups})"


P = PartitionSpec


def mesh_coords(mesh) -> Dict[str, Tuple[int, int]]:
    """``{axis name: (this rank's index, axis size)}`` of a rank grid."""
    return {n: (mesh.axis_index(n), mesh.axis_size(n))
            for n in mesh.axis_names}


def _split(entry, coords, path: str) -> Tuple[int, int]:
    """(flat index, count) of a spec entry over ``coords``' axes."""
    names = entry if isinstance(entry, tuple) else (entry,)
    index, count = 0, 1
    for n in names:
        if n not in coords:
            raise ValueError(f"{path}: spec axis {n!r} is not an axis of the "
                             f"grid {tuple(coords)}")
        i, c = coords[n]
        index, count = index * c + i, count * c
    return index, count


def block_bounds(shape, spec, coords, path: str = ""
                 ) -> Tuple[Tuple[int, int, int, int], ...]:
    """``(dim, lo, hi, groups)`` of every dim of a leaf of ``shape`` that
    ``spec`` splits: the rank at ``coords`` (:func:`mesh_coords`, or
    ``{axis: (index, count)}``) holds the contiguous block ``[lo, hi)``
    there, or, at ``groups`` g > 1, ``[lo, hi)`` of each of the dim's g
    equal parts (:func:`cut`).  A dim that does not divide raises
    ``ValueError``."""
    if len(spec) > len(shape):
        raise ValueError(f"{path}: spec {spec} has more entries than the "
                         f"leaf's {len(shape)} dims")
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _split(entry, coords, path)
        if count == 1:
            continue
        groups = spec.groups
        if shape[dim] % (count * groups):
            what = f"{groups} paired parts of " if groups > 1 else ""
            raise ValueError(f"{path}: dim {dim} of {tuple(shape)} does "
                             f"not split over {what}{count} ranks ({entry})")
        n = shape[dim] // (count * groups)
        out.append((dim, index * n, (index + 1) * n, groups))
    return tuple(out)


def cut(leaf, dim: int, lo: int, hi: int, groups: int = 1):
    """``[lo, hi)`` of ``leaf`` (a tensor or a numpy array) along ``dim``
    (a view), or at ``groups`` g > 1 ``[lo, hi)`` of each of the dim's g
    equal parts, concatenated in order (a copy)."""
    n = leaf.shape[dim] // groups
    parts = [leaf[(slice(None),) * dim + (slice(g * n + lo, g * n + hi),)]
             for g in range(groups)]
    if groups == 1:
        return parts[0]
    if isinstance(leaf, torch.Tensor):
        return torch.cat(parts, dim=dim)
    import numpy as np
    return np.concatenate(parts, axis=dim)


def leaf_block(leaf, spec, coords, path: str = ""):
    """The block of ``leaf`` (a tensor or a numpy array) that the rank at
    ``coords`` holds under ``spec`` (:func:`block_bounds`): a view, or a
    copy for a paired cut."""
    for bounds in block_bounds(leaf.shape, spec, coords, path):
        leaf = cut(leaf, *bounds)
    return leaf


def _specs_for(params: Mapping, specs: Mapping) -> None:
    missing = sorted(set(params) - set(specs))
    if missing:
        raise ValueError(f"no partition spec for {missing[:4]}")


def shard_params(params: Mapping, specs: Mapping[str, PartitionSpec], mesh
                 ) -> Dict:
    """This rank's block of every leaf of ``params`` (tensors or numpy
    arrays) under ``specs``; ``mesh`` is the rank grid, or its
    coordinates ``{axis: (index, count)}`` (:func:`mesh_coords`).  A split
    leaf comes back as a copy of its own (so that the whole one can be
    freed), a replicated leaf as it is."""
    _specs_for(params, specs)
    coords = mesh if isinstance(mesh, Mapping) else mesh_coords(mesh)
    out = {}
    for path, leaf in params.items():
        block = leaf_block(leaf, specs[path], coords, path)
        if block.shape == leaf.shape:
            out[path] = leaf
        else:
            out[path] = (block.clone() if isinstance(block, torch.Tensor)
                         else block.copy())
    return out


def gather_params(shards: Mapping[str, torch.Tensor],
                  specs: Mapping[str, PartitionSpec], mesh
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params` on the model axis: every leaf
    whole on every rank, each split dim all-gathered over the model
    group in rank order, a paired cut's blocks put back in their parts
    (collective: every rank of the group calls it)."""
    from repro_torch.core import comm
    _specs_for(shards, specs)
    M = mesh.axis_size("model")
    out = {}
    for path, leaf in shards.items():
        split = [d for d, e in enumerate(specs[path]) if e is not None]
        if any(e not in (None, "model") for e in specs[path]):
            raise NotImplementedError(f"{path}: only the model axis is "
                                      f"gathered, spec {specs[path]}")
        if not split or M == 1:
            out[path] = leaf
            continue
        dim, groups = split[0], specs[path].groups
        whole = comm.all_gather(leaf, mesh.group("model"), M, tag="tp",
                                dim=dim)
        if groups > 1:
            # (M ranks, g parts, n) along dim → (g parts, M ranks, n)
            n = leaf.shape[dim] // groups
            whole = whole.unflatten(dim, (M, groups, n)).transpose(
                dim, dim + 1).flatten(dim, dim + 2)
        out[path] = whole
    return out


class TensorParallel:
    """The model axis of a ``("data", "model")`` rank grid as the dense
    forward uses it (the reference's ``serve_param_specs`` layout under
    ``jax.jit(in_shardings=…)``, here explicit): every method is the
    identity's counterpart on a 1-rank axis and makes no collective there.

    The sums run in the activation dtype (bf16 or f32), as the reference's
    all-reduce of the row-parallel product; each is one all-reduce over
    the model group, which adds every element once and hands the same
    bits to every rank (gloo's ring, or NCCL's), so the ranks stay
    bit-equal among themselves.  The order in which it adds the ranks'
    partials is not the one-process matmul's, so bf16 results can part
    from one process's in their last bits."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.index = mesh.axis_index("model")
        self.size = mesh.axis_size("model")

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis (one all-reduce)."""
        if self.size == 1:
            return t
        from repro_torch.core import comm
        return comm.psum(t, self.mesh.group("model"), self.size, tag="tp")

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of ``t`` along its last dim, in rank order
        (one all-gather)."""
        if self.size == 1:
            return t
        from repro_torch.core import comm
        return comm.all_gather(t, self.mesh.group("model"), self.size,
                               tag="tp", dim=t.dim() - 1)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Vocab-parallel lookup: ``table`` holds rows ``[r·V/M,
        (r+1)·V/M)``; each rank looks up the tokens in its rows, writes
        zeros for the rest, and one sum over the model axis follows
        (exact: it adds zeros)."""
        if self.size == 1:
            return table[tokens]
        rows = table.shape[0]
        local = tokens - self.index * rows
        hit = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(hit[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
        return self.psum(x)
