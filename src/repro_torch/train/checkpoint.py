"""Checkpoints of the port: a train state ↔ ``.npz`` with path keys.

The counterpart of ``repro/train/checkpoint.py``, in the same on-disk
format, so that a file written by either package loads in the other:

* the **logical** tree, never the packed bus: an ``(A, rows, 128)`` bus
  leaf is unpacked to its parameter leaves on save and repacked on load
  (``layout=``), so bus and tree states read each other's files;
* a multi-rank state (:func:`save_state_ranks`; a bus or a tree state)
  is gathered to rank 0 and written as the one-process state would be, so
  a file does not say how many ranks or row shards wrote it;
  :func:`load_state_ranks` gives each rank its block of a file of either
  package;
* keys ``<top>|<path>``: the ``|``-joined path of each leaf as
  ``jax.tree_util.tree_flatten_with_path`` prints it (``params|blocks|0|
  attn|wq``, ``opt|m|...``, ``step``).  The port's parameter dicts are
  keyed by those paths already;
* dtypes as stored: f32 leaves as f32, bf16 leaves as 2-byte ``|V2``
  values of their bits (numpy has no bf16; the JAX package's files hold
  the same bits), the step as an int32 scalar.

:func:`export_consensus` writes the agent mean of a checkpoint's
parameters — the model a serving user loads (``launch/serve.py
--ckpt``) — as a bare-path npz: the mean in float64, rounded once to the
stored dtype as numpy's ``astype`` rounds (bf16 through torch, which
gives ml_dtypes' bits).  :func:`resize_state` and
:func:`load_state_resized` carry a state across agent counts with the
reference's join rule.  The overlap pipeline's state is stored as the
reference stores it: its live payload ``pipeline|phi|<path>`` (the bus
unpacked, the spare slot never written) and ``pipeline|parity``.  A
policy-group layout (DESIGN §12) places leaves by ``slot.row`` like any
other, so files stay leaf-keyed: a state saved under one layout loads bit
for bit under another (grouped or not) and into the tree path.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.bus import LANE, BusLayout
from repro_torch.core.comm import rank_block
from repro_torch.core.mixing import tree_map
from repro_torch.weights import array_to_tensor, rank_slice, tensor_to_array

__all__ = ["save", "load", "save_state", "load_state", "resize_state",
           "load_state_resized", "export_consensus", "load_consensus",
           "save_state_ranks", "load_state_ranks"]

_SEP = "|"


def _join(prefix: str, key) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else str(key)


def _is_bus(leaf: Any, layout: Optional[BusLayout]) -> bool:
    """A leaf is a packed bus iff it is ``(A, rows, 128)`` for ``layout``;
    anything else (the step, tree leaves) passes through."""
    return (layout is not None and isinstance(leaf, torch.Tensor)
            and leaf.dim() == 3
            and tuple(leaf.shape[1:]) == (layout.rows, LANE))


def _bus_leaves(layout: BusLayout, bus: torch.Tensor):
    """``(path, (A, *shape) leaf in its dtype)`` of a bus, one at a time."""
    flat = bus.reshape(bus.shape[0], -1)
    for path, slot in zip(layout.paths, layout.slots):
        start = slot.row * LANE
        leaf = flat[:, start:start + slot.size]
        yield path, leaf.reshape((bus.shape[0],) + slot.shape).to(slot.dtype)


def _flatten(node: Any, prefix: str, layout: Optional[BusLayout],
             out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            _flatten(v, _join(prefix, k), layout, out)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            _flatten(v, _join(prefix, i), layout, out)
    elif _is_bus(node, layout):
        for path, leaf in _bus_leaves(layout, node):
            out[_join(prefix, path)] = tensor_to_array(leaf)
    elif isinstance(node, torch.Tensor):
        out[prefix] = tensor_to_array(node)
    else:                                   # the step counter
        out[prefix] = np.asarray(node, dtype=np.int32)


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def save(path: str, tree: Any, layout: Optional[BusLayout] = None) -> None:
    """Save ``tree`` (nested dicts / lists of tensors and ints) as ``.npz``.
    With ``layout``, its ``(A, rows, 128)`` leaves are packed buses and are
    written as their parameter leaves (``<key>|<path>``, each in its own
    dtype), so the file does not depend on the layout."""
    arrays: Dict[str, np.ndarray] = {}
    _flatten(tree, "", layout, arrays)
    _savez(path, arrays)


def _read(data, key: str, shape, dtype: torch.dtype, device) -> torch.Tensor:
    if key not in data.files:
        raise KeyError(f"checkpoint has no entry {key!r}")
    arr = data[key]
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {arr.shape} in the checkpoint, "
                         f"{tuple(shape)} expected")
    is_bf16 = arr.dtype.kind == "V" and arr.dtype.itemsize == 2
    if (dtype == torch.bfloat16) != is_bf16 or (
            not is_bf16 and torch.empty(0, dtype=dtype).numpy().dtype
            != arr.dtype):
        raise ValueError(f"{key}: dtype {arr.dtype} in the checkpoint, "
                         f"{dtype} expected")
    return array_to_tensor(arr, device)


def _restore(data, node: Any, prefix: str, layout: Optional[BusLayout],
             device) -> Any:
    if isinstance(node, Mapping):
        return {k: _restore(data, v, _join(prefix, k), layout, device)
                for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_restore(data, v, _join(prefix, i), layout, device)
                          for i, v in enumerate(node))
    if _is_bus(node, layout):
        A = node.shape[0]
        dev = device if device is not None else node.device
        bus = torch.zeros(node.shape, dtype=node.dtype, device=dev)
        flat = bus.view(A, -1)
        for path, slot in zip(layout.paths, layout.slots):
            leaf = _read(data, _join(prefix, path), (A,) + slot.shape,
                         slot.dtype, dev)
            start = slot.row * LANE
            flat[:, start:start + slot.size] = leaf.reshape(A, slot.size)
        return bus
    if isinstance(node, torch.Tensor):
        dev = device if device is not None else node.device
        return _read(data, prefix, node.shape, node.dtype, dev)
    return int(data[prefix])


def load(path: str, like: Any, layout: Optional[BusLayout] = None,
         device=None) -> Any:
    """Restore into the structure of ``like`` (shapes and dtypes checked;
    its tensors may lie on ``meta``).  With ``layout``, ``like``'s
    ``(A, rows, 128)`` leaves are packed buses, repacked from the stored
    parameter leaves (pads zero).  Tensors land on ``device``, default each
    template leaf's own; an int leaf (the step) comes back an int."""
    with np.load(path) as data:
        return _restore(data, like, "", layout, device)


# ---------------------------------------------------------------------------
# full train states (params + opt + step)
# ---------------------------------------------------------------------------

def save_state(path: str, state: Mapping[str, Any],
               layout: Optional[BusLayout] = None) -> None:
    """Checkpoint a trainer state ``{params, opt, step}``; bus buffers are
    written as their logical leaves.  The overlap ``pipeline`` is written
    as ``{"phi": live payload, "parity": bit}``: the spare slot is dead by
    construction and never reaches the file."""
    tree = dict(state)
    pipe = tree.pop("pipeline", None)
    if pipe is not None:
        parity = int(pipe["parity"])
        tree["pipeline"] = {"parity": parity, "phi": pipe["slot"][parity]}
    save(path, tree, layout=layout)


def load_state(path: str, like: Mapping[str, Any],
               layout: Optional[BusLayout] = None, device=None
               ) -> Dict[str, Any]:
    """Restore a trainer state into the structure of ``like`` (the freshly
    built state of the resuming run).

    A checkpoint of an f32-wire run has no ``opt|e`` residual: resumed
    under ``wire`` bf16 / int8 the residual starts at zero, the
    error-feedback cold start e(0) = 0 (the reference's rule).  A residual
    in the file that the new state does not ask for is ignored.

    A pipeline checkpoint carries only the live payload: the restored
    ``slot`` holds φ(t) in both slots, so ``slot[parity]`` is right for
    either stored parity and the first resumed step overwrites the spare
    as the uninterrupted run would."""
    like2 = dict(like)
    e_like = None
    opt_like = like2.get("opt")
    if isinstance(opt_like, Mapping) and "e" in opt_like:
        with np.load(path) as data:
            has_e = any(k.split(_SEP)[:2] == ["opt", "e"] for k in data.files)
        if not has_e:
            opt_like = dict(opt_like)
            e_like = opt_like.pop("e")
            like2["opt"] = opt_like
    pipe_like = like2.pop("pipeline", None)
    if pipe_like is not None:
        slot = pipe_like["slot"]
        like2["pipeline"] = {"parity": 0, "phi": torch.empty(
            tuple(slot.shape[1:]), dtype=slot.dtype, device="meta")}
    state = load(path, like2, layout=layout,
                 device=device if device is not None or pipe_like is None
                 else pipe_like["slot"].device)
    if pipe_like is not None:
        pp = state.pop("pipeline")
        phi = pp["phi"]
        slot = torch.empty((2,) + tuple(phi.shape), dtype=phi.dtype,
                           device=phi.device)
        slot[0].copy_(phi)
        slot[1].copy_(phi)
        state["pipeline"] = {"slot": slot, "parity": int(pp["parity"])}
        del phi, pp
    if e_like is not None:
        state["opt"]["e"] = tree_map(lambda l: torch.zeros(
            l.shape, dtype=l.dtype,
            device=device if device is not None else l.device), e_like)
    return state


# ---------------------------------------------------------------------------
# multi-rank states: gathered to rank 0, sliced per rank
# ---------------------------------------------------------------------------

def _gather(local: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """Every grid rank's block of one tensor, on rank 0, joined along axis
    0 in rank order on the host; None on the other ranks.  2-byte leaves
    travel as their int16 bits (bf16 through any backend)."""
    import torch.distributed as dist
    blk = local.detach().cpu().contiguous()
    wire = blk.view(torch.int16) if blk.element_size() == 2 else blk
    parts = ([torch.empty_like(wire) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(wire, parts, dst=0, group=mesh.control)
    if parts is None:
        return None
    return torch.cat(parts, 0).view(blk.dtype)


def _gather_bus(local: torch.Tensor, mesh, n_agents: int):
    """Every grid rank's block of one bus, on rank 0 (in rank order: the
    agents' blocks, each agent's row shards in order), as the ``(A, rows,
    128)`` bus on the host; None on the other ranks."""
    full = _gather(local, mesh)
    return None if full is None else full.view(n_agents, -1, local.shape[-1])


def _gather_state(tree, mesh, n_agents: int, layout: Optional[BusLayout]):
    """A bus, or every leaf of a tree, gathered to rank 0 (None elsewhere;
    a tree's leaves are ``(B, *shape)`` agent blocks in rank order)."""
    if layout is not None:
        return _gather_bus(tree, mesh, n_agents)
    return {p: _gather(v, mesh) for p, v in tree.items()}


def save_state_ranks(path: str, state: Mapping[str, Any],
                     layout: Optional[BusLayout], mesh, n_agents: int
                     ) -> None:
    """Save a multi-rank state (each rank its block, as
    :func:`repro_torch.train.init_state` ``mesh=`` makes it): every bus,
    or with ``layout=None`` every leaf of the tree state's parameters and
    optimizer slots, is gathered to rank 0, which writes the logical npz
    of the one-process state (:func:`save_state`; an overlap pipeline as
    ``pipeline|phi|…``, its live payload gathered, and
    ``pipeline|parity``).  Collective over the mesh's ranks."""
    full = {"params": _gather_state(state["params"], mesh, n_agents, layout),
            "opt": {k: _gather_state(v, mesh, n_agents, layout)
                    for k, v in state["opt"].items()},
            "step": int(state["step"])}
    pipe = state.get("pipeline")
    if pipe is not None:
        parity = int(pipe["parity"])
        full["pipeline"] = {"parity": parity, "phi": _gather_bus(
            pipe["slot"][parity], mesh, n_agents)}
    if mesh.rank == 0:
        # the live payload alone, as save_state writes a pipeline
        save(path, full, layout=layout)


def load_state_ranks(path: str, like: Mapping[str, Any],
                     layout: Optional[BusLayout], mesh, n_agents: int,
                     shard_axes: Optional[str] = None,
                     device=None) -> Dict[str, Any]:
    """This rank's block of a saved state (a file of either package, from
    any number of ranks or row shards: the file is logical), into the
    structure of ``like`` (this rank's state, on ``device`` or like's).
    A pipeline comes back as :func:`load_state` restores one: the live
    payload's block in both slots, the stored parity.  ``layout=None``
    reads a tree state: agents ``[a0, a0 + B)`` of every leaf of the
    parameters and of every optimizer slot."""
    a0, B, shard, S = rank_block(mesh, n_agents, shard_axes)
    if layout is None:
        dev = device if device is not None else _first_leaf(
            like["params"]).device

        def at_a(tree):     # the template at every agent, on no device
            return tree_map(lambda l: torch.empty(
                (n_agents,) + tuple(l.shape[1:]), dtype=l.dtype,
                device="meta"), tree)

        full = load_state(path, {"params": at_a(like["params"]),
                                 "opt": {k: at_a(v)
                                         for k, v in like["opt"].items()},
                                 "step": 0}, device="cpu")

        def block(tree):
            return tree_map(lambda l: l[a0:a0 + B].contiguous().to(dev),
                            tree)

        return {"params": block(full["params"]),
                "opt": {k: block(v) for k, v in full["opt"].items()},
                "step": int(full["step"])}
    dev = device if device is not None else like["params"].device
    meta = lambda t: torch.empty((n_agents, layout.rows, LANE),  # noqa: E731
                                 dtype=t.dtype, device="meta")
    full_like = {"params": meta(like["params"]),
                 "opt": {k: meta(v) for k, v in like["opt"].items()},
                 "step": 0}
    if "pipeline" in like:
        full_like["pipeline"] = {"slot": torch.empty(
            (1, n_agents, layout.rows, LANE), dtype=like["params"].dtype,
            device="meta"), "parity": 0}
    full = load_state(path, full_like, layout=layout, device="cpu")

    def mine(bus):
        return rank_slice(bus, a0, B, shard, S).contiguous().to(dev)

    out = {"params": mine(full["params"]),
           "opt": {k: mine(v) for k, v in full["opt"].items()},
           "step": int(full["step"])}
    if "pipeline" in full:
        phi = mine(full["pipeline"]["slot"][0])
        out["pipeline"] = {"slot": torch.stack([phi, phi]),
                           "parity": full["pipeline"]["parity"]}
    return out


# ---------------------------------------------------------------------------
# train → serve hand-off: the consensus export
# ---------------------------------------------------------------------------

def _agent_mean(leaf: np.ndarray) -> np.ndarray:
    """``leaf.mean(axis=0, dtype=float64).astype(leaf.dtype)`` as numpy
    computes it — the agents summed in order, then divided by their count —
    for f32 and for bf16 (``|V2``) leaves."""
    t = array_to_tensor(leaf, "cpu")
    acc = t[0].to(torch.float64)
    for a in range(1, t.shape[0]):
        acc += t[a].to(torch.float64)
    return tensor_to_array((acc / t.shape[0]).to(t.dtype))


def export_consensus(src_path: str, dst_path: str) -> None:
    """Export the consensus iterate of a training checkpoint: the mean
    over the agent axis of every ``params`` leaf, written as one replica's
    parameter tree under bare paths (no agent axis, no optimizer state) —
    what ``python -m repro_torch.launch.serve --ckpt`` loads.

    Why the mean: the gossip matrix is doubly stochastic, so the agent mean
    is invariant under mixing and is the consensus target EDM drives every
    agent toward.  It is taken in float64 and rounded once to the stored
    dtype, so it does not depend on the summation order of the agents;
    an f32 export equals the reference's byte for byte, and bf16 leaves
    (which the reference's numpy mean cannot take) round as ml_dtypes
    does."""
    prefix = "params" + _SEP
    out: Dict[str, np.ndarray] = {}
    with np.load(src_path) as data:
        for k in data.files:
            if k.startswith(prefix):
                out[k[len(prefix):]] = _agent_mean(data[k])
    if not out:
        raise ValueError(f"{src_path}: no params leaves to export")
    _savez(dst_path, out)


def load_consensus(path: str, like_params: Mapping[str, torch.Tensor],
                   device=None) -> Dict[str, torch.Tensor]:
    """Load a consensus export into the structure of ``like_params`` (one
    replica's ``{path: tensor}``)."""
    return load(path, like_params, device=device)


# ---------------------------------------------------------------------------
# elastic join / leave: the state across agent counts
# ---------------------------------------------------------------------------

def _mean_rows(rows: torch.Tensor) -> torch.Tensor:
    """The mean over axis 0 as ``jnp.mean`` takes it on the reference's
    CPU: summed in order in f32 (bf16 upcast), times the f32 reciprocal of
    the count, cast back."""
    acc = rows[0].to(torch.float32)
    for a in range(1, rows.shape[0]):
        acc = acc + rows[a].to(torch.float32)
    inv = torch.tensor(1.0 / rows.shape[0], dtype=torch.float32)
    return (acc * inv.to(acc.device)).to(rows.dtype)[None]


def resize_state(state: Mapping[str, Any], survivors: Sequence[int],
                 n_agents: int) -> Dict[str, Any]:
    """Carry a trainer state from its saved agent set onto ``n_agents``.

    ``survivors`` selects, in order, the saved agents that carry over;
    their rows are taken as they are, so a shrink (and the identity) is
    exact.  Agents appended past them join with the reference's rule:
    ``params`` the survivors' mean, ``opt["psi"]`` the new agent's own x
    row (so φ collapses to ψ′ at its first step, as at step 0), every
    other optimizer slot zero; the overlap pipeline's slots the new x row
    in both buffers.  Bus buffers and tree leaves resize alike, along axis
    0 (axis 1 of the pipeline's ``slot``)."""
    surv = list(survivors)
    m = len(surv)
    if not 0 < m <= n_agents:
        raise ValueError(f"{m} survivors for {n_agents} agents")
    pad = n_agents - m

    def keep(leaf):
        return leaf[torch.as_tensor(surv, device=leaf.device)]

    def grow(kept, fill):
        if pad == 0:
            return kept
        return torch.cat([kept, fill.expand((pad,) + tuple(kept.shape[1:]))])

    params = tree_map(lambda l: grow(keep(l), _mean_rows(keep(l))),
                      state["params"])
    def join_psi(l, x):    # a joining agent's ψ is its own new x row
        return torch.cat([keep(l), x[m:]]) if pad else keep(l)

    opt = {}
    for slot, sub in state.get("opt", {}).items():
        if slot == "psi":
            opt[slot] = ({p: join_psi(l, params[p]) for p, l in sub.items()}
                         if isinstance(sub, Mapping)
                         else join_psi(sub, params))
        else:
            opt[slot] = tree_map(
                lambda l: grow(keep(l), torch.zeros_like(l[:1])), sub)
    out = dict(state)
    out["params"], out["opt"] = params, opt
    pipe = state.get("pipeline")
    if pipe is not None:
        # both slots of a joining agent hold its new x row: φ(0) = x(0), the
        # seeding init_state uses
        slot = pipe["slot"]
        kept = slot[:, torch.as_tensor(surv, device=slot.device)]
        if pad:
            kept = torch.cat([kept, params[m:].unsqueeze(0).expand(
                (slot.shape[0],) + tuple(params[m:].shape))], dim=1)
        out["pipeline"] = {"slot": kept, "parity": pipe["parity"]}
    return out


def _first_leaf(tree: Any) -> torch.Tensor:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def load_state_resized(path: str, like: Mapping[str, Any],
                       layout: Optional[BusLayout] = None,
                       survivors: Optional[Sequence[int]] = None,
                       device=None) -> Dict[str, Any]:
    """Restore a checkpoint saved at A agents into a run built at A′: the
    saved agent count is read off the file, the state loaded at A (one
    ``layout`` serves every agent count) and resized by
    :func:`resize_state`; ``survivors`` defaults to the first min(A, A′).
    A′ == A with no ``survivors`` is :func:`load_state`, bit for bit."""
    with np.load(path) as data:
        pkeys = [k for k in data.files if k.split(_SEP)[0] == "params"]
        if not pkeys:
            raise ValueError(f"{path}: no params leaves in the checkpoint")
        a_old = int(data[pkeys[0]].shape[0])
    a_new = int(_first_leaf(like["params"]).shape[0])
    if a_old == a_new and survivors is None:
        return load_state(path, like, layout=layout, device=device)
    if device is None:
        device = _first_leaf(like["params"]).device

    def at_old(tree):      # the template at the saved agent count
        return tree_map(lambda l: torch.empty(
            (a_old,) + tuple(l.shape[1:]), dtype=l.dtype, device="meta"),
            tree)

    like_old = dict(like)
    like_old["params"] = at_old(like["params"])
    like_old["opt"] = {k: at_old(v) for k, v in like["opt"].items()}
    if "pipeline" in like:
        slot = like["pipeline"]["slot"]
        like_old["pipeline"] = {"slot": torch.empty(
            (slot.shape[0], a_old) + tuple(slot.shape[2:]), dtype=slot.dtype,
            device="meta"), "parity": 0}
    old = load_state(path, like_old, layout=layout, device=device)
    surv = (list(survivors) if survivors is not None
            else list(range(min(a_old, a_new))))
    return resize_state(old, surv, a_new)

