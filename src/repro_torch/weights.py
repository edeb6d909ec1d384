"""Carry the JAX package's parameters into the port.

Two sources, one result — the port's parameter dict ``{path: tensor}``
under the JAX tree's ``|``-joined paths and with its dtypes:

* :func:`params_from_tree` — a nested tree of numpy arrays (dicts, tuples
  and lists, e.g. ``jax.tree.map(np.asarray, params)`` built by the
  caller);
* :func:`params_from_npz` — an ``.npz`` written by the JAX package's
  ``repro.train.checkpoint.save`` (keys ``params|<path>`` for a saved
  state, bare ``<path>`` for a saved parameter tree), read with
  ``np.load`` only.

:func:`train_state_from_arrays` carries a whole train state of numpy
arrays (e.g. ``jax.tree.map(np.asarray, state)``) into the port's: the
packed-bus state ``{params, opt: {m, psi[, e]}, step}`` or the tree state
``{params: tree, opt: {m, psi, e, y, g_prev}: trees, step}``, each
parameter tree flattened to ``{path: tensor}``.

bf16 leaves arrive as 2-byte numpy values (ml_dtypes ``bfloat16`` in
memory, ``|V2`` from an npz); their bits are reinterpreted as
``torch.bfloat16``, so the values carry over exactly
(:func:`array_to_tensor`); :func:`tensor_to_array` is the way back, bf16
as ``|V2`` bits, which is what the JAX package's npz files hold.
:func:`params_to_bus` packs the dict straight into an A-agent bus.
:func:`expert_block` cuts the MoE expert leaves of a parameter dict or
numpy tree to one model rank's block of experts (the expert-parallel
layer, :func:`repro_torch.models.moe.apply_moe_shard_map`);
:func:`tp_block` cuts every leaf to a tensor-parallel rank's block under
partition specs (:func:`repro_torch.core.sharding.shard_params`' numpy
form), and ``params_from_npz(..., block=(specs, index, count))`` so cuts
each entry of a file on the host before it reaches the device.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core import bus as parambus

__all__ = ["array_to_tensor", "tensor_to_array", "params_from_tree",
           "params_from_npz", "params_digest", "npz_params_digest",
           "params_to_bus",
           "train_state_from_arrays", "rank_slice",
           "rank_state_from_arrays", "expert_block", "tp_block"]

_SEP = "|"


def array_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor of its own on ``device``; a 2-byte void or
    ml_dtypes bf16 array becomes ``torch.bfloat16`` with the same bits."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host; ``torch.bfloat16`` becomes
    ``|V2`` values of the same bits (numpy has no bf16 of its own)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _walk(node: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(node, Mapping):
        items = ((str(k), v) for k, v in node.items())
    elif isinstance(node, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(node))
    else:
        out[prefix] = node
        return
    for key, child in items:
        _walk(child, f"{prefix}{_SEP}{key}" if prefix else key, out)


def params_from_tree(tree: Any, device="cpu") -> Dict[str, torch.Tensor]:
    """Nested dict/tuple/list tree of numpy arrays → ``{path: tensor}``."""
    flat: Dict[str, np.ndarray] = {}
    _walk(tree, "", flat)
    return {p: array_to_tensor(a, device) for p, a in flat.items()}


class _NpzParams(Mapping):
    """The parameters of an open npz by path, each entry read when it is
    indexed."""

    def __init__(self, data):
        keys = list(data.keys())
        prefix = "params" + _SEP
        if any(k.startswith(prefix) for k in keys):
            self.names = {k[len(prefix):]: k for k in keys
                          if k.startswith(prefix)}
        else:
            self.names = {k: k for k in keys}
        self.data = data

    def __getitem__(self, name):
        return self.data[self.names[name]]

    def __iter__(self):
        return iter(self.names)

    def __len__(self):
        return len(self.names)


def npz_params_digest(path: str) -> str:
    """:func:`params_digest` of an npz's parameters
    (:func:`params_from_npz`'s), read one entry at a time."""
    with np.load(path) as data:
        return params_digest(_NpzParams(data))


def params_from_npz(path: str, device="cpu", block=None
                    ) -> Dict[str, torch.Tensor]:
    """Parameters from an npz of ``repro.train.checkpoint.save``: the
    ``params|`` entries of a saved state, else every entry.  ``block =
    (specs, index, count)`` keeps model rank ``index`` of ``count``'s
    block of each entry (:func:`tp_block`), cut on the host one entry at
    a time, so a rank never holds the whole file."""
    with np.load(path) as data:
        entries = _NpzParams(data)
        out = {}
        for name in entries:
            arr = entries[name]
            if block is not None:
                arr = tp_block({name: arr}, *block)[name]
            out[name] = array_to_tensor(arr, device)
        return out


def params_digest(params: Mapping[str, Any]) -> str:
    """SHA-256 of a parameter dict: each path (sorted), dtype, shape and
    the leaf's bytes.  Equal digests mean equal bits, wherever the tensors
    lie (they are read on the host; numpy leaves as an npz holds them, bf16
    as ``|V2``).  Leaves are read one at a time."""
    h = hashlib.sha256()
    for path in sorted(params):
        leaf = params[path]
        arr = (tensor_to_array(leaf) if isinstance(leaf, torch.Tensor)
               else np.asarray(leaf))
        h.update(f"{path}|{arr.dtype.str}|{arr.shape}\n".encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def params_to_bus(layout: parambus.BusLayout,
                  params: Mapping[str, torch.Tensor],
                  n_agents: int) -> torch.Tensor:
    """One agent's parameters, replicated to ``n_agents`` and packed into a
    new ``(A, rows, 128)`` bus on the parameters' device."""
    dev = params[layout.paths[0]].device
    bus = torch.zeros(n_agents, layout.rows, parambus.LANE,
                      dtype=layout.dtype, device=dev)
    for a in range(n_agents):
        parambus.pack_agent(layout, bus, a, params)
    return bus


def train_state_from_arrays(state: Mapping[str, Any],
                            device="cpu") -> Dict[str, Any]:
    """A train state of numpy arrays, as the JAX package's ``init_state``
    / train step hold it, as the port's train state on ``device`` (each
    array its own buffer, bf16 bits exact) with an int step.  A bus state
    keeps its ``(A, rows, 128)`` buffers; in a tree state the parameters
    and every optimizer slot (``m``, ``psi``, ``e``, ``y``, ``g_prev``)
    become ``{path: tensor}`` dicts.  An overlap pipeline ``{"slot",
    "parity"}`` comes over as its slot tensor and an int parity."""
    if isinstance(state["params"], Mapping):
        carry = params_from_tree
    else:
        carry = array_to_tensor
    out = {"params": carry(state["params"], device),
           "opt": {k: carry(v, device) for k, v in state["opt"].items()},
           "step": int(np.asarray(state["step"]))}
    if "pipeline" in state:
        pipe = state["pipeline"]
        out["pipeline"] = {"slot": array_to_tensor(pipe["slot"], device),
                           "parity": int(np.asarray(pipe["parity"]))}
    return out


def rank_slice(arr, a0: int, B: int, shard: int = 0, shards: int = 1):
    """A rank's block of an ``(A, rows, 128)`` bus (numpy array or tensor):
    agents ``[a0, a0 + B)`` and row shard ``shard`` of ``shards``."""
    rows = arr.shape[1] // shards
    return arr[a0:a0 + B, shard * rows:(shard + 1) * rows]


def rank_state_from_arrays(state: Mapping[str, Any], a0: int, B: int,
                           shard: int = 0, shards: int = 1,
                           device="cpu") -> Dict[str, Any]:
    """A train state of numpy arrays (the JAX package's ``init_state`` or
    train step) sliced to one rank's block and carried as
    :func:`train_state_from_arrays` carries a whole state: the state a
    multi-rank step of the port takes on that rank.  A bus state (at
    ``shards`` 1 or S) gives :func:`rank_slice`'s block of each bus —
    agents ``[a0, a0 + B)``, row shard ``shard`` — and an overlap
    pipeline's slots each so; a tree state gives agents ``[a0, a0 + B)`` of
    every leaf of the parameters and of every optimizer slot (a tree has
    no row shards)."""
    if isinstance(state["params"], Mapping):
        if shards != 1:
            raise ValueError("a tree state is split by agents only: the row "
                             "shards of agents='pod' hold a bus")

        def block(tree):
            flat: Dict[str, np.ndarray] = {}
            _walk(tree, "", flat)
            return {p: np.asarray(a)[a0:a0 + B] for p, a in flat.items()}

        return train_state_from_arrays(
            {"params": block(state["params"]),
             "opt": {k: block(v) for k, v in state["opt"].items()},
             "step": state["step"]}, device)
    out = {"params": rank_slice(np.asarray(state["params"]), a0, B, shard,
                                shards),
           "opt": {k: rank_slice(np.asarray(v), a0, B, shard, shards)
                   for k, v in state["opt"].items()},
           "step": state["step"]}
    if "pipeline" in state:
        slot = np.asarray(state["pipeline"]["slot"])
        out["pipeline"] = {
            "slot": np.stack([rank_slice(s, a0, B, shard, shards)
                              for s in slot]),
            "parity": state["pipeline"]["parity"]}
    return train_state_from_arrays(out, device)


def expert_block(params, index: int, count: int):
    """``params`` with every MoE expert leaf cut to model rank ``index``
    of ``count``'s block of experts, ``[index·E/count, (index+1)·E/count)``
    along its expert dim; every other leaf as it is: :func:`tp_block`
    under the expert-parallel layout
    (:func:`repro_torch.models.transformer.expert_param_specs`).
    ``params`` is a ``{path: tensor or array}`` dict or a nested numpy
    tree (as :func:`params_from_tree` takes it, e.g.
    ``jax.tree.map(np.asarray, params)``), which comes back as a flat
    ``{path: array}`` dict.  A cut leaf is a copy of its block."""
    from repro_torch.models.transformer import expert_param_specs
    flat: Dict[str, Any] = {}
    _walk(params, "", flat)
    return tp_block(flat, expert_param_specs(flat), index, count)


def tp_block(params, specs, index: int, count: int):
    """``params`` with every leaf cut to model rank ``index`` of
    ``count``'s block under ``specs`` (``{path: PartitionSpec}``, e.g.
    :func:`repro_torch.models.transformer.lm_param_specs`):
    :func:`repro_torch.core.sharding.shard_params` at the coordinates
    ``{"model": (index, count), "data": (0, 1)}``.  ``params`` is a
    ``{path: tensor or array}`` dict or a nested numpy tree, which comes
    back as a flat ``{path: array}`` dict."""
    from repro_torch.core.sharding import shard_params
    flat: Dict[str, Any] = {}
    _walk(params, "", flat)
    return shard_params(flat, specs, {"model": (index, count),
                                      "data": (0, 1)})
