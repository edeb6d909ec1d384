"""Gossip meshes over ``torch.distributed`` ranks: the counterpart of
``repro/launch/mesh.py``'s ``make_gossip_mesh`` / ``gossip_agent_axes``.

The JAX package runs multi-device gossip as one SPMD program over a device
mesh.  The port runs one process per rank: a
:class:`~repro_torch.core.comm.GossipMesh` is the rank grid that carries
the agent grid (``core/comm.py``, with :func:`gossip_agent_axes`, which
this module re-exports as the reference's module has it).

* :func:`init_distributed` joins the process group: from torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and ``MASTER_ADDR`` /
  ``MASTER_PORT``), or from an explicit ``init_method`` (a ``file://``
  store in the tests).  The backend is gloo on the CPU and NCCL on CUDA;
  beside NCCL a gloo group carries the control plane (the peer-pointer
  handle exchange, the metrics).  Rank r takes ``cuda:(LOCAL_RANK %
  device_count)``; when more ranks than cards share a host (``shared``),
  NCCL cannot run (it refuses two ranks on one card), so the default
  group is gloo and only the peer-pointer ring kernel carries gossip
  (:mod:`repro_torch.kernels.ring_peer`).
* :func:`make_gossip_mesh` builds the grid with the reference's rules and
  the same rejections (a ``ValueError`` where the reference asserts); it
  is collective: every rank of the world calls it with the same arguments,
  since every process group is made by all ranks.  The grid's ranks
  exchange their host names once over the control group
  (``GossipMesh.hosts``): the peer-pointer ring needs its ranks on one
  host.
* :func:`make_moe_mesh` builds the ``("data", "model")`` rank grid of the
  expert-parallel MoE layer (:func:`repro_torch.models.moe.set_moe_mesh`)
  and of tensor-parallel serving (``build_model(cfg, mesh=grid)``) with the
  same per-axis groups; :func:`make_sim_mesh` is its 1 × 1 grid
  in one process (no process group), as the reference's tests build a
  ``(1, 1)`` mesh on one device.

The TPU constants of the reference's module (``HW``,
``make_production_mesh``) have no counterpart here.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.comm import GossipMesh, gossip_agent_axes

__all__ = ["GossipMesh", "init_distributed", "make_gossip_mesh",
           "make_moe_mesh", "make_sim_mesh", "gossip_agent_axes",
           "rank_device", "shared_card"]

_GROUPS: Dict[tuple, object] = {}
_RANK_DEVICE: Dict[str, torch.device] = {}    # set by init_distributed


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank: ``cpu``, or ``cuda:(LOCAL_RANK %
    device_count)`` (asked for explicitly; raises without a card)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("multi-rank gossip on cuda needs a CUDA device; "
                           "pass device='cpu' (CLI: --device cpu) for gloo "
                           "on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def shared_card(device: torch.device) -> bool:
    """Do more of this host's ranks run than it has cards (so that some
    ranks share one)?  Always False on the CPU."""
    if device.type != "cuda":
        return False
    local_world = int(os.environ.get(
        "LOCAL_WORLD_SIZE", dist.get_world_size() if dist.is_initialized()
        else 1))
    return local_world > torch.cuda.device_count()


def init_distributed(device: str = "cuda", *, init_method: str = "",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 60.0) -> torch.device:
    """Join the default process group (once) and return this rank's
    device.  Without ``init_method`` the rendezvous is torchrun's
    environment (``env://``); ``rank`` / ``world_size`` default to
    ``RANK`` / ``WORLD_SIZE``.  gloo on the CPU and on a card that ranks
    share, NCCL otherwise (pinned to the rank's card)."""
    if init_method and (rank is None or world_size is None):
        raise ValueError("init_method needs rank= and world_size=")
    if rank is not None:
        os.environ.setdefault("LOCAL_RANK", str(rank))
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world_size))
    if not dist.is_initialized():
        kw = dict(timeout=datetime.timedelta(seconds=timeout_s))
        if init_method:
            kw.update(init_method=init_method, rank=rank,
                      world_size=world_size)
        dev = torch.device(device)
        backend = "gloo"
        if dev.type == "cuda":
            dev = rank_device(device)
            torch.cuda.set_device(dev)
            if not shared_card(dev):
                backend = "nccl"
                kw["device_id"] = dev
        dist.init_process_group(backend, **kw)
    _RANK_DEVICE["device"] = rank_device(device)
    return _RANK_DEVICE["device"]


def _group(ranks: Tuple[int, ...], backend: Optional[str] = None):
    """The process group of ``ranks`` (made once: every rank of the world
    makes every group, in the same order), or the default group when
    ``ranks`` is the whole world and no other backend is asked for."""
    if ranks == tuple(range(dist.get_world_size())) and backend is None:
        return dist.group.WORLD
    key = (ranks, backend)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks), backend=backend)
    return _GROUPS[key]


def _slices(shape, coords) -> Tuple[Tuple[int, ...], ...]:
    """Per axis, the flat ranks that share every other coordinate with
    ``coords``, in axis order."""
    out = []
    for i in range(len(shape)):
        ranks = []
        for v in range(shape[i]):
            c = list(coords)
            c[i] = v
            flat = 0
            for n, ci in zip(shape, c):
                flat = flat * n + ci
            ranks.append(flat)
        out.append(tuple(ranks))
    return tuple(out)


def _coords(shape, flat: int) -> Tuple[int, ...]:
    """Row-major coordinates of rank ``flat`` in the grid ``shape``."""
    coords = []
    for n in reversed(shape):
        coords.append(flat % n)
        flat //= n
    return tuple(reversed(coords))


def _all_slices(shape):
    """Every slice of every axis (each process group the grid needs), in
    one order on every rank."""
    seen = []
    for flat in range(math.prod(shape)):
        for sl in _slices(shape, _coords(shape, flat)):
            if sl not in seen:
                seen.append(sl)
    return seen


def make_gossip_mesh(n_agents: int, pods: int = 1,
                     agents_per_device: int = 1, shards: int = 1,
                     device=None) -> GossipMesh:
    """Rank grid carrying the agent grid, as the reference's
    ``make_gossip_mesh``: one agent per rank (default) gives ``(pods,
    n_agents // pods)`` with axes ``('pod', 'data')`` when ``pods > 1``,
    else ``(n_agents,)`` with ``('data',)``; blocked mode (``B =
    agents_per_device > 1``) always the flat ``('data',)`` axis over ``A /
    B`` ranks.  Shard-resident mode (``shards > 1``): an ``(n_agents,
    shards)`` grid with axes ``('pod', 'data')`` where 'pod' is the agent
    axis and 'data' the row-shard axis (pods must equal n_agents; B = 1).
    Built over the first ranks of the world; raises when the world is too
    small.  ``device`` defaults to the one :func:`init_distributed` chose
    (else ``cpu`` under gloo, ``cuda`` under NCCL)."""
    B = agents_per_device
    if B < 1 or n_agents % B:
        raise ValueError(f"agents_per_device={B} must divide n_agents="
                         f"{n_agents}")
    if n_agents % max(pods, 1):
        raise ValueError(f"pods={pods} must divide n_agents={n_agents}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if not dist.is_initialized():
        raise RuntimeError("make_gossip_mesh needs the process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    if shards > 1:
        if B != 1:
            raise ValueError("shard-resident gossip needs one agent per "
                             "slice")
        if pods not in (1, n_agents):
            raise ValueError("shards>1 makes every agent a pod — pods must "
                             "equal n_agents")
        shape, names = (n_agents, shards), ("pod", "data")
    else:
        n_dev = n_agents // B
        if B == 1 and pods > 1:
            shape, names = (pods, n_dev // pods), ("pod", "data")
        else:
            shape, names = (n_dev,), ("data",)
    n_dev = math.prod(shape)
    if world < n_dev:
        what = (f"{n_agents} pod-agents × {shards} shards" if shards > 1
                else f"{B}-agent-per-device gossip")
        raise ValueError(f"need {n_dev} ranks for {what}, have {world}")
    return _grid(shape, names, n_agents, B, shards, device)


def _grid(shape, names, n_agents: int, B: int, shards: int,
          device) -> GossipMesh:
    """The :class:`GossipMesh` of the grid ``shape`` over the world's
    first ranks: every slice's process group made (by every rank, in one
    order; a gloo twin of each beside NCCL), this rank's coordinates,
    slices and groups, the grid's host names."""
    n_dev = math.prod(shape)
    backend = dist.get_backend()
    if device is None:
        device = _RANK_DEVICE.get("device", "cpu" if backend == "gloo"
                                  else "cuda")
    dev = rank_device(str(torch.device(device).type))
    ctrl_backend = "gloo" if backend != "gloo" else None
    # every rank makes every group (a collective), in one order
    for sl in _all_slices(shape):
        _group(sl)
        if ctrl_backend:
            _group(sl, ctrl_backend)
    grid = tuple(range(n_dev))
    world_group = _group(grid)
    control = _group(grid, ctrl_backend) if ctrl_backend else world_group
    rank = dist.get_rank()
    if rank >= n_dev:
        return GossipMesh(shape, names, n_agents, B, shards, rank, None, (),
                          (), world_group, control, dev, backend, False)
    coords = _coords(shape, rank)
    slices = _slices(shape, coords)
    groups = tuple(_group(sl) for sl in slices)
    hosts = [None] * n_dev
    dist.all_gather_object(hosts, socket.gethostname(), group=control)
    return GossipMesh(shape, names, n_agents, B, shards, rank, coords,
                      slices, groups, world_group, control, dev, backend,
                      shared_card(dev), tuple(hosts))


def make_moe_mesh(data: int = 1, model: Optional[int] = None,
                  device=None) -> GossipMesh:
    """The expert-parallel MoE layer's ``(data, model)`` rank grid, axes
    ``("data", "model")``, row-major over the world's first ``data ·
    model`` ranks (``model`` defaults to the world over ``data``): rank
    ``r`` is data index ``r // model`` and model index ``r % model``, as
    the reference's ``jax.make_mesh((data, model), ("data", "model"))``
    lays out its devices.  It is also the tensor-parallel serving grid: a
    ``(1, M)`` grid holds one model replica split over its model axis
    (``build_model(cfg, mesh=grid)``, :mod:`repro_torch.core.sharding`).
    Collective, as :func:`make_gossip_mesh`; the grid carries no agents
    (``n_agents`` is its data extent).  Ranks beyond the grid get a mesh
    with no coordinates."""
    if not dist.is_initialized():
        raise RuntimeError("make_moe_mesh needs the process group: call "
                           "repro_torch.launch.mesh.init_distributed first")
    world = dist.get_world_size()
    if model is None:
        model = world // max(data, 1)
    if data < 1 or model < 1:
        raise ValueError(f"a ({data}, {model}) grid has no ranks")
    if data * model > world:
        raise ValueError(f"need {data * model} ranks for a ({data}, "
                         f"{model}) grid, have {world}")
    return _grid((data, model), ("data", "model"), data, 1, 1, device)


def make_sim_mesh() -> GossipMesh:
    """The 1 × 1 ``("data", "model")`` grid in one process, with no
    process group: :func:`repro_torch.models.moe.apply_moe_shard_map` on
    it makes no collective, as the reference's layer on a ``(1, 1)`` mesh
    of one device."""
    return GossipMesh((1, 1), ("data", "model"), 1, 1, 1, 0, (0, 0),
                      ((0,), (0,)), (None, None), None, None,
                      torch.device("cpu"), "", False, ("",))
