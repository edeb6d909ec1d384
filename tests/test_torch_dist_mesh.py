"""The port's gossip meshes (``repro_torch.launch.mesh``) against the JAX
package's ``make_gossip_mesh`` / ``gossip_agent_axes``, and the collectives
layer with its recorder (``repro_torch.launch.collectives``).

The reference builds its meshes over the first devices of a host forced to
``WORLD`` devices (one JAX subprocess); the port over the first ranks of a
world of ``WORLD`` gloo ranks (one spawn, a ``file://`` rendezvous).  For
every argument set both give the same grid shape, axis names and agent
axes, or both refuse it (the reference asserts, the port raises
``ValueError``) — ``tests/test_shard.py::
test_gossip_mesh_sharded_needs_devices``' cases among them.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

# (n_agents, pods, agents_per_device, shards)
MESH_CASES = [(4, 1, 1, 1), (4, 2, 1, 1), (4, 4, 1, 1), (8, 1, 2, 1),
              (16, 1, 4, 1), (8, 2, 2, 1), (2, 1, 1, 1), (2, 2, 1, 2),
              (2, 1, 1, 2), (1, 1, 1, 4),
              # refused: pods must equal n_agents; too few devices; B or
              # pods not dividing the agents; B > 1 with shards
              (4, 2, 1, 2), (WORLD, WORLD, 1, 8), (8, 1, 1, 1),
              (3, 1, 2, 1), (4, 3, 1, 1), (4, 4, 2, 2)]


def _describe(make, axes_of, args):
    try:
        mesh = make(*args)
    except (AssertionError, ValueError) as err:
        return {"refused": True, "why": str(err)[:80]}
    names = tuple(mesh.axis_names)
    shape = (tuple(mesh.devices.shape) if hasattr(mesh, "devices")
             else tuple(mesh.shape))
    out = {"refused": False, "shape": list(shape), "names": list(names),
           "axes": axes_of(mesh, False)}
    try:
        out["sharded_axes"] = axes_of(mesh, True)
    except (AssertionError, ValueError):
        out["sharded_axes"] = None
    return out


_JAX_CODE = f"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={WORLD}"
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
import sys
sys.path.insert(0, {str(Path(__file__).resolve().parent)!r})
from test_torch_dist_mesh import MESH_CASES, _describe

def axes(mesh, sharded):
    a = gossip_agent_axes(mesh, sharded=sharded)
    return list(a) if isinstance(a, tuple) else a

print("JAX_MESH " + json.dumps([_describe(
    lambda *a: make_gossip_mesh(*a), axes, c) for c in MESH_CASES]))
"""


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.mesh import (gossip_agent_axes, init_distributed,
                                         make_gossip_mesh)
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)

    def axes(mesh, sharded):
        a = gossip_agent_axes(mesh, sharded=sharded)
        return list(a) if isinstance(a, tuple) else a

    rec = {"meshes": [_describe(make_gossip_mesh, axes, c)
                      for c in MESH_CASES]}
    mesh = make_gossip_mesh(4, pods=2)
    rec["coords"] = list(mesh.coords)
    rec["slices"] = [list(s) for s in mesh.slices]
    rec["hosts"] = list(mesh.hosts)
    rec["member"] = [make_gossip_mesh(2).member]
    pod = make_gossip_mesh(2, pods=2, shards=2)
    rec["block_pod"] = list(rank_block(pod, 2, "data"))
    rec["block_blocked"] = list(rank_block(make_gossip_mesh(
        8, agents_per_device=2), 8))
    # collectives: a permute along 'data' (within a pod), the self-permute
    # that moves nothing, an all-gather feeding a permute, an all-reduce
    x = torch.full((2, 3), float(rank))
    with comm.recording() as log:
        got = comm.ppermute(x, [(0, 1), (1, 0)], mesh.ranks("data"),
                            mesh.group("data"))
        same = comm.ppermute(x, [(0, 0), (1, 1)], mesh.ranks("pod"),
                             mesh.group("pod"))
        g = comm.all_gather(x, mesh.world_group, 4)
        fed = comm.ppermute(g[:1], [(i, (i + 1) % 4) for i in range(4)],
                            tuple(range(4)), mesh.world_group)
        tot = comm.all_reduce(torch.tensor([float(rank)]), mesh.world_group,
                              4)
    rec["permuted"] = got[0, 0].item()
    rec["self_is_input"] = same is x
    rec["gathered"] = g[:, 0].tolist()
    rec["fed"] = fed[0, 0].item()
    rec["sum"] = tot.item()
    rec["log"] = [[c.kind, list(c.shape), c.group_size, c.nbytes,
                   c.from_gather] for c in log]
    rec["counts"] = coll.count_collectives(log)
    rec["bytes"] = coll.collective_bytes(log)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_CODE], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    deadline = time.time() + 120
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the ranks did not finish in 120 s")
    out, err = jax_proc.communicate(timeout=120)
    assert jax_proc.returncode == 0, out[-2000:] + err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("JAX_MESH "))
    ranks = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return json.loads(line[len("JAX_MESH "):]), ranks


@pytest.mark.parametrize("i", range(len(MESH_CASES)),
                         ids=[str(c) for c in MESH_CASES])
def test_gossip_mesh_matches_reference(results, i):
    jax_meshes, ranks = results
    want = jax_meshes[i]
    for r in ranks:
        got = r["meshes"][i]
        assert got["refused"] == want["refused"], (MESH_CASES[i], got, want)
        if not want["refused"]:
            for k in ("shape", "names", "axes", "sharded_axes"):
                assert got[k] == want[k], (MESH_CASES[i], k, got, want)


def test_mesh_coordinates_slices_and_blocks(results):
    _, ranks = results
    for rank, r in enumerate(ranks):
        p, d = divmod(rank, 2)
        assert r["coords"] == [p, d]
        # along 'pod' the ranks of this rank's data column, along 'data'
        # the ranks of its pod
        assert r["slices"] == [[d, 2 + d], [2 * p, 2 * p + 1]]
        assert r["member"] == [rank < 2]
        assert r["block_pod"] == [p, 1, d, 2]
        assert r["block_blocked"] == [2 * rank, 2, 0, 1]
        # the grid's host names, exchanged once (the peer ring's check)
        assert r["hosts"] == [socket.gethostname()] * 4


def test_collectives_and_their_record(results):
    _, ranks = results
    for rank, r in enumerate(ranks):
        p, d = divmod(rank, 2)
        assert r["permuted"] == float(2 * p + (1 - d))
        assert r["self_is_input"]
        assert r["gathered"] == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
        assert r["fed"] == 0.0
        assert r["sum"] == 6.0
        # the self-permute is not on the wire; the permute of the gathered
        # rows is flagged as fed by an all-gather
        assert r["log"] == [
            ["collective-permute", [2, 3], 2, 24, False],
            ["all-gather", [8, 3], 4, 72, False],
            ["collective-permute", [1, 3], 4, 12, True],
            ["all-reduce", [1], 4, 6, False]]
        assert r["counts"] == {"collective-permute": 2, "all-gather": 1,
                               "all-reduce": 1}
        assert r["bytes"] == {"collective-permute": 36.0,
                              "all-gather": 72.0, "all-reduce": 6.0}
