"""Multi-rank gossip (``repro_torch.core.mixing.mix_ranks``) against the JAX
package and against the port's one-process engine.

One module fixture spawns 4 gloo ranks on the CPU (``torch.multiprocessing``,
a ``file://`` rendezvous in ``tmp_path``) that run every case on their
agent block and write it to npz; the parent puts the blocks back together.
Cases: the topology matrix of ``tests/test_gossip_engines.py`` at sizes 4
ranks carry — one agent a rank, blocked (``B = A / 4``), split ``("pod",
"data")`` grids — each fused and unfused; every round of
``RoundRobinExp``; churn-masked rounds at B = 1 and B = 2; the bf16 and
int8 wires (masked too); a tree of two leaves; the shard-resident engine
and ``mix_dense_sharded`` at A × S = 2 × 2.

Checks: against JAX ``mix_dense`` at rtol 1e-5, atol 1e-6 (the reference's
own tolerance; a wire case against ``mix_dense`` of the codec's
quantized bus); bit for bit against the port's one-process engine with the
same ``use_fused_kernel`` (the same terms in the same order; gloo copies
bytes); and for a handful of cases against JAX ``mix_ppermute`` itself on
a forced 8-device host mesh (one JAX subprocess), at rtol 1e-5, atol 1e-6.
"""
import os
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import elastic as tel
from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core.wire import make_codec

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ROWS = 16
BLOCK = 8                  # the wire codecs' block_rows


def _topo(name, args, kw=None):
    return getattr(ttopo, name)(*args, **(kw or {}))


def _cases():
    """(case id, spec): spec = topology (or schedule round), agents per
    rank, pods of the grid, fused, wire, shards, mask."""
    out = []
    flat = [("ring", (4,)), ("exp_graph", (4,)), ("fully_connected", (4,)),
            ("torus2d", (2, 2)), ("hierarchical", (2, 2)),
            ("disconnected", (4,))]
    blocked = [("ring", (32,), None), ("ring", (8,), None),
               ("exp_graph", (16,), None), ("torus2d", (4, 4), None),
               ("fully_connected", (8,), None),
               ("hierarchical", (2, 16), None),
               ("hierarchical", (4, 4), {"intra": "ring"}),
               ("disconnected", (8,), None)]
    for fused in (False, True):
        f = "fused" if fused else "plain"
        for name, args in flat:
            out.append((f"{name}{args}-B1-{f}",
                        dict(topo=(name, args, None), pods=1, fused=fused)))
        for name, args in (("hierarchical", (2, 2)), ("torus2d", (2, 2))):
            out.append((f"{name}{args}-split-{f}",
                        dict(topo=(name, args, None), pods=2, fused=fused)))
        for name, args, kw in blocked:
            out.append((f"{name}{args}{'-' + str(kw) if kw else ''}-"
                        f"blocked-{f}",
                        dict(topo=(name, args, kw), pods=1, fused=fused)))
        for A in (4, 8):
            for r in range(tsched.RoundRobinExp(A).period):
                out.append((f"round_robin{A}-r{r}-{f}",
                            dict(rr=(A, r), pods=1, fused=fused)))
        for A, down in ((4, 3), (8, 5)):
            out.append((f"masked-ring{A}-down{down}-{f}",
                        dict(topo=("ring", (A,), None), pods=1, fused=fused,
                             down=down)))
        for wire in ("bf16", "int8"):
            for name, args in (("ring", (4,)), ("exp_graph", (8,))):
                out.append((f"{name}{args}-{wire}-{f}",
                            dict(topo=(name, args, None), pods=1,
                                 fused=fused, wire=wire)))
            out.append((f"masked-ring8-down5-{wire}-{f}",
                        dict(topo=("ring", (8,), None), pods=1, fused=fused,
                             down=5, wire=wire)))
        for name in ("ring", "exp_graph"):
            out.append((f"{name}(2)-pod2x2-{f}",
                        dict(topo=(name, (2,), None), pods=2, fused=fused,
                             shards=2)))
    out.append(("tree-ring(4)-B1-fused",
                dict(topo=("ring", (4,), None), pods=1, fused=True,
                     tree=True)))
    out.append(("dense_sharded-ring(2)-2x2",
                dict(topo=("ring", (2,), None), pods=2, shards=2,
                     dense_sharded=True)))
    out.append(("dense_sharded-exp_graph(2)-2x2",
                dict(topo=("exp_graph", (2,), None), pods=2, shards=2,
                     dense_sharded=True)))
    return out


CASES = _cases()
CASE_IDS = [c for c, _ in CASES]
CHURN = {"n_agents": 8, "epochs": [{"start": 0, "down": []},
                                   {"start": 3, "down": [5]},
                                   {"start": 6, "down": []}]}
# schedule mixers across ranks: (name, fused), steps 0..SCHED_STEPS-1
SCHED_CASES = [("round_robin4", False), ("elastic_round_robin8", True),
               ("elastic_round_robin8", False)]
SCHED_STEPS = 7


def _sched(name, pkg):
    """The port's (``pkg`` = its core modules) or the reference's schedule
    of a SCHED_CASES name."""
    schedule, elastic = pkg
    if name == "round_robin4":
        return schedule.RoundRobinExp(4)
    return elastic.ElasticSchedule(schedule.RoundRobinExp(8),
                                   elastic.DropPlan.from_json(CHURN))


def _round(spec):
    """The port's round of a case spec."""
    if "rr" in spec:
        A, r = spec["rr"]
        return tsched.RoundRobinExp(A).rounds[r]
    topo = _topo(*spec["topo"])
    if "down" in spec:
        alive = [1] * topo.n_agents
        alive[spec["down"]] = 0
        topo = tel.degrade_round(topo, alive)
    return topo


def _inputs(cid, spec, A):
    rng = np.random.default_rng(zlib.crc32(cid.encode()))
    if spec.get("tree"):
        return {"a": rng.standard_normal((A, 5)).astype(np.float32),
                "b": rng.standard_normal((A, 2, 3)).astype(np.float32)}
    return rng.standard_normal((A, ROWS, 128)).astype(np.float32)


def _payload(x, wire):
    """The codec's payload of the f32 bus ``x`` (a tensor), or x."""
    if wire is None:
        return x
    return make_codec(wire, BLOCK).encode(x)


def _block(t, a0, B, s, S):
    rows = t.shape[1] // S
    return t[a0:a0 + B, s * rows:(s + 1) * rows]


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    data = np.load(f"{d}/inputs.npz")
    outs = {}
    for cid, spec in CASES:
        topo = _round(spec)
        A = topo.n_agents
        S = spec.get("shards", 1)
        if S > 1:
            mesh = make_gossip_mesh(A, pods=A, shards=S)
        else:
            pods = spec["pods"]
            B = 1 if pods > 1 or A == world else A // world
            mesh = make_gossip_mesh(A, pods=pods, agents_per_device=B)
        sa = "data" if S > 1 else None
        if not mesh.member:
            continue
        a0, B, s, S = rank_block(mesh, A, sa)
        if spec.get("tree"):
            x = {k: torch.from_numpy(data[f"{cid}|{k}"])[a0:a0 + B]
                 for k in ("a", "b")}
        else:
            x = _block(torch.from_numpy(data[cid]), a0, B, s, S)
        if spec.get("dense_sharded"):
            got = tmix.mix_dense_sharded(topo, mesh, "pod", "data", x)
        else:
            wire = spec.get("wire")
            codec = make_codec(wire, BLOCK) if wire else None
            mix = tmix.make_mixer(topo, "ppermute", mesh=mesh, shard_axes=sa,
                                  use_fused_kernel=spec.get("fused", False),
                                  wire=codec)
            got = mix(_payload(x, wire))
        if isinstance(got, dict):
            for k, v in got.items():
                outs[f"{cid}|{k}"] = v.numpy()
        else:
            outs[cid] = got.numpy()
    for name, fused in SCHED_CASES:
        sched = _sched(name, (tsched, tel))
        A = sched.n_agents
        mesh = make_gossip_mesh(A, agents_per_device=A // world)
        a0, B, _, _ = rank_block(mesh, A)
        x = torch.from_numpy(data[f"sched-{name}"])[a0:a0 + B]
        mix = tmix.make_schedule_mixer(sched, "ppermute", mesh=mesh,
                                       use_fused_kernel=fused)
        for t in range(SCHED_STEPS):
            outs[f"sched-{name}-{fused}|{t}"] = mix(x, step=t).numpy()
    np.savez(f"{d}/rank{rank}.npz", **outs)
    torch.distributed.destroy_process_group()


_JAX_CODE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
from repro.core import RoundRobinExp, exp_graph, hierarchical, ring, torus2d
from repro.core.mixing import mix_ppermute

def submesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)

data = np.load(sys.argv[1])
cases = {
    "ring(4,)-B1-plain": (ring(4), (4,), ("data",), False),
    "hierarchical(2, 2)-split-plain": (hierarchical(2, 2), (2, 2),
                                       ("pod", "data"), False),
    "ring(32,)-blocked-plain": (ring(32), (4,), ("data",), False),
    "exp_graph(16,)-blocked-fused": (exp_graph(16), (4,), ("data",), True),
    "hierarchical(4, 4)-{'intra': 'ring'}-blocked-plain": (
        hierarchical(4, 4, intra="ring"), (4,), ("data",), False),
    "round_robin8-r1-plain": (RoundRobinExp(8).rounds[1], (4,), ("data",),
                              False),
}
out = {}
for cid, (topo, shape, names, fused) in cases.items():
    axes = names if len(names) > 1 else names[0]
    got = jax.jit(lambda x, topo=topo, shape=shape, names=names, axes=axes,
                  fused=fused: mix_ppermute(topo, submesh(shape, names), axes,
                                            x, use_fused_kernel=fused))(
        data[cid])
    out[cid] = np.asarray(got)
np.savez(sys.argv[2], **out)
print("JAX_MIX_OK", len(out))
"""
JAX_CASES = ["ring(4,)-B1-plain", "hierarchical(2, 2)-split-plain",
             "ring(32,)-blocked-plain", "exp_graph(16,)-blocked-fused",
             "hierarchical(4, 4)-{'intra': 'ring'}-blocked-plain",
             "round_robin8-r1-plain"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_mixing")
    inputs = {}
    for cid, spec in CASES:
        x = _inputs(cid, spec, _round(spec).n_agents)
        if isinstance(x, dict):
            inputs.update({f"{cid}|{k}": v for k, v in x.items()})
        else:
            inputs[cid] = x
    for name, _ in SCHED_CASES:
        A = _sched(name, (tsched, tel)).n_agents
        inputs[f"sched-{name}"] = _inputs(name, {}, A)
    np.savez(d / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CODE, str(d / "inputs.npz"),
         str(d / "jax.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    deadline = time.time() + 240
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    out_j, err_j = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, out_j[-2000:] + err_j[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return inputs, ranks, dict(np.load(d / "jax.npz"))


def _assemble(ranks, key, spec, A):
    """The full (A, ...) result from the ranks' blocks."""
    parts = [r[key] for r in ranks if key in r]
    S = spec.get("shards", 1)
    if S == 1:
        return np.concatenate(parts, 0)
    # (A, S) grid, row-major: agent a's shards s = 0..S-1 in order
    return np.concatenate([np.concatenate(parts[a * S:(a + 1) * S], 1)
                           for a in range(A)], 0)


def _one_process(spec, x):
    topo = _round(spec)
    A = topo.n_agents
    wire = spec.get("wire")
    codec = make_codec(wire, BLOCK) if wire else None
    mix = tmix.make_mixer(topo, "ppermute", agents_per_device=A,
                          use_fused_kernel=spec.get("fused", False),
                          wire=codec)
    return mix(_payload(x, wire))


def _same_bits(got: np.ndarray, want: np.ndarray) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape and bool(
        ((got.view(np.int32) == want.view(np.int32))
         | (np.isnan(got) & np.isnan(want))).all())


@pytest.mark.parametrize("cid", CASE_IDS)
def test_multi_rank_mix_matches_reference_and_one_process(results, cid):
    from repro.core import mixing as jmix
    from repro.core import topology as jtopo
    from repro.core import elastic as jel
    from repro.core import schedule as jsched
    inputs, ranks, _ = results
    spec = dict(CASES)[cid]
    topo = _round(spec)
    A = topo.n_agents
    keys = ["a", "b"] if spec.get("tree") else [None]
    # the reference's round, and its dense oracle
    if "rr" in spec:
        jt = jsched.RoundRobinExp(A).rounds[spec["rr"][1]]
    else:
        name, args, kw = spec["topo"]
        jt = getattr(jtopo, name)(*args, **(kw or {}))
        if "down" in spec:
            alive = [1] * A
            alive[spec["down"]] = 0
            jt = jel.degrade_round(jt, alive)
    for k in keys:
        key = cid if k is None else f"{cid}|{k}"
        got = _assemble(ranks, key, spec, A)
        x = torch.from_numpy(inputs[key])
        wire = spec.get("wire")
        xin = (make_codec(wire, BLOCK).quantize(x) if wire else x).numpy()
        want = np.asarray(jmix.mix_dense(jt, xin))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{key} vs JAX mix_dense")
        if spec.get("dense_sharded"):
            continue
        one = _one_process(spec, x if k is None else {k: x})
        one = one if k is None else one[k]
        assert _same_bits(got, one.numpy()), \
            f"{key}: multi-rank differs from the one-process engine"


@pytest.mark.parametrize("cid", JAX_CASES)
def test_multi_rank_mix_matches_jax_mix_ppermute(results, cid):
    inputs, ranks, jax_out = results
    spec = dict(CASES)[cid]
    got = _assemble(ranks, cid, spec, _round(spec).n_agents)
    np.testing.assert_allclose(got, jax_out[cid], rtol=1e-5, atol=1e-6)


def test_every_case_ran_on_its_ranks(results):
    _, ranks, _ = results
    for cid, spec in CASES:
        key = f"{cid}|a" if spec.get("tree") else cid
        assert sum(key in r for r in ranks) == WORLD, cid


def test_rank_mixer_refuses_what_ranks_do_not_run():
    # the dense and shifts engines do not run across ranks; a mesh-less
    # ppermute engine with agents spread over devices points at mesh=
    with pytest.raises(ValueError, match="mesh="):
        tmix.mix_ppermute(ttopo.ring(4), torch.zeros(4, 8, 128),
                          agents_per_device=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmix.make_overlap_mixer(ttopo.ring(4), "ppermute",
                                agents_per_device=2)


def _grid(hosts):
    """A one-axis grid of 4 ranks seen from rank 0, on ``hosts`` (no
    process group: the eligibility reads the grid only)."""
    from repro_torch.core.comm import GossipMesh
    return GossipMesh((4,), ("data",), 4, 1, 1, 0, (0,), ((0, 1, 2, 3),),
                      (None,), None, None, torch.device("cpu"), "nccl",
                      False, tuple(hosts))


def test_peer_ring_needs_its_ranks_on_one_host():
    """The peer-pointer ring opens its neighbours' memory through CUDA IPC,
    which reaches no other host: a ring spread over two hosts is not
    eligible (the NCCL permutes carry it), and a forced ``ring_dma``
    raises; on one host the same ring is eligible."""
    topo = ttopo.ring(4)
    x = torch.zeros(1, 8, 128)
    assert tmix._peer_unfit(topo, _grid(["h0"] * 4), x, ("data",), 1, None,
                            None) == ""
    split = _grid(["h0", "h0", "h1", "h1"])
    why = tmix._peer_unfit(topo, split, x, ("data",), 1, None, None)
    assert "one host" in why and "h1" in why
    with pytest.raises(ValueError, match="one host"):
        tmix.make_mixer(topo, "ppermute", mesh=split, use_fused_kernel=True,
                        transport="ring_dma")


@pytest.mark.parametrize("name,fused", SCHED_CASES)
def test_schedule_mixer_across_ranks(results, name, fused):
    """Time-varying rounds and churn (an ``ElasticSchedule``: agent 5 down
    for steps 3–5) through the schedule mixer across ranks: each step's
    round, bit-equal to the one-process schedule mixer, and against JAX
    ``mix_dense`` of the reference schedule's round."""
    from repro.core import elastic as jel
    from repro.core import mixing as jmix
    from repro.core import schedule as jsched
    inputs, ranks, _ = results
    sched = _sched(name, (tsched, tel))
    jsch = _sched(name, (jsched, jel))
    x = torch.from_numpy(inputs[f"sched-{name}"])
    one = tmix.make_schedule_mixer(sched, "ppermute",
                                   agents_per_device=sched.n_agents,
                                   use_fused_kernel=fused)
    for t in range(SCHED_STEPS):
        got = np.concatenate([r[f"sched-{name}-{fused}|{t}"]
                              for r in ranks], 0)
        assert _same_bits(got, one(x, step=t).numpy()), (name, t)
        np.testing.assert_allclose(
            got, np.asarray(jmix.mix_dense(jsch.round(t), x.numpy())),
            rtol=1e-5, atol=1e-6, err_msg=f"{name} step {t}")
