"""The overlapped gossip pipeline across ranks (``build_train_step(mesh=,
overlap="delayed")``, straggler plans, pipeline checkpoints) against the
JAX package's multi-device delayed step and the port's one-process run.

A tiny dense model (one layer, d_model 32: ``tests/test_torch_dist_
train.py``'s), EDM, fused kernels (their plain versions on the CPU) unless
a run says ``plain``, 3 steps on seeded tokens, every run from the JAX
package's ``init_state`` (pipeline included; each rank its block through
:func:`repro_torch.weights.rank_state_from_arrays`).  One module fixture
spawns 4 gloo ranks (a ``file://`` rendezvous) and, beside them, one JAX
subprocess on 8 host devices that runs the reference's
``build_train_step(mesh=, agent_axes=)`` on the same runs: ring, exp and
``round_robin`` at one agent a rank, blocked (B = 2 of 8 agents), the
pod mode (A × S = 2 × 2), the f32, bf16 and int8 wires, churn (masked
rounds) and straggler plans.

Checks: per-agent losses and the final x, m, ψ (and e) and the pipeline's
live slot and parity bit-equal to the port's one-process run; against the
JAX step, the metrics a step within rtol 1e-5 (atol 1e-9: the consensus is
0 at step 0) and the final buses within rtol 1e-5, atol 1e-6 in f32
(``tests/test_torch_overlap.py``'s tolerances against the one-device
reference), the wire runs within ``tests/test_torch_wire_trajectory.py``'s
quanta bound; the record of a delayed ring step: 2 collective-permutes
(the reference's HLO pin, ``tests/test_overlap.py``), each started before
the backward pass and waited on after it; a pipeline state saved across
ranks after one step (odd parity, int8 residual) is the one-process file,
and resumed across ranks it finishes bit-equal to the uninterrupted run.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import weights
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.elastic import DropPlan, StragglerPlan
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               make_gossip_schedule)

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD, SEQ, STEPS, VOCAB = 4, 8, 3, 64
CFG = dict(name="dist-tiny", family="dense", n_layers=1, d_model=32,
           n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=VOCAB,
           dtype="float32")
CHURN = {"n_agents": 4, "epochs": [{"start": 0, "down": []},
                                   {"start": 1, "down": [3]},
                                   {"start": 2, "down": []}]}
# run: agents, agents a rank, shards, wire, schedule, topology, late slots
# ({"late": [[step, [slot, ...]], ...]}), churn, fused
RUNS = {
    "ring-B1-f32": (4, 1, 1, "f32", "static", "ring", None, None, True),
    "ring-B1-f32-plain": (4, 1, 1, "f32", "static", "ring", None, None,
                          False),
    "exp-B1-f32": (4, 1, 1, "f32", "static", "exp", None, None, True),
    "rr-B1-f32": (4, 1, 1, "f32", "round_robin", "exp", None, None, True),
    "ring-B2-f32": (8, 2, 1, "f32", "static", "ring", None, None, True),
    "exp-B2-int8": (8, 2, 1, "int8", "static", "exp", None, None, True),
    "ring-pod2x2-f32": (2, 1, 2, "f32", "static", "ring", None, None, True),
    "ring-B1-bf16": (4, 1, 1, "bf16", "static", "ring", None, None, True),
    "ring-B1-int8": (4, 1, 1, "int8", "static", "ring", None, None, True),
    "churn-ring-B1-f32": (4, 1, 1, "f32", "static", "ring", None, CHURN,
                          True),
    "ring-B1-f32-straggler": (4, 1, 1, "f32", "static", "ring",
                              {"late": [[1, [1]], [2, [2, 1]]]}, None, True),
    "rr-B1-int8-straggler": (4, 1, 1, "int8", "round_robin", "exp",
                             {"late": [[1, [1]]]}, None, True),
}
CKPT_RUN = "ring-B1-int8"      # saved after one step, resumed across ranks


def _run_kw(name, one_process=False):
    A, B, S, wire, sched, topo, _, _, _ = RUNS[name]
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", remat=False, wire=wire,
                overlap="delayed", gossip_schedule=sched, topology=topo,
                agents="pod" if S > 1 else "data",
                agents_per_device=A if one_process else B)


def _plan(name, sched):
    late = RUNS[name][6]
    if late is None:
        return None
    return StragglerPlan.from_json(late, max(len(r.terms)
                                             for r in sched.rounds))


def _sched(name, run):
    churn = RUNS[name][7]
    return make_gossip_schedule(run, RUNS[name][0],
                                churn=None if churn is None
                                else DropPlan.from_json(churn))


def _tokens(A):
    rng = np.random.default_rng(A)
    return [rng.integers(0, VOCAB, (A, 1, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _bufs(state):
    pipe = state["pipeline"]
    return {"x": state["params"], **dict(state["opt"]),
            "phi": pipe["slot"][int(pipe["parity"])]}


def _flat(state):
    """A JAX state as npz arrays."""
    out = {"params": np.asarray(state["params"]),
           "pipeline|slot": np.asarray(state["pipeline"]["slot"]),
           "pipeline|parity": np.asarray(state["pipeline"]["parity"]),
           "step": np.asarray(state["step"])}
    out.update({f"opt|{k}": np.asarray(v) for k, v in state["opt"].items()})
    return out


def _unflat(arrs):
    return {"params": arrs["params"],
            "opt": {k[4:]: v for k, v in arrs.items()
                    if k.startswith("opt|")},
            "pipeline": {"slot": arrs["pipeline|slot"],
                         "parity": int(arrs["pipeline|parity"])},
            "step": int(arrs["step"])}


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    model = build_model(ModelConfig(**CFG))
    out, rec = {}, {}
    for name, (A, B, S, *_, fused) in RUNS.items():
        pod = S > 1
        mesh = (make_gossip_mesh(A, pods=A, shards=S) if pod
                else make_gossip_mesh(A, agents_per_device=B))
        if not mesh.member:
            continue
        sa = "data" if pod else None
        run = RunConfig(**_run_kw(name))
        sched = _sched(name, run)

        def new_step():
            return build_train_step(model, run, sched, use_fused_kernel=fused,
                                    straggler_plan=_plan(name, sched),
                                    device="cpu", mesh=mesh, shard_axes=sa)

        step = new_step()
        a0, B, s, S = rank_block(mesh, A, sa)
        init = _unflat(dict(np.load(f"{d}/init-{name}.npz")))
        state = weights.rank_state_from_arrays(init, a0, B, s, S)
        layout = bus_layout_for(model, A, shards=S)
        losses, metrics, logs = [], [], []
        for t, toks in enumerate(_tokens(A)):
            with comm.recording() as log:
                state, m = step(state, {"tokens": torch.from_numpy(toks)})
            logs.append(log)
            losses.append(m["agent_losses"].tolist())
            metrics.append({k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")})
            if name == CKPT_RUN and t == 0:
                checkpoint.save_state_ranks(f"{d}/ckpt-ranks.npz", state,
                                            layout, mesh, A)
        for k, v in _bufs(state).items():
            out[f"{name}|{k}"] = v.numpy()
        log = logs[1]
        rec[name] = {
            "losses": losses, "metrics": metrics, "block": [a0, B, s, S],
            "parity": int(state["pipeline"]["parity"]),
            "permutes": [[c.started, c.waited] for c in log
                         if c.kind == "collective-permute"
                         and c.tag == "gossip"],
            "marks": dict(log.marks)}
        if name == CKPT_RUN:
            like = weights.rank_state_from_arrays(init, a0, B, s, S)
            back = checkpoint.load_state_ranks(f"{d}/ckpt-ranks.npz", like,
                                               layout, mesh, A)
            rec["resumed_at"] = [back["step"],
                                 int(back["pipeline"]["parity"])]
            step2 = new_step()
            for toks in _tokens(A)[back["step"]:]:
                back, _ = step2(back, {"tokens": torch.from_numpy(toks)})
            for k, v in _bufs(back).items():
                out[f"resumed|{k}"] = v.numpy()
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


_JAX_CODE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs.base import ModelConfig, RunConfig
from repro.core.elastic import DropPlan, StragglerPlan
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model
from repro.train import build_train_step, make_gossip_schedule, state_specs

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
model = build_model(ModelConfig(**spec["cfg"]))
for name, r in spec["runs"].items():
    A, B, S = r["A"], r["B"], r["S"]
    run = RunConfig(**r["run"])
    sched = make_gossip_schedule(run, A, churn=None if r["churn"] is None
                                 else DropPlan.from_json(r["churn"]))
    plan = None
    if r["late"] is not None:
        K = max(len(t.terms) for t in sched.rounds)
        plan = StragglerPlan(K, tuple((int(s), tuple(ks))
                                      for s, ks in r["late"]["late"]))
    a = dict(np.load(f"{d}/init-{name}.npz"))
    state = {"params": a["params"],
             "opt": {k[4:]: v for k, v in a.items() if k.startswith("opt|")},
             "pipeline": {"slot": a["pipeline|slot"],
                          "parity": a["pipeline|parity"]},
             "step": a["step"]}
    if S > 1:
        mesh = make_gossip_mesh(A, pods=A, shards=S)
        axes, sa = gossip_agent_axes(mesh, sharded=True), "data"
        shardings = jax.tree.map(
            lambda sp: NamedSharding(mesh, sp),
            state_specs(model, run, multi_pod=True),
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        state = jax.tree.map(jax.device_put, state, shardings)
    else:
        mesh = make_gossip_mesh(A, agents_per_device=B)
        axes, sa = gossip_agent_axes(mesh), None
    step = jax.jit(build_train_step(model, run, sched, mesh=mesh,
                                    agent_axes=axes, shard_axes=sa,
                                    use_fused_kernel=r["fused"],
                                    straggler_plan=plan))
    rng = np.random.default_rng(A)
    toks = [rng.integers(0, spec["cfg"]["vocab_size"], (A, 1, r["run"][
        "seq_len"])).astype(np.int32) for _ in range(spec["steps"])]
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": t})
        metrics.append({k: float(v) for k, v in m.items()})
    final = {"x": np.asarray(state["params"]),
             **{k: np.asarray(v) for k, v in state["opt"].items()}}
    par = int(state["pipeline"]["parity"])
    final["phi"] = np.asarray(state["pipeline"]["slot"])[par]
    np.savez(f"{d}/jax-{name}.npz", **final)
    json.dump(metrics, open(f"{d}/jax-{name}.json", "w"))
print("JAX_OVERLAP_OK")
"""


def _jax_init(name):
    """The JAX package's initial state of a run (its pipeline included)."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import build_model as jbuild_model
    from repro.train import init_state as jinit_state
    A, S = RUNS[name][0], RUNS[name][2]
    jrun = JRunConfig(**_run_kw(name, one_process=S == 1))
    state = jinit_state(jbuild_model(JModelConfig(**CFG)), jrun, A,
                        jax.random.PRNGKey(0), shards=S)
    return _flat(jax.tree.map(np.asarray, state))


def _port_run(name, init, ckpt_path=None):
    """The port's one-process run of ``name`` from the JAX init: per-agent
    losses, metrics, final buffers (pod runs: the unsharded layout's)."""
    A, _, S, *_, fused = RUNS[name]
    model = build_model(ModelConfig(**CFG))
    run = RunConfig(**{**_run_kw(name, one_process=True), "agents": "data"})
    sched = _sched(name, run)
    step = build_train_step(model, run, sched, use_fused_kernel=fused,
                            straggler_plan=_plan(name, sched), device="cpu")
    state = weights.train_state_from_arrays(_unflat(init))
    from repro_torch.train import trainer
    seen, inner = [], trainer.losses_and_grads

    def spy(*a, **k):
        losses, g = inner(*a, **k)
        seen.append(losses.tolist())
        return losses, g

    trainer.losses_and_grads = spy
    try:
        metrics = []
        for t, toks in enumerate(_tokens(A)):
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            metrics.append({k: float(v) for k, v in m.items()})
            if ckpt_path and t == 0:
                checkpoint.save_state(ckpt_path, state,
                                      layout=bus_layout_for(model, A))
    finally:
        trainer.losses_and_grads = inner
    return seen, metrics, {k: v.numpy() for k, v in _bufs(state).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_overlap")
    inits = {}
    for name in RUNS:
        inits[name] = _jax_init(name)
        np.savez(d / f"init-{name}.npz", **inits[name])
    spec = {"cfg": CFG, "steps": STEPS, "runs": {
        name: {"A": A, "B": B, "S": S, "run": _run_kw(name),
               "late": late, "churn": churn, "fused": fused}
        for name, (A, B, S, _, _, _, late, churn, fused) in RUNS.items()}}
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CODE, str(d / "spec.json"), str(d)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    port = {}
    for name in RUNS:
        # the pod runs' one-process twin: the same agents, unsharded
        init = (inits[name] if RUNS[name][2] == 1
                else _jax_init_unsharded(name))
        port[name] = _port_run(name, init, ckpt_path=str(
            d / "ckpt-one.npz") if name == CKPT_RUN else None)
    deadline = time.time() + 240
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            jax_proc.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    out_j, err_j = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, out_j[-2000:] + err_j[-3000:]
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    jax_runs = {name: (json.loads((d / f"jax-{name}.json").read_text()),
                       dict(np.load(d / f"jax-{name}.npz")))
                for name in RUNS}
    return d, port, jax_runs, arrays, recs


def _jax_init_unsharded(name):
    """A pod run's init at shards 1 (the one-process twin's layout)."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import build_model as jbuild_model
    from repro.train import init_state as jinit_state
    A = RUNS[name][0]
    jrun = JRunConfig(**{**_run_kw(name, one_process=True),
                         "agents": "data"})
    state = jinit_state(jbuild_model(JModelConfig(**CFG)), jrun, A,
                        jax.random.PRNGKey(0))
    return _flat(jax.tree.map(np.asarray, state))


def _assemble(arrays, recs, key, name):
    """The full (A, rows, 128) bus of a run from its ranks' blocks."""
    blocks = [(r[name]["block"], a[key]) for a, r in zip(arrays, recs)
              if name in r]
    blocks.sort(key=lambda b: (b[0][0], b[0][2]))
    S = blocks[0][0][3]
    if S == 1:
        return np.concatenate([b for _, b in blocks], 0)
    return np.concatenate([np.concatenate([b for _, b in blocks
                                           [a * S:(a + 1) * S]], 1)
                           for a in range(len(blocks) // S)], 0)


def _leaves(bus: np.ndarray, A: int, shards: int):
    from repro_torch.core import bus as parambus
    model = build_model(ModelConfig(**CFG))
    return parambus.unpack_tree(bus_layout_for(model, A, shards=shards),
                                torch.from_numpy(np.ascontiguousarray(bus)))


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_overlap_bit_equal_to_one_process(results, name):
    _, port, _, arrays, recs = results
    A, _, S, *_ = RUNS[name]
    seen, metrics, final = port[name]
    ran = [r for r in recs if name in r]
    assert len(ran) == WORLD
    for r in ran:
        assert r[name]["losses"] == seen, name
        assert r[name]["parity"] == STEPS % 2
        for t, (got, want) in enumerate(zip(r[name]["metrics"], metrics)):
            assert got["loss"] == want["loss"], (name, t)
    for k, want in final.items():
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        if S == 1:
            assert np.array_equal(got, want), (name, k)
        else:
            lg, lw = _leaves(got, A, S), _leaves(want, A, 1)
            for p in lw:
                assert torch.equal(lg[p], lw[p]), (name, k, p)


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_overlap_matches_jax_multi_device_step(results, name):
    _, _, jax_runs, arrays, recs = results
    A, _, S, wire, *_ = RUNS[name]
    jmetrics, jfinal = jax_runs[name]
    r0 = next(r for r in recs if name in r)
    rtol = 1e-5 if wire == "f32" else 1e-3
    for t, (got, want) in enumerate(zip(r0[name]["metrics"], jmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       atol=1e-9,
                                       err_msg=f"{name} step {t} {key}")
    for k in ("x", "m", "psi", "phi"):
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        if wire == "f32":
            np.testing.assert_allclose(got, jfinal[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k}")
            continue
        from test_torch_wire_trajectory import FLIP_SHARE, QUANTA, _quantum
        w_max = 0.5
        err = np.abs(got - jfinal[k])
        assert (err <= QUANTA * _quantum(jfinal[k], wire, w_max)
                + 1e-5).all(), (name, k)
        assert (err > 1e-5).mean() <= FLIP_SHARE, (name, k)


def test_late_slots_and_churn_change_the_run(results):
    """The straggler and churn runs are not the plain ring run: their late
    slots and masked rounds took effect (on every rank alike)."""
    _, _, _, arrays, recs = results
    base = _assemble(arrays, recs, "ring-B1-f32|x", "ring-B1-f32")
    for name in ("ring-B1-f32-straggler", "churn-ring-B1-f32"):
        got = _assemble(arrays, recs, f"{name}|x", name)
        assert not np.array_equal(got, base), name


def test_delayed_ring_step_permutes_around_the_backward(results):
    """The reference's pin (``tests/test_overlap.py``): a delayed ring step
    keeps one collective-permute a nonzero-shift term, 2; each is started
    before the step's forward and backward pass and waited on after it."""
    _, _, _, _, recs = results
    for r in recs:
        rec = r["ring-B1-f32"]
        assert len(rec["permutes"]) == 2, rec["permutes"]
        for started, waited in rec["permutes"]:
            assert started < rec["marks"]["backward"] \
                < rec["marks"]["backward done"] < waited, rec


def test_pipeline_checkpoint_across_ranks_resumes_bit_equal(results):
    d, _, _, arrays, recs = results
    # the gathered file is the one-process run's, array by array
    with np.load(d / "ckpt-ranks.npz") as a, np.load(d / "ckpt-one.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "pipeline|parity" in a.files
        assert any(f.startswith("pipeline|phi|") for f in a.files)
        for f in a.files:
            assert np.array_equal(a[f], b[f]), f
    assert all(r["resumed_at"] == [1, 1] for r in recs)
    for k in ("x", "m", "psi", "e", "phi"):
        got = np.concatenate([a[f"resumed|{k}"] for a in arrays], 0)
        want = _assemble(arrays, recs, f"{CKPT_RUN}|{k}", CKPT_RUN)
        assert np.array_equal(got, want), k


def test_masked_overlap_needs_one_agent_a_rank():
    """Masked rounds in the overlap keep the reference's B = 1 rule (a
    hand-built grid of 2 ranks × 2 agents: the refusal comes before any
    collective)."""
    from repro_torch.core import elastic, mixing
    from repro_torch.core.comm import GossipMesh
    from repro_torch.core.schedule import StaticSchedule
    from repro_torch.core.topology import ring
    grid = GossipMesh((2,), ("data",), 4, 2, 1, 0, (0,), ((0, 1),), (None,),
                      None, None, torch.device("cpu"), "gloo", False,
                      ("h0",) * 2)
    sched = elastic.ElasticSchedule(StaticSchedule(ring(4)),
                                    DropPlan.from_json(CHURN))
    with pytest.raises(ValueError, match="B = 1"):
        mixing.make_overlap_mixer(sched, "ppermute", mesh=grid)
