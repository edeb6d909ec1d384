"""Policy groups across ranks (``build_train_step(mesh=)`` with
``gossip_groups``: ``core/mixing.py::make_group_mixer(mesh=)``) against
the JAX package's multi-device grouped step and the port's one-process
run.

``tests/test_torch_dist_overlap.py``'s tiny dense model, EDM, fused
kernels (their plain versions on the CPU), 4 steps on seeded tokens (the
every-other-step group gossips at steps 1 and 3: both rounds of its
``round_robin`` schedule), every run from the JAX package's
``init_state``.  One module fixture spawns 4 gloo ranks and, beside them,
one JAX subprocess on 8 host devices running the reference's grouped step
``build_train_step(mesh=, agent_axes=)``.  Policies:

* ``f32``: the embeddings opt out, attention gossips every step on the
  ring, the rest every other step on ``round_robin`` over ``exp``
  (``chip_smoke.py`` phase 26's policy) — at one agent a rank, blocked
  (B = 2 of 8 agents) and in the pod mode (A × S = 2 × 2);
* ``wires``: ``tests/test_torch_groups.py``'s 4-group policy (an int8
  group every other step, a bf16 group on ``round_robin``);
* ``optout``: the embeddings opt out, the rest gossips on the ring every
  step; and the ungrouped bus beside it.

Checks: per-agent losses and the final x, m, ψ bit-equal to the port's
one-process grouped run; the f32 runs against the JAX step within rtol
1e-5 a step (atol 1e-9) and the buses within rtol 1e-5, atol 1e-6 (the
wired policy is held to the port only: the reference's group mixer leaves
a wired group's encode out, ROADMAP §3); the reference's pin
(``tests/test_groups.py``): an opt-out group ships zero collectives — the
``optout`` step makes the 2 permutes of the ungrouped ring step, of the
rows that gossip only — and an off-cadence step ships nothing for its
group.
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
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for,
                               make_gossip_schedule, resolve_features)

from test_torch_dist_overlap import CFG, ROOT, VOCAB, _assemble
from test_torch_groups import POLICY

torch.set_num_threads(1)  # xdist workers share the cores

WORLD, SEQ, STEPS = 4, 8, 4
POLICIES = {
    "f32": json.dumps([
        {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
        {"name": "attn", "match": ["|attn|"]},
        {"name": "rest", "gossip_every": 2, "schedule": "round_robin"}]),
    "wires": POLICY,
    "optout": json.dumps([
        {"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},
        {"name": "rest"}]),
    "none": "",
}
# run: agents, agents a rank, shards, policy, held against JAX
RUNS = {"f32-B1": (4, 1, 1, "f32", True), "f32-B2": (8, 2, 1, "f32", True),
        "f32-pod2x2": (2, 1, 2, "f32", True),
        "wires-B1": (4, 1, 1, "wires", False),
        "optout-B1": (4, 1, 1, "optout", True),
        "none-B1": (4, 1, 1, "none", False)}


def _run_kw(name, one_process=False):
    A, B, S, policy, _ = RUNS[name]
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", remat=False,
                topology="ring", gossip_groups=POLICIES[policy],
                agents="pod" if S > 1 and not one_process else "data",
                agents_per_device=A if one_process else B)


def _tokens(A):
    rng = np.random.default_rng(A)
    return [rng.integers(0, VOCAB, (A, 1, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _bufs(state):
    return {"x": state["params"], **dict(state["opt"])}


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.launch import collectives
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    model = build_model(ModelConfig(**CFG))
    out, rec = {}, {}
    for name, (A, B, S, *_) in RUNS.items():
        pod = S > 1
        mesh = (make_gossip_mesh(A, pods=A, shards=S) if pod
                else make_gossip_mesh(A, agents_per_device=B))
        if not mesh.member:
            continue
        sa = "data" if pod else None
        run = RunConfig(**_run_kw(name))
        step = build_train_step(model, run, make_gossip_schedule(run, A),
                                use_fused_kernel=True, device="cpu",
                                mesh=mesh, shard_axes=sa)
        a0, B, s, S = rank_block(mesh, A, sa)
        init = dict(np.load(f"{d}/init-{name}.npz"))
        state = weights.rank_state_from_arrays(
            {"params": init["params"],
             "opt": {k[4:]: v for k, v in init.items()
                     if k.startswith("opt|")}, "step": 0}, a0, B, s, S)
        losses, metrics, counts, nbytes = [], [], [], []
        for toks in _tokens(A):
            with comm.recording() as log:
                state, m = step(state, {"tokens": torch.from_numpy(toks)})
            losses.append(m["agent_losses"].tolist())
            metrics.append({k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")})
            counts.append(collectives.count_collectives(log, "gossip"))
            nbytes.append(collectives.collective_bytes(log, "gossip")[
                "collective-permute"])
        for k, v in _bufs(state).items():
            out[f"{name}|{k}"] = v.numpy()
        rec[name] = {"losses": losses, "metrics": metrics,
                     "block": [a0, B, s, S], "counts": counts,
                     "bytes": nbytes}
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


_JAX_CODE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec
from repro.configs.base import ModelConfig, RunConfig
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model
from repro.train import build_train_step, make_gossip_schedule, state_specs

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
model = build_model(ModelConfig(**spec["cfg"]))
for name, r in spec["runs"].items():
    A, B, S = r["A"], r["B"], r["S"]
    run = RunConfig(**r["run"])
    sched = make_gossip_schedule(run, A)
    a = dict(np.load(f"{d}/init-{name}.npz"))
    state = {"params": a["params"],
             "opt": {k[4:]: v for k, v in a.items() if k.startswith("opt|")},
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
                                    use_fused_kernel=True))
    rng = np.random.default_rng(A)
    toks = [rng.integers(0, spec["cfg"]["vocab_size"], (A, 1, r["run"][
        "seq_len"])).astype(np.int32) for _ in range(spec["steps"])]
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": t})
        metrics.append({k: float(v) for k, v in m.items()})
    np.savez(f"{d}/jax-{name}.npz", x=np.asarray(state["params"]),
             **{k: np.asarray(v) for k, v in state["opt"].items()})
    json.dump(metrics, open(f"{d}/jax-{name}.json", "w"))
print("JAX_GROUPS_OK")
"""


def _jax_init(name, shards):
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import build_model as jbuild_model
    from repro.train import init_state as jinit_state
    A = RUNS[name][0]
    jrun = JRunConfig(**_run_kw(name, one_process=shards == 1))
    state = jinit_state(jbuild_model(JModelConfig(**CFG)), jrun, A,
                        jax.random.PRNGKey(0), shards=shards)
    state = jax.tree.map(np.asarray, state)
    return {"params": state["params"], "step": np.asarray(state["step"]),
            **{f"opt|{k}": v for k, v in state["opt"].items()}}


def _port_run(name, init):
    """The port's one-process grouped run from the JAX init (shards 1)."""
    A = RUNS[name][0]
    model = build_model(ModelConfig(**CFG))
    run = RunConfig(**_run_kw(name, one_process=True))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    state = weights.train_state_from_arrays(
        {"params": init["params"], "step": 0,
         "opt": {k[4:]: v for k, v in init.items() if k.startswith("opt|")}})
    from repro_torch.train import trainer
    seen, inner = [], trainer.losses_and_grads

    def spy(*a, **k):
        losses, g = inner(*a, **k)
        seen.append(losses.tolist())
        return losses, g

    trainer.losses_and_grads = spy
    try:
        metrics = []
        for toks in _tokens(A):
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        trainer.losses_and_grads = inner
    return seen, metrics, {k: v.numpy() for k, v in _bufs(state).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_groups")
    for name, (A, B, S, *_) in RUNS.items():
        np.savez(d / f"init-{name}.npz", **_jax_init(name, S))
    spec = {"cfg": CFG, "steps": STEPS, "runs": {
        name: {"A": A, "B": B, "S": S, "run": _run_kw(name)}
        for name, (A, B, S, _, to_jax) in RUNS.items() if to_jax}}
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CODE, str(d / "spec.json"), str(d)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    port = {name: _port_run(name, _jax_init(name, 1)) for name in RUNS}
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
                for name in spec["runs"]}
    return port, jax_runs, arrays, recs


def _leaves_of(bus, name, shards):
    """A grouped bus's leaves (``_leaves`` of the ungrouped layout does
    not apply: the groups reorder the rows)."""
    from repro_torch.core import bus as parambus
    A = RUNS[name][0]
    model = build_model(ModelConfig(**CFG))
    groups = resolve_features(RunConfig(**_run_kw(name))).groups
    return parambus.unpack_tree(
        bus_layout_for(model, A, groups, shards=shards),
        torch.from_numpy(np.ascontiguousarray(bus)))


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_groups_bit_equal_to_one_process(results, name):
    port, _, arrays, recs = results
    A, _, S, *_ = RUNS[name]
    seen, metrics, final = port[name]
    ran = [r for r in recs if name in r]
    assert len(ran) == WORLD
    for r in ran:
        assert r[name]["losses"] == seen, name
        for t, (got, want) in enumerate(zip(r[name]["metrics"], metrics)):
            assert got["loss"] == want["loss"], (name, t)
    for k, want in final.items():
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        if S == 1:
            assert np.array_equal(got, want), (name, k)
        else:
            lg, lw = _leaves_of(got, name, S), _leaves_of(want, name, 1)
            for p in lw:
                assert torch.equal(lg[p], lw[p]), (name, k, p)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[4]])
def test_rank_groups_match_jax_multi_device_step(results, name):
    _, jax_runs, arrays, recs = results
    jmetrics, jfinal = jax_runs[name]
    r0 = next(r for r in recs if name in r)
    for t, (got, want) in enumerate(zip(r0[name]["metrics"], jmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-9,
                                       err_msg=f"{name} step {t} {key}")
    for k in ("x", "m", "psi"):
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        np.testing.assert_allclose(got, jfinal[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name} {k}")


def test_opt_out_group_ships_zero_collectives(results):
    """The reference's pin: the opt-out rows make no collective — the
    ``optout`` ring step makes the ungrouped ring step's 2 permutes, and
    ships the gossiping rows' bytes only (at this size the two buses pad
    to the same rows, so the bytes equal the ungrouped step's)."""
    _, _, _, recs = results
    model = build_model(ModelConfig(**CFG))
    layout = bus_layout_for(model, 4, resolve_features(
        RunConfig(**_run_kw("optout-B1"))).groups)
    embed = next(g for g in layout.groups if g.name == "embed")
    for r in recs:
        base, opt = r["none-B1"], r["optout-B1"]
        assert base["counts"] == opt["counts"] == \
            [{"collective-permute": 2}] * STEPS
        assert embed.rows > 0
        rest_rows = layout.rows - embed.rows
        assert opt["bytes"] == [2 * rest_rows * 128 * 4] * STEPS


def test_off_cadence_steps_ship_nothing_for_their_group(results):
    """The ``f32`` policy at one agent a rank: attention's 2 ring permutes
    every step; the every-other-step group's one ``round_robin`` permute
    on the odd steps only; the embeddings none."""
    _, _, _, recs = results
    for r in recs:
        counts = [c.get("collective-permute", 0)
                  for c in r["f32-B1"]["counts"]]
        assert counts == [2, 3, 2, 3], counts
