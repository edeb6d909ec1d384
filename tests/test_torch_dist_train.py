"""The multi-rank bus step (``build_train_step(mesh=, shard_axes=)``), its
collectives and its checkpoints, against the port's one-process run and
the JAX package's one-device step.

A tiny dense model (one layer, d_model 32: the reference's
``tests/test_shard.py`` configuration), ring, EDM, fused kernels (their
plain versions on the CPU), 3 steps on seeded tokens, every run from the
JAX package's ``init_state`` (each rank its block, through
:func:`repro_torch.weights.rank_state_from_arrays`).  One module fixture
spawns 4 gloo ranks (a ``file://`` rendezvous) that run:

* ``agents="data"``, 4 ranks × 1 agent, f32 and int8 wire;
* 2 ranks × 2 agents (blocked; ranks 2–3 are outside that mesh), f32 and
  int8;
* ``agents="pod"``, A × S = 2 × 2 (each agent's bus in two row shards);
  its collectives over one step; its state saved gathered to rank 0, and a
  file of the JAX package (shards 1) restored into its row shards.

Checks: per-agent losses and the final x, m, ψ (and e) bit-equal to the
port's one-process run (pod: the unpacked leaves, whose row padding
differs); against the JAX step, the port-vs-JAX tolerances of
``tests/test_torch_train.py`` (loss rtol 1e-4; buses atol 1e-5) and, for
int8, of ``tests/test_torch_wire_trajectory.py``; the pod run against the
JAX unsharded run within the reference's ``SHARD_TRAJ_OK`` tolerance
(rtol 1e-4, atol 1e-5).  The pod step's record shows one ``(1,
shard_rows, 128)`` f32 permute per nonzero-shift term, none fed by an
all-gather, and wire bytes equal to ``wire_bytes_per_step``'s model (the
data and blocked runs too).
"""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import weights
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import bus as parambus
from repro_torch.core.topology import ring
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state)

torch.set_num_threads(1)  # xdist workers share the cores

WORLD, SEQ, STEPS, VOCAB = 4, 8, 3, 64
CFG = dict(name="dist-tiny", family="dense", n_layers=1, d_model=32,
           n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=VOCAB,
           dtype="float32")
# run name: (agents, agents per rank, shards, wire)
RUNS = {"data4-f32": (4, 1, 1, "f32"), "data4-int8": (4, 1, 1, "int8"),
        "blocked2x2-f32": (4, 2, 1, "f32"),
        "blocked2x2-int8": (4, 2, 1, "int8"),
        "pod2x2-f32": (2, 1, 2, "f32")}


def _run_kw(A, wire, pod=False):
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", remat=False, wire=wire,
                agents="pod" if pod else "data")


def _tokens(A):
    rng = np.random.default_rng(A)
    return [rng.integers(0, VOCAB, (A, 1, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _bufs(state):
    return {"x": state["params"],
            **{k: v for k, v in state["opt"].items()}}


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core.schedule import StaticSchedule, wire_bytes_per_step
    from repro_torch.core.wire import make_codec
    from repro_torch.launch import collectives as coll
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    model = build_model(ModelConfig(**CFG))
    out, rec = {}, {}
    for name, (A, B, S, wire) in RUNS.items():
        pod = S > 1
        mesh = (make_gossip_mesh(A, pods=A, shards=S) if pod
                else make_gossip_mesh(A, agents_per_device=B))
        if not mesh.member:
            continue
        sa = "data" if pod else None
        run = RunConfig(**_run_kw(A, wire, pod))
        step = build_train_step(model, run, ring(A), use_fused_kernel=True,
                                device="cpu", mesh=mesh, shard_axes=sa)
        a0, B, s, S = rank_block(mesh, A, sa)
        init = dict(np.load(f"{d}/init-{A}-{S}-{wire}.npz"))
        state = weights.rank_state_from_arrays(
            {"params": init["params"],
             "opt": {k[4:]: v for k, v in init.items()
                     if k.startswith("opt|")}, "step": 0}, a0, B, s, S)
        losses, metrics, logs = [], [], []
        for t, toks in enumerate(_tokens(A)):
            with comm.recording() as log:
                state, m = step(state, {"tokens": torch.from_numpy(toks)})
            logs.append(log)
            losses.append(m["agent_losses"].tolist())
            metrics.append({k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")})
        for k, v in _bufs(state).items():
            out[f"{name}|{k}"] = v.numpy()
        layout = bus_layout_for(model, A, shards=S)
        codec = make_codec(wire, layout.block_rows)
        gossip = [c for c in logs[1] if c.tag == "gossip"]
        rec[name] = {
            "losses": losses, "metrics": metrics, "block": [a0, B, s, S],
            "permutes": [[c.kind, list(c.shape), str(c.dtype),
                          c.from_gather] for c in gossip],
            "kinds": coll.count_collectives(logs[1]),
            "gossip_bytes": coll.collective_bytes(gossip)[
                "collective-permute"],
            "model_bytes": wire_bytes_per_step(
                StaticSchedule(ring(A)), 1,
                elems_per_agent=layout.padded_elems, agents_per_device=B,
                codec=codec if wire != "f32" else None),
            "shard_rows": layout.shard_rows}
        if pod:
            checkpoint.save_state_ranks(f"{d}/pod.npz", state, layout, mesh,
                                        A)
            back = checkpoint.load_state_ranks(f"{d}/jax_final.npz", state,
                                               layout, mesh, A, sa)
            for k, v in _bufs(back).items():
                out[f"restored|{k}"] = v.numpy()
            rec["restored_step"] = back["step"]
        if not pod and wire == "f32" and B == 1:
            checkpoint.save_state_ranks(f"{d}/data4.npz", state, layout,
                                        mesh, A)
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _jax_run(A, wire, shards=1):
    """The JAX package's one-device fused step: init (at ``shards``),
    per-step metrics, final state, as numpy."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
    from repro.models import build_model as jbuild_model
    from repro.train import build_train_step as jbuild_train_step
    from repro.train import init_state as jinit_state
    from repro.train import make_gossip_schedule
    model = jbuild_model(JModelConfig(**CFG))
    run = JRunConfig(**_run_kw(A, wire), agents_per_device=A)
    state = jinit_state(model, run, A, jax.random.PRNGKey(0), shards=shards)
    init = jax.tree.map(np.array, state)
    if shards > 1:
        return init, None, None
    mesh = make_gossip_mesh(A, agents_per_device=A)
    step = jax.jit(jbuild_train_step(
        model, run, make_gossip_schedule(run, A), use_fused_kernel=True,
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    metrics = []
    for toks in _tokens(A):
        state, m = step(state, {"tokens": toks})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.array, state)


def _port_run(init, A, wire):
    """The port's one-process fused run from the JAX init: per-agent
    losses, metrics, final state."""
    model = build_model(ModelConfig(**CFG))
    run = RunConfig(**_run_kw(A, wire), agents_per_device=A)
    step = build_train_step(model, run, ring(A), use_fused_kernel=True,
                            device="cpu")
    state = weights.train_state_from_arrays(init)
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
    return seen, metrics, state


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro.train import checkpoint as jcheckpoint
    from repro.train import bus_layout_for as jbus_layout_for
    from repro.models import build_model as jbuild_model
    from repro.configs.base import ModelConfig as JModelConfig
    d = tmp_path_factory.mktemp("dist_train")
    jax_runs, port_runs = {}, {}
    for A, wire in ((4, "f32"), (4, "int8"), (2, "f32")):
        init, metrics, final = _jax_run(A, wire)
        jax_runs[(A, wire)] = (init, metrics, final)
        np.savez(d / f"init-{A}-1-{wire}.npz", params=init["params"],
                 **{f"opt|{k}": v for k, v in init["opt"].items()})
        port_runs[(A, wire)] = _port_run(init, A, wire)
    init2, _, _ = _jax_run(2, "f32", shards=2)
    np.savez(d / "init-2-2-f32.npz", params=init2["params"],
             **{f"opt|{k}": v for k, v in init2["opt"].items()})
    jmodel = jbuild_model(JModelConfig(**CFG))
    jcheckpoint.save_state(str(d / "jax_final.npz"), jax_runs[(2, "f32")][2],
                           layout=jbus_layout_for(jmodel, 2))
    checkpoint.save_state(str(d / "port_data4.npz"),
                          port_runs[(4, "f32")][2],
                          layout=bus_layout_for(build_model(
                              ModelConfig(**CFG)), 4))
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    deadline = time.time() + 240
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    return d, jax_runs, port_runs, arrays, recs


def _assemble(arrays, recs, key, name):
    """The full (A, rows, 128) bus of a run from its ranks' blocks."""
    blocks = [(r[name]["block"], a[key]) for a, r in zip(arrays, recs)
              if name in r]
    blocks.sort(key=lambda b: (b[0][0], b[0][2]))
    A = RUNS[name][0]
    S = blocks[0][0][3]
    return np.concatenate([np.concatenate([b for _, b in blocks
                                           [a * S:(a + 1) * S]], 1)
                           for a in range(len(blocks) // S)], 0) \
        if S > 1 else np.concatenate([b for _, b in blocks], 0)[:A]


def _leaves(bus: np.ndarray, A: int, shards: int):
    model = build_model(ModelConfig(**CFG))
    return parambus.unpack_tree(bus_layout_for(model, A, shards=shards),
                                torch.from_numpy(bus))


@pytest.mark.parametrize("name", list(RUNS))
def test_multi_rank_run_bit_equal_to_one_process(results, name):
    _, _, port_runs, arrays, recs = results
    A, B, S, wire = RUNS[name]
    seen, metrics, final = port_runs[(A, wire)]
    for r in recs:
        if name in r:
            assert r[name]["losses"] == seen, name
            for t, (got, want) in enumerate(zip(r[name]["metrics"],
                                                metrics)):
                assert got["loss"] == want["loss"], (name, t)
    for k, want in _bufs(final).items():
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        if S == 1:
            assert np.array_equal(got, want.numpy()), (name, k)
        else:
            lg, lw = _leaves(got, A, S), _leaves(want.numpy(), A, 1)
            for p in lw:
                assert torch.equal(lg[p], lw[p]), (name, k, p)


@pytest.mark.parametrize("name", list(RUNS))
def test_multi_rank_run_matches_jax_step(results, name):
    _, jax_runs, _, arrays, recs = results
    A, B, S, wire = RUNS[name]
    _, jmetrics, jfinal = jax_runs[(A, wire)]
    r0 = next(r for r in recs if name in r)
    tol = 1e-4 if wire == "f32" else 1e-3
    for t, (got, want) in enumerate(zip(r0[name]["metrics"], jmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=tol,
                                       err_msg=f"{name} step {t} {key}")
    x = _assemble(arrays, recs, f"{name}|x", name)
    if S > 1:
        # the reference's SHARD_TRAJ_OK: leaves against the unsharded run
        lg, lw = _leaves(x, A, S), _leaves(jfinal["params"], A, 1)
        for p in lw:
            np.testing.assert_allclose(lg[p].numpy(), lw[p].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=p)
    elif wire == "f32":
        np.testing.assert_allclose(x, jfinal["params"], rtol=0, atol=1e-5)
    else:
        from test_torch_wire_trajectory import FLIP_SHARE, QUANTA, _quantum
        w_max = max(t.weight for t in ring(A).terms)
        err = np.abs(x - jfinal["params"])
        assert (err <= QUANTA * _quantum(jfinal["params"], wire, w_max)
                + 1e-5).all(), name
        assert (err > 1e-5).mean() <= FLIP_SHARE, name


@pytest.mark.parametrize("name", list(RUNS))
def test_gossip_collectives_match_the_wire_model(results, name):
    _, _, _, _, recs = results
    A, B, S, wire = RUNS[name]
    ran = [r[name] for r in recs if name in r]
    assert len(ran) == A // B * S
    n_terms = sum(1 for t in ring(A).terms if t.shift != 0)
    assert sum(r["gossip_bytes"] for r in ran) == ran[0]["model_bytes"]
    for r in ran:
        assert not any(p[3] for p in r["permutes"]), "fed by an all-gather"
        if S > 1:
            # the port's counterpart of the reference's HLO pin: one
            # shard-local (1, shard_rows, 128) f32 permute a term
            assert r["permutes"] == [
                ["collective-permute", [1, r["shard_rows"], 128],
                 "torch.float32", False]] * n_terms
            assert r["kinds"]["all-gather"] == 2   # the forward, the losses


def test_pod_checkpoints_gathered_and_sharded(results):
    d, jax_runs, port_runs, arrays, recs = results
    model = build_model(ModelConfig(**CFG))
    # sharded → gathered: the pod run's file loads into the one-process
    # (shards 1) state, equal to the one-process run's
    final = port_runs[(2, "f32")][2]
    like = init_state(model, RunConfig(**_run_kw(2, "f32"),
                                       agents_per_device=2), 2,
                      device="cpu")
    got = checkpoint.load_state(str(d / "pod.npz"), like,
                                layout=bus_layout_for(model, 2))
    assert got["step"] == STEPS
    for k, v in _bufs(final).items():
        assert torch.equal(_bufs(got)[k], v), k
    # gathered → sharded: the JAX package's file restored into the row
    # shards equals the JAX final state, leaf by leaf
    jfinal = jax_runs[(2, "f32")][2]
    assert all(r.get("restored_step") == STEPS for r in recs)
    for k in ("x", "m", "psi"):
        blocks = [a[f"restored|{k}"] for a in arrays]
        bus = np.concatenate([np.concatenate(blocks[0:2], 1),
                              np.concatenate(blocks[2:4], 1)], 0)
        want = jfinal["params"] if k == "x" else jfinal["opt"][k]
        lg, lw = _leaves(bus, 2, 2), _leaves(np.asarray(want), 2, 1)
        for p in lw:
            assert torch.equal(lg[p], lw[p]), (k, p)
    # the data run's gathered file is the one-process run's, array by array
    with np.load(d / "data4.npz") as a, np.load(d / "port_data4.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert np.array_equal(a[f], b[f]), f
