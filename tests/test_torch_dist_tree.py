"""The tree path across ranks (``build_train_step(mesh=)`` with
``packed_bus=False``): every algorithm of ``ALGORITHMS`` with one agent
block a rank, against the port's one-process tree step and the JAX
package's multi-device tree step.

``tests/test_torch_dist_train.py``'s tiny dense model (one layer, d_model
32, f32), and a bf16 variant of it for EDM; fused kernels (their plain
versions on the CPU), 3 steps on seeded tokens, every run from the JAX
package's tree ``init_state`` (each rank its block, through
:func:`repro_torch.weights.rank_state_from_arrays`).  One module fixture
spawns 4 gloo ranks (a ``file://`` rendezvous) that run:

* all nine algorithms, 4 ranks × 1 agent, ring, static (and EDM in bf16);
* edm, dsgt and qg blocked: 2 ranks × 2 agents (ranks 2–3 are outside that
  mesh);
* edm and dsgt on ``round_robin`` over ``exp``;
* edm with agent 3 down at step 1 (one masked churn round);
* dsgd with ``gossip_every=2``; dmsgd with a bf16 ``gossip_dtype`` cast
  and the ``warmup_cosine`` LR schedule;
* the 4 × 1 EDM run saved after 2 steps (gathered to rank 0) and resumed
  on 2 ranks × 2 agents for its third step.

Beside them one JAX subprocess on 4 host devices runs the reference's
multi-device tree step (``make_gossip_mesh``, ``packed_bus=False``,
ppermute) for edm, dsgt and qg at B = 1 and B = 2.

Checks: per-agent losses, every leaf of x and of each optimizer slot
bit-equal to the port's one-process tree run; against the JAX step the
tolerances of ``tests/test_torch_tree_train.py`` (metrics rtol 1e-5, the
state atol 1e-5); the collective record: one permute per leaf per
nonzero-shift term a mix (none on a step that ``gossip_every`` skips);
the saved file equal to the one-process state's file, and the resumed
run bit-equal to the unbroken one.
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
from repro_torch.core.elastic import DropPlan
from repro_torch.core.optimizers import ALGORITHMS
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, checkpoint,
                               make_gossip_schedule)

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD, SEQ, STEPS, VOCAB, A = 4, 8, 3, 64, 4
CFG = dict(name="dist-tiny", family="dense", n_layers=1, d_model=32,
           n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=VOCAB,
           dtype="float32")
CHURN = {"n_agents": 4, "epochs": [{"start": 0, "down": []},
                                   {"start": 1, "down": [3]},
                                   {"start": 2, "down": []}]}
# gossip mixes a step of each algorithm (dsgt and dsgt_hb mix y and x)
MIXES = {alg: 2 if alg.startswith("dsgt") else 1 for alg in ALGORITHMS}
# run: algorithm, agents a rank, model dtype, RunConfig overrides, churn,
# held against the JAX step
RUNS = {f"{alg}-B1": (alg, 1, "float32", {}, False, alg in ("edm", "dsgt",
                                                             "qg"))
        for alg in ALGORITHMS}
RUNS.update({
    "edm-bf16-B1": ("edm", 1, "bfloat16", {}, False, False),
    "edm-B2": ("edm", 2, "float32", {}, False, True),
    "dsgt-B2": ("dsgt", 2, "float32", {}, False, True),
    "qg-B2": ("qg", 2, "float32", {}, False, True),
    "edm-rr-B1": ("edm", 1, "float32", dict(topology="exp",
                                            gossip_schedule="round_robin"),
                  False, False),
    "dsgt-rr-B1": ("dsgt", 1, "float32", dict(topology="exp",
                                              gossip_schedule="round_robin"),
                   False, False),
    "edm-churn-B1": ("edm", 1, "float32", {}, True, False),
    "dsgd-every2-B1": ("dsgd", 1, "float32", dict(gossip_every=2), False,
                       False),
    "dmsgd-cast-lr-B1": ("dmsgd", 1, "float32",
                         dict(gossip_dtype="bfloat16", warmup_steps=2,
                              total_steps=3), False, False),
})
SAVED_AT = 2          # the edm-B1 run is saved after this many steps


def _cfg(name):
    return {**CFG, "dtype": RUNS[name][2]}


def _run_kw(name, one_process=False):
    alg, B, _, extra, _, _ = RUNS[name]
    return dict(global_batch=A, seq_len=SEQ, algorithm=alg, alpha=0.2,
                beta=0.9, gossip_engine="ppermute", remat=False,
                packed_bus=False, agents_per_device=A if one_process else B,
                **extra)


def _sched(name, run):
    return make_gossip_schedule(run, A, churn=DropPlan.from_json(CHURN)
                                if RUNS[name][4] else None)


def _tokens():
    rng = np.random.default_rng(A)
    return [rng.integers(0, VOCAB, (A, 1, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _flat(state):
    """A tree state's leaves as ``{"x|path" / "<slot>|path": tensor}``."""
    out = {f"x|{p}": v for p, v in state["params"].items()}
    for slot, tree in state["opt"].items():
        out.update({f"{slot}|{p}": v for p, v in tree.items()})
    return out


def _arrays(npz):
    """The JAX init saved as a logical npz, as the numpy tree state that
    :func:`weights.rank_state_from_arrays` takes."""
    state = {"params": {}, "opt": {}, "step": 0}
    with np.load(npz) as data:
        for k in data.files:
            top, _, rest = k.partition("|")
            if top == "params":
                state["params"][rest] = data[k]
            elif top == "opt":
                slot, _, path = rest.partition("|")
                state["opt"].setdefault(slot, {})[path] = data[k]
    return state


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    meshes = {B: make_gossip_mesh(A, agents_per_device=B) for B in (1, 2)}
    out, rec = {}, {}
    toks = [torch.from_numpy(t) for t in _tokens()]
    for name, (alg, B, *_) in RUNS.items():
        mesh = meshes[B]
        if not mesh.member:
            continue
        model = build_model(ModelConfig(**_cfg(name)))
        run = RunConfig(**_run_kw(name))
        step = build_train_step(model, run, _sched(name, run),
                                use_fused_kernel=True, device="cpu",
                                mesh=mesh)
        a0, B, _, _ = rank_block(mesh, A)
        state = weights.rank_state_from_arrays(
            _arrays(f"{d}/init-{name}.npz"), a0, B)
        losses, metrics, permutes = [], [], []
        for t, tk in enumerate(toks):
            with comm.recording() as log:
                state, m = step(state, {"tokens": tk})
            losses.append(m["agent_losses"].tolist())
            metrics.append({k: float(m[k]) for k in ("loss", "consensus",
                                                     "grad_norm")})
            permutes.append([list(c.shape) for c in log
                             if c.kind == "collective-permute"
                             and c.tag == "gossip"])
            if name == "edm-B1" and t + 1 == SAVED_AT:
                checkpoint.save_state_ranks(f"{d}/saved.npz", state, None,
                                            mesh, A)
        for k, v in _flat(state).items():
            out[f"{name}|{k}"] = v.float().numpy()
            out[f"{name}|bits|{k}"] = v.view(torch.int16).numpy() \
                if v.dtype == torch.bfloat16 else v.numpy()
        rec[name] = {"losses": losses, "metrics": metrics, "block": [a0, B],
                     "permutes": permutes}
    # the saved 4 × 1 run resumed on 2 ranks × 2 agents for its last step
    dist.barrier()
    mesh = meshes[2]
    if mesh.member:
        model = build_model(ModelConfig(**_cfg("edm-B2")))
        run = RunConfig(**_run_kw("edm-B2"))
        step = build_train_step(model, run, _sched("edm-B2", run),
                                use_fused_kernel=True, device="cpu",
                                mesh=mesh)
        like = weights.rank_state_from_arrays(
            _arrays(f"{d}/init-edm-B2.npz"), *rank_block(mesh, A)[:2])
        state = checkpoint.load_state_ranks(f"{d}/saved.npz", like, None,
                                            mesh, A)
        rec["resumed_step"] = state["step"]
        for tk in toks[state["step"]:]:
            state, m = step(state, {"tokens": tk})
        for k, v in _flat(state).items():
            out[f"resumed|bits|{k}"] = v.numpy()
        rec["resumed"] = {"block": list(rank_block(mesh, A)[:2])}
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


_JAX_CODE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs.base import ModelConfig, RunConfig
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model
from repro.train import build_train_step, init_state, make_gossip_schedule

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
model = build_model(ModelConfig(**spec["cfg"]))
for name, r in spec["runs"].items():
    A = r["run"]["global_batch"]
    run = RunConfig(**r["run"])
    mesh = make_gossip_mesh(A, agents_per_device=r["run"]["agents_per_device"])
    step = jax.jit(build_train_step(model, run, make_gossip_schedule(run, A),
                                    mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    state = init_state(model, run, A, jax.random.PRNGKey(0))
    rng = np.random.default_rng(A)
    toks = [rng.integers(0, spec["cfg"]["vocab_size"], (A, 1, r["run"][
        "seq_len"])).astype(np.int32) for _ in range(spec["steps"])]
    metrics = []
    for t in toks:
        state, m = step(state, {"tokens": t})
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {}
    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}|{k}" if prefix else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}|{i}" if prefix else str(i))
        else:
            flat[prefix] = np.asarray(node, dtype=np.float32)
    walk(state["params"], "x")
    for slot, tree in state["opt"].items():
        walk(tree, slot)
    np.savez(f"{d}/jax-{name}.npz", **flat)
    json.dump(metrics, open(f"{d}/jax-{name}.json", "w"))
print("JAX_TREE_OK")
"""


def _jax_init(name):
    """The JAX package's tree ``init_state`` as the port's one-process
    state (bf16 bits exact)."""
    import jax
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models import build_model as jbuild_model
    from repro.train import init_state as jinit_state
    jrun = JRunConfig(**_run_kw(name, one_process=True))
    state = jinit_state(jbuild_model(JModelConfig(**_cfg(name))), jrun, A,
                        jax.random.PRNGKey(0))
    return weights.train_state_from_arrays(jax.tree.map(np.asarray, state))


def _port_run(name, init):
    """The port's one-process fused tree run from the JAX init: per-agent
    losses, metrics, the final leaves; the state after ``SAVED_AT`` steps
    saved beside it for the edm run."""
    model = build_model(ModelConfig(**_cfg(name)))
    run = RunConfig(**_run_kw(name, one_process=True))
    step = build_train_step(model, run, _sched(name, run),
                            use_fused_kernel=True, device="cpu")
    from repro_torch.train import trainer
    seen, inner = [], trainer.tree_losses_and_grads

    def spy(*a, **k):
        losses, g = inner(*a, **k)
        seen.append(losses.tolist())
        return losses, g

    trainer.tree_losses_and_grads = spy
    state, metrics, saved = init, [], None
    try:
        for t, tk in enumerate(_tokens()):
            state, m = step(state, {"tokens": torch.from_numpy(tk)})
            metrics.append({k: float(v) for k, v in m.items()})
            if t + 1 == SAVED_AT:
                saved = state
    finally:
        trainer.tree_losses_and_grads = inner
    return seen, metrics, _flat(state), saved


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_tree")
    inits = {}
    for name in RUNS:
        inits[name] = _jax_init(name)
        checkpoint.save_state(str(d / f"init-{name}.npz"), inits[name])
    spec = {"cfg": CFG, "steps": STEPS, "runs": {
        name: {"run": _run_kw(name)} for name, r in RUNS.items() if r[5]}}
    (d / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    t0 = time.time()
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CODE, str(d / "spec.json"), str(d)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ctx = mp.spawn(_rank_worker, args=(WORLD, str(d)), nprocs=WORLD,
                   join=False)
    port = {}
    for name in RUNS:
        port[name] = _port_run(name, inits[name])
        if name == "edm-B1":
            checkpoint.save_state(str(d / "port-saved.npz"), port[name][3])
    deadline = time.time() + 240
    while not ctx.join(timeout=2):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            jax_proc.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    ranks_s = time.time() - t0
    out_j, err_j = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, out_j[-2000:] + err_j[-3000:]
    arrays = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    jax_runs = {name: (json.loads((d / f"jax-{name}.json").read_text()),
                       dict(np.load(d / f"jax-{name}.npz")))
                for name in spec["runs"]}
    print(f"ranks {ranks_s:.1f} s, the JAX subprocess "
          f"{time.time() - t0:.1f} s")
    return d, port, jax_runs, arrays, recs


def _assemble(arrays, recs, key, name):
    """A run's ``(A, ...)`` leaf from its ranks' agent blocks."""
    blocks = sorted((r[name]["block"][0], a[key])
                    for a, r in zip(arrays, recs) if name in r)
    return np.concatenate([b for _, b in blocks], 0)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_tree_run_bit_equal_to_one_process(results, name):
    _, port, _, arrays, recs = results
    seen, metrics, final, _ = port[name]
    ran = [r for r in recs if name in r]
    assert len(ran) == A // RUNS[name][1]
    for r in ran:
        assert r[name]["losses"] == seen, name
        for t, (got, want) in enumerate(zip(r[name]["metrics"], metrics)):
            assert got["loss"] == want["loss"], (name, t)
            np.testing.assert_allclose(got["consensus"], want["consensus"],
                                       rtol=1e-5, err_msg=f"{name} {t}")
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5, err_msg=f"{name} {t}")
    assert sorted(final) == sorted(k[len(name) + 6:] for k in arrays[0]
                                   if k.startswith(f"{name}|bits|"))
    for k, want in final.items():
        got = _assemble(arrays, recs, f"{name}|bits|{k}", name)
        assert np.array_equal(got, _bits(want)), (name, k)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items() if r[5]])
def test_rank_tree_run_matches_jax_multi_device_step(results, name):
    _, _, jax_runs, arrays, recs = results
    jmetrics, jfinal = jax_runs[name]
    r0 = next(r for r in recs if name in r)
    for t, (got, want) in enumerate(zip(r0[name]["metrics"], jmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"{name} step {t} {key}")
    assert sorted(jfinal) == sorted(k[len(name) + 1:] for k in arrays[0]
                                    if k.startswith(f"{name}|")
                                    and "|bits|" not in k)
    for k, want in jfinal.items():
        got = _assemble(arrays, recs, f"{name}|{k}", name)
        assert np.all(np.abs(got - want) <= 1e-5), (name, k)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items()
                                  if r[1] == 1 and not r[4]])
def test_one_permute_per_leaf_per_term_a_mix(results, name):
    """The reference's per-leaf plan at one agent a rank: each mix ships
    every leaf once per nonzero-shift term of its round, shaped as the
    leaf's block; a step that ``gossip_every`` skips ships nothing."""
    _, port, _, _, recs = results
    alg, _, _, extra, _, _ = RUNS[name]
    final = port[name][2]
    leaves = sorted([1] + list(v.shape[1:]) for k, v in final.items()
                    if k.startswith("x|"))
    run = RunConfig(**_run_kw(name))
    sched = _sched(name, run)
    every = extra.get("gossip_every", 1)
    for r in recs:
        for t, got in enumerate(r[name]["permutes"]):
            if every > 1 and t % every != every - 1:
                assert got == [], (name, t)
                continue
            topo = sched.round(t // every if every > 1 else t)
            n_terms = sum(1 for term in topo.terms if term.shift % A)
            want = sorted(leaves * (n_terms * MIXES[alg]))
            assert sorted(got) == want, (name, t, len(got), len(want))


def test_saved_on_four_ranks_resumes_on_two_by_two(results):
    d, port, _, arrays, recs = results
    # the gathered file is the one-process state's, array by array
    with np.load(d / "saved.npz") as a, np.load(d / "port-saved.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert np.array_equal(a[f], b[f]), f
    ran = [r for r in recs if "resumed" in r]
    assert len(ran) == 2 and all(r["resumed_step"] == SAVED_AT for r in ran)
    final = port["edm-B1"][2]
    for k, want in final.items():
        blocks = sorted((r["resumed"]["block"][0], a[f"resumed|bits|{k}"])
                        for a, r in zip(arrays, recs) if "resumed" in r)
        got = np.concatenate([b for _, b in blocks], 0)
        assert np.array_equal(got, _bits(want)), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tree_payload_combine_bit_equal_to_per_leaf_combine(dtype):
    """The packed route's arithmetic through the plain versions: a ragged
    tree (NaN and ±Inf in it) packed into one f32 payload a rank, one ring
    or table combine over the payloads, unpacked — bit-equal to
    ``gossip_axpy`` a leaf on the rolled leaves, the one-process fused
    combine; a tree of B > 1 agents is no peer payload."""
    from repro_torch.core.mixing import TreePayload, _payload_unfit
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(5)
    shapes = {"a|w": (7, 33), "b|bias": (5,), "c|emb": (129, 3)}
    full = {}
    for p, shape in shapes.items():
        v = torch.randn((A,) + shape, generator=gen)
        v.view(-1)[::37] = float("nan")
        v.view(-1)[5::41] = float("inf")
        v.view(-1)[9::43] = float("-inf")
        full[p] = v.to(dtype)
    mine = [{p: v[a:a + 1] for p, v in full.items()} for a in range(A)]
    packer = TreePayload(mine[0])
    pays = [packer.pack(t, torch.full(packer.shape, float("nan")))
            for t in mine]
    terms = [(0, 1 / 3), (1, 1 / 3), (-1, 1 / 3)]
    src_w = [(0, 0.5), (2, 0.25), (0, 0.25)]    # a table column, slot order
    for a in range(A):
        assert _payload_unfit(mine[a]) == ""
        got = packer.unpack(ref.ring_peer_ref(
            pays[a], pays[(a - 1) % A], pays[(a + 1) % A], terms, A), mine[a])
        got_t = packer.unpack(ref.table_peer_ref(
            pays, [(a + s) % A for s, _ in src_w], [w for _, w in src_w]),
            mine[a])
        for p, v in full.items():
            want = ref.gossip_axpy_ref(
                [torch.roll(v, s, 0)[a:a + 1] for s, _ in terms],
                [w for _, w in terms])
            want_t = ref.gossip_axpy_ref(
                [v[(a + s) % A][None] for s, _ in src_w],
                [w for _, w in src_w])
            for g, w in ((got[p], want), (got_t[p], want_t)):
                assert g.dtype == dtype and g.shape == w.shape
                assert torch.equal(_bits_t(g), _bits_t(w)), p
    assert "one agent's" in _payload_unfit(full)


def _bits_t(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, every NaN as one NaN (NaN matches NaN)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)
