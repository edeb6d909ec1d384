"""The tree train path under tensor parallelism (the reference's
``state_specs`` / ``prepend_agent_axis`` / ``batch_spec_tree``: agents
over ``data``, each agent's leaves over ``model``) on a ``(2, 2)``
``("data", "model")`` rank grid, against the JAX package.

Two small f32 dense variants made by ``dataclasses.replace``:
``qwen3_14b``'s (QK norm, SwiGLU) and ``starcoder2_7b``'s (QKV bias, the
GELU MLP), 2 layers, d 32, 4 / 2 heads of 8, FFN 64, vocabulary 64.
Their weights are the reference's ``init_lm`` (its zero leaves drawn
nonzero with numpy, so that the norms' and biases' splits show), carried
to the port.

* The spec trees against the reference's for every config, mode,
  algorithm and layout, in this process; the raises.
* One module fixture spawns 4 gloo ranks (a ``file://`` rendezvous) and,
  beside them, one JAX subprocess on 4 host devices (``AxisType.Auto``)
  that jits the reference's tree ``build_train_step`` with
  ``in_shardings`` from ``state_specs`` / ``batch_spec_tree`` on a
  ``(2, 2)`` mesh (the dry run's layout) and ``jax.value_and_grad`` of
  one agent's loss with its leaves sharded by ``lm_param_specs``; and
  the train CLI under torchrun on 4 ranks (a ``(2, 2)`` grid) beside the
  one-process CLI.  The ranks hold one agent's loss and gradient blocks,
  3-step trajectories of EDM (fused: its plain version on the CPU), DSGT
  and DSGD at one agent a data rank and of EDM at two, to the sharded
  reference (f32: rtol / atol 1e-5) and to the port's own ``(2, 1)`` tree
  run across ranks (the same tolerance; its consensus and gradient norm
  too), the replicated leaves bit-equal across the model ranks, and the
  collectives a step beside the reference's compiled HLO.
"""
import dataclasses
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

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.optimizers import ALGORITHMS
from repro_torch.core.sharding import P, shard_params
from repro_torch.models import build_model
from repro_torch.train import trainer

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD, SEQ, STEPS = 4, 8, 3
SHAPE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
             d_ff=64, vocab_size=64, dtype="float32")
ARCHS = ("qwen3_14b", "starcoder2_7b")
# run: arch, algorithm, agents a data rank (A = 2 B on the (2, 2) grid)
RUNS = {"qwen-edm-B1": ("qwen3_14b", "edm", 1),
        "qwen-dsgt-B1": ("qwen3_14b", "dsgt", 1),
        "qwen-dsgd-B1": ("qwen3_14b", "dsgd", 1),
        "star-edm-B1": ("starcoder2_7b", "edm", 1),
        "star-edm-B2": ("starcoder2_7b", "edm", 2)}
TOL = dict(rtol=1e-5, atol=1e-5)
# the reference's compiled HLO collectives (count_collectives): of one
# agent's value_and_grad and of a train step on the (2, 2) mesh
HLO_GRAD = {"qwen3_14b": {"all-reduce": 9}, "starcoder2_7b": {"all-reduce": 9}}
HLO_STEP = {"qwen-edm-B1": {"all-reduce": 19, "collective-permute": 14},
            "qwen-dsgt-B1": {"all-reduce": 19, "collective-permute": 28},
            "qwen-dsgd-B1": {"all-reduce": 19, "collective-permute": 14},
            "star-edm-B1": {"all-reduce": 17, "collective-permute": 14},
            "star-edm-B2": {"all-reduce": 17, "collective-permute": 28}}
# the leaves every model rank holds whole
REPLICATED = ("final_ln", "|ln", "q_norm", "k_norm")


def small_config(arch):
    return dataclasses.replace(get_config(arch), **SHAPE)


def _run_kw(name, grid=True):
    _, alg, B = RUNS[name]
    return dict(global_batch=2 * B, seq_len=SEQ, algorithm=alg, alpha=0.2,
                beta=0.9, gossip_engine="ppermute" if grid else "shifts",
                packed_bus=False, agents_per_device=B)


def _tokens(name):
    """``STEPS`` batches of ``(A, 1, SEQ)`` tokens."""
    A = 2 * RUNS[name][2]
    rng = np.random.default_rng(len(name))
    return [rng.integers(0, SHAPE["vocab_size"], (A, 1, SEQ)).astype(
        np.int32) for _ in range(STEPS)]


def _grad_tokens():
    return np.random.default_rng(5).integers(
        0, SHAPE["vocab_size"], (2, SEQ)).astype(np.int32)


def _reference_weights(arch, path):
    """The reference's ``init_lm`` of the small variant, its zero leaves
    (norms, biases) drawn from a seeded normal, saved flat by path."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models.transformer import init_lm
    from repro_torch.weights import _walk
    jcfg = dataclasses.replace(jget_config(arch), **SHAPE)
    flat = {}
    _walk(jax.tree.map(np.asarray, init_lm(jcfg, jax.random.PRNGKey(0))), "",
          flat)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if not np.any(v):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    np.savez(path, **flat)


def _replicated(path):
    return any(path.endswith(r) for r in REPLICATED)


def _counts(log):
    out = {}
    for c in log:
        key = f"{c.tag} {c.kind}"
        out[key] = out.get(key, 0) + 1
    return out


def _flat_state(state):
    out = {f"x|{p}": v for p, v in state["params"].items()}
    for slot, tree in state["opt"].items():
        out.update({f"{slot}|{p}": v for p, v in tree.items()})
    return out


def _grads(model, params, tokens, enter=None):
    """One agent's loss and gradient dict at ``params`` (remat on);
    ``enter`` replaces ``TensorParallel.enter`` for the call."""
    from repro_torch.core.sharding import TensorParallel
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    orig = TensorParallel.enter
    if enter is not None:
        TensorParallel.enter = enter
    try:
        loss = model.loss(leaves, {"tokens": torch.from_numpy(tokens)})
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        TensorParallel.enter = orig
    return float(loss), dict(zip(leaves, grads))


def _shard_state(state, specs, mesh):
    """This rank's block of a one-process tree state under
    ``state_specs`` (what ``jax.device_put`` with those specs puts on
    the rank)."""
    from repro_torch.core.sharding import leaf_block, mesh_coords
    coords = mesh_coords(mesh)

    def cut(tree, tree_specs):
        return {p: leaf_block(v, tree_specs[p], coords, p)
                for p, v in tree.items()}

    return {"params": cut(state["params"], specs["params"]),
            "opt": {k: cut(v, specs["opt"][k])
                    for k, v in state["opt"].items()}}


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.comm import rank_block
    from repro_torch.core.sharding import TensorParallel
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    from repro_torch.train import build_train_step, init_state, \
        make_gossip_schedule
    from repro_torch.weights import params_from_npz
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    tp = {B: make_gossip_mesh(2 * B, agents_per_device=B, model=2)
          for B in (1, 2)}
    flat = {B: make_gossip_mesh(2 * B, agents_per_device=B) for B in (1, 2)}
    out, rec = {}, {"coords": list(tp[1].coords)}
    enter = TensorParallel.enter
    # (ii) one agent's loss and gradient blocks, and the two failure modes
    variants = {"": None,
                # (a) no sum of the normed inputs' cotangents
                "no_sum_h": lambda self, t: t if t.dim() > 1
                else enter(self, t),
                # (b) no sum of q_norm's / k_norm's gradients
                "no_sum_qk": lambda self, t: t if t.dim() == 1
                else enter(self, t)}
    for arch in ARCHS:
        model = build_model(small_config(arch), mesh=tp[1])
        full = params_from_npz(f"{d}/{arch}.npz")
        blocks = shard_params(full, model.param_specs(), tp[1])
        for tag, fn in variants.items():
            if tag == "no_sum_qk" and not model.cfg.qk_norm:
                continue
            with comm.recording() as log:
                loss, g = _grads(model, blocks, _grad_tokens(), fn)
            rec[f"{arch}|loss{tag}"] = loss
            if not tag:
                rec[f"{arch}|grad_collectives"] = _counts(log)
            out.update({f"{arch}|grad{tag}|{k}": v.numpy()
                        for k, v in g.items()})
    # (iii)-(vi) trajectories on the (2, 2) grid and the (2, 1) one
    for name, (arch, alg, B) in RUNS.items():
        full = params_from_npz(f"{d}/{arch}.npz")
        model = build_model(small_config(arch))
        toks = [torch.from_numpy(t) for t in _tokens(name)]
        for grid, mesh in (("tp", tp[B]), ("flat", flat[B])):
            if not mesh.member:
                continue
            run = RunConfig(**_run_kw(name))
            step = build_train_step(model, run,
                                    make_gossip_schedule(run, 2 * B),
                                    use_fused_kernel=True, device="cpu",
                                    mesh=mesh)
            state = init_state(model, run, 2 * B, params=full, mesh=mesh,
                               device="cpu")
            r = {"block": list(rank_block(mesh, 2 * B)[:2]), "metrics": [],
                 "collectives": []}
            for tk in toks:
                with comm.recording() as log:
                    state, m = step(state, {"tokens": tk})
                r["metrics"].append({k: float(m[k]) for k in
                                     ("loss", "consensus", "grad_norm")})
                r.setdefault("agent_losses", []).append(
                    m["agent_losses"].tolist())
                r["collectives"].append(_counts(log))
            out.update({f"{name}|{grid}|{k}": v.numpy()
                        for k, v in _flat_state(state).items()})
            rec[f"{name}|{grid}"] = r
    # the rank-local init (init_lm_rank under state_specs) against the
    # one-process init cut by shard_state
    model = build_model(small_config("qwen3_14b"))
    run = RunConfig(**_run_kw("qwen-dsgt-B1"))
    local = init_state(model, run, 2, seed=3, mesh=tp[1], device="cpu")
    whole = _shard_state(init_state(model, run, 2, seed=3, device="cpu"),
                         trainer.state_specs(model, run, False), tp[1])
    a, b = _flat_state(local), _flat_state(whole)
    rec["rank_init_equal"] = sorted(a) == sorted(b) and all(
        torch.equal(a[k], b[k]) for k in a)
    rec["rank_init_shapes"] = {k: list(v.shape) for k, v in a.items()
                               if k.startswith("x|")}
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


_JAX_CODE = """
import dataclasses, json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.launch.hlo_analysis import count_collectives
from repro.models.api import build_model
from repro.train.trainer import (batch_spec_tree, build_train_step,
                                 init_state, make_gossip_schedule,
                                 state_specs)

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out, hlo = {}, {}


def shardings(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda s: isinstance(s, P))


def walk(node, prefix, flat):
    if isinstance(node, dict):
        for k, v in node.items():
            walk(v, f"{prefix}|{k}" if prefix else str(k), flat)
    elif isinstance(node, (tuple, list)):
        for i, v in enumerate(node):
            walk(v, f"{prefix}|{i}" if prefix else str(i), flat)
    else:
        flat[prefix] = np.asarray(node, dtype=np.float32)


def ops(text):
    got = []
    for line in text.splitlines():
        for kind in ("all-reduce", "all-gather", "all-to-all",
                     "collective-permute", "reduce-scatter"):
            if re.search(r"\\s%s(-start)?\\(" % kind, line):
                got.append(kind)
    return sorted(got)


def load(arch):
    cfg = dataclasses.replace(get_config(arch), **spec["shape"])
    model = build_model(cfg)
    like = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    a = dict(np.load(f"{d}/{arch}.npz"))
    flat, tdef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["|".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in flat]
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(a[k]) for k in keys])
    return model, params


for arch in spec["archs"]:
    model, params = load(arch)
    pspecs = model.param_specs()
    toks = jnp.asarray(np.load(f"{d}/grad_tokens.npy"))
    p_sh, t_sh = shardings(pspecs), NamedSharding(mesh, P())
    params, toks = jax.device_put(params, p_sh), jax.device_put(toks, t_sh)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t: model.loss(p, {"tokens": t}, remat=True)),
        in_shardings=(p_sh, t_sh)).lower(params, toks).compile()
    loss, g = fn(params, toks)
    flat = {}
    walk(g, "", flat)
    out.update({f"{arch}|grad|{k}": v for k, v in flat.items()})
    out[f"{arch}|loss"] = np.float32(loss)
    hlo[f"{arch}|grad"] = count_collectives(fn.as_text())

for name, r in spec["runs"].items():
    arch, A = r["arch"], r["run"]["global_batch"]
    model, params = load(arch)
    model = dataclasses.replace(model, init=lambda key: params)
    run = RunConfig(**r["run"])
    step = build_train_step(model, run, make_gossip_schedule(run, A))
    state = init_state(model, run, A, jax.random.PRNGKey(0))
    st_sh = shardings(state_specs(model, run, False))
    b_sh = shardings(batch_spec_tree(model, run, False))
    toks = np.load(f"{d}/tokens-{name}.npy")
    batches = [jax.device_put({"tokens": jnp.asarray(t)}, b_sh)
               for t in toks]
    state = jax.device_put(state, st_sh)
    jstep = jax.jit(step, in_shardings=(st_sh, b_sh)).lower(
        state, batches[0]).compile()
    metrics = []
    for b in batches:
        state, m = jstep(jax.device_put(state, st_sh), b)
        metrics.append({k: float(v) for k, v in m.items()})
    flat = {}
    walk(state["params"], "x", flat)
    for slot, tree in state["opt"].items():
        walk(tree, slot, flat)
    np.savez(f"{d}/jax-{name}.npz", **flat)
    text = jstep.as_text()
    hlo[name] = {"counts": count_collectives(text), "ops": ops(text)}
    json.dump(metrics, open(f"{d}/jax-{name}.json", "w"))
np.savez(f"{d}/jax.npz", **out)
json.dump(hlo, open(f"{d}/jax-hlo.json", "w"))
print("JAX_TP_TRAIN_OK")
"""

CLI = ["--arch", "qwen3_14b", "--smoke", "--agents", "2", "--gossip-engine",
       "ppermute", "--fused-kernel", "--steps", "2", "--seq", "16",
       "--device", "cpu"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from repro_torch.launch import train as train_cli
    d = tmp_path_factory.mktemp("tp_train")
    for arch in ARCHS:
        _reference_weights(arch, d / f"{arch}.npz")
    np.save(d / "grad_tokens.npy", _grad_tokens())
    for name in RUNS:
        np.save(d / f"tokens-{name}.npy", np.stack(_tokens(name)))
    spec = {"archs": ARCHS, "shape": SHAPE, "runs": {
        name: {"arch": arch, "run": _run_kw(name, grid=False)}
        for name, (arch, _, _) in RUNS.items()}}
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
    deadline = time.time() + 240
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            jax_proc.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    ranks_s = time.time() - t0
    # the train CLI under torchrun on a (2, 2) grid, and in one process,
    # once the ranks are done
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *CLI],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    one = train_cli.main(CLI + ["--agents-per-device", "2",
                                "--no-packed-bus"])
    out_c, err_c = cli.communicate(timeout=180)
    assert cli.returncode == 0, out_c[-2000:] + err_c[-3000:]
    out_j, err_j = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, out_j[-2000:] + err_j[-3000:]
    print(f"ranks {ranks_s:.1f} s, the CLIs and the JAX subprocess "
          f"{time.time() - t0:.1f} s")
    return {"jax": dict(np.load(d / "jax.npz")),
            "hlo": json.loads((d / "jax-hlo.json").read_text()),
            "jax_runs": {n: (json.loads((d / f"jax-{n}.json").read_text()),
                             dict(np.load(d / f"jax-{n}.npz")))
                         for n in RUNS},
            "ranks": [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)],
            "recs": [json.loads((d / f"rank{r}.json").read_text())
                     for r in range(WORLD)],
            "cli": out_c, "one": one}


# ---------------------------------------------------------------------------
# (i) the specs, and the raises
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """A spec tree (the port's or the reference's) as ``{path: tuple of
    entries}``."""
    from jax.sharding import PartitionSpec as JP
    if isinstance(tree, (P, JP)):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}|{k}" if prefix else str(k)))
    return out


def _spec_runs():
    """(agents, packed_bus, extra) layouts: the tree in both agent modes,
    the bus in both, with the wire and the overlap on it."""
    yield "data", False, {}
    yield "pod", False, {}
    yield "data", True, {}
    yield "pod", True, {}
    yield "data", True, {"wire": "int8", "overlap": "delayed"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_equal_reference(arch):
    """``state_specs`` (every algorithm's slots on the tree, the bus with
    its residual and pipeline), ``batch_spec_tree`` and
    ``prepend_agent_axis`` equal the reference's path by path for every
    config of ``all_configs()``, both agent modes, ``multi_pod`` on and
    off; the encoder-decoder family's tree raises
    ``NotImplementedError``, as its ``lm_param_specs`` does (its bus
    specs need no param specs, as the reference's)."""
    from repro.configs import get_config as jget_config
    from repro.configs.base import RunConfig as JRunConfig
    from repro.models.api import build_model as jbuild
    from repro.train import trainer as jtrainer
    jmodel, model = jbuild(jget_config(arch)), build_model(get_config(arch))
    for agents, bus, extra in _spec_runs():
        algs = ("edm",) if bus else ALGORITHMS
        for alg in algs:
            kw = dict(agents=agents, algorithm=alg, packed_bus=bus,
                      gossip_engine="ppermute", **extra)
            run, jrun = RunConfig(**kw), JRunConfig(**kw)
            for mp_ in (False, True):
                want_b = jtrainer.batch_spec_tree(jmodel, jrun, mp_)
                assert _flat(trainer.batch_spec_tree(model, run, mp_)) \
                    == _flat(want_b)
                if not bus and model.cfg.family == "encdec":
                    with pytest.raises(NotImplementedError, match="8.2"):
                        trainer.state_specs(model, run, mp_)
                    continue
                want = jtrainer.state_specs(jmodel, jrun, mp_)
                got = trainer.state_specs(model, run, mp_)
                assert _flat(got) == _flat(want), (agents, bus, alg, mp_)
    if model.cfg.family == "encdec":
        return
    for path, s in model.param_specs().items():
        js = tuple(s)
        for axis, fsdp in (("data", None), (("pod", "data"), None),
                           (None, "data"), ("pod", "data")):
            want = jtrainer.prepend_agent_axis(
                __import__("jax").sharding.PartitionSpec(*js), axis, fsdp)
            got = trainer.prepend_agent_axis(s, axis, fsdp)
            assert tuple(got) == tuple(want), (path, axis, fsdp)
            assert got.groups == s.groups


def _raising_case(case):
    """(the call that raises, the exception, the message's pattern)."""
    from repro_torch.core.comm import GossipMesh
    from repro_torch.launch import train as train_cli
    grid = GossipMesh((2, 2), ("data", "model"), 2, 1, 1, 0, (0, 0),
                      ((0, 2), (0, 1)), (None, None), None, None,
                      torch.device("cpu"), "gloo", False, ("", "", "", ""))
    tree = dict(algorithm="edm", packed_bus=False, gossip_engine="ppermute")

    def build(arch, **kw):
        cfg = (small_config(arch) if arch in ARCHS
               else dataclasses.replace(get_config(arch), n_layers=1))
        run = RunConfig(**{**tree, **kw})
        model = build_model(cfg)
        return lambda: trainer.build_train_step(
            model, run, trainer.make_gossip_schedule(run, 2), device="cpu",
            mesh=grid)

    if case in ("moe", "ssm", "hybrid", "vlm"):
        arch = {"moe": "deepseek_moe_16b", "ssm": "falcon_mamba_7b",
                "hybrid": "jamba_1_5_large_398b", "vlm": "pixtral_12b"}[case]
        cfg = get_config(arch)
        model = build_model(cfg, mesh=grid)
        loss = lambda: model.loss({}, {"tokens": torch.zeros(  # noqa: E731
            1, 4, dtype=torch.long)})
        return loss, NotImplementedError, f"{case}.*ROADMAP §1 item 8.6"
    if case == "encdec":
        return (lambda: build_model(get_config("whisper_small"), mesh=grid),
                NotImplementedError, "8.2")
    if case == "bus":
        return build("qwen3_14b", packed_bus=True), ValueError, "packed bus"
    if case == "pod":
        return build("qwen3_14b", agents="pod"), ValueError, "set_fsdp"
    if case == "overlap":
        return (build("qwen3_14b", packed_bus=True, overlap="delayed"),
                ValueError, "overlap='delayed' does not compose")
    if case == "wire":
        return (build("qwen3_14b", packed_bus=True, wire="int8"), ValueError,
                "wire='int8' does not compose")
    if case == "groups":
        return (build("qwen3_14b", packed_bus=True, gossip_groups="moe"),
                ValueError, "gossip_groups does not compose")
    if case == "split":
        # smollm_360m's 5 KV heads over 2 model ranks
        return (build("smollm_360m"), ValueError, "5 KV heads")
    if case == "cli_world":
        return (lambda: train_cli.model_ranks(3, 2, 1), ValueError,
                "3 ranks do not split over 2 agent ranks")
    raise KeyError(case)


@pytest.mark.parametrize("case", ["moe", "ssm", "hybrid", "vlm", "encdec",
                                  "bus", "pod", "overlap", "wire", "groups",
                                  "split", "cli_world"])
def test_what_the_tp_train_path_does_not_run_raises(case):
    """The TP loss of the MoE, SSM, hybrid and VLM families raises
    ``NotImplementedError`` naming ROADMAP §1 item 8.6, the
    encoder-decoder layout item 8.2; the packed bus, ``agents="pod"``,
    the overlap, the wires and policy groups on a grid with a model axis
    raise ``ValueError`` from the rank checks, and so do a config whose
    KV heads do not split and the CLI's world that the agent ranks do not
    divide."""
    call, exc, pattern = _raising_case(case)
    with pytest.raises(exc, match=pattern):
        call()


# ---------------------------------------------------------------------------
# (ii) one agent's loss and gradients
# ---------------------------------------------------------------------------

def _grid_block(arr, path, specs, coords):
    """Rank ``coords``' block of a whole leaf under ``specs``."""
    from repro_torch.core.sharding import leaf_block
    return leaf_block(arr, specs[path], {"model": (coords[1], 2),
                                         "data": (coords[0], 2)}, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_agent_gradient_blocks_equal_reference(results, arch):
    """Every rank's loss and gradient blocks (remat on) against the
    reference's ``jax.value_and_grad`` of the whole agent jitted with its
    leaves sharded by ``lm_param_specs`` on the ``(2, 2)`` mesh: the split
    leaves' blocks and the replicated leaves whole, within rtol / atol
    1e-5.  The failure modes are named one by one: (a) without the sum of
    a column-parallel product's normed-input cotangent, ``ln`` and
    ``final_ln`` get only the rank's columns' part (their sum over the
    model ranks is the whole gradient); (b) without the sum of
    ``q_norm`` / ``k_norm``'s gradient, each rank's holds its heads' part
    only; (c) the embedding's and ``lm_head``'s blocks need no sum."""
    specs = build_model(small_config(arch)).param_specs()
    want_loss = float(results["jax"][f"{arch}|loss"])
    for rank, (got, rec) in enumerate(zip(results["ranks"],
                                          results["recs"])):
        coords = rec["coords"]
        np.testing.assert_allclose(rec[f"{arch}|loss"], want_loss, **TOL)
        for path in specs:
            want = _grid_block(results["jax"][f"{arch}|grad|{path}"], path,
                               specs, coords)
            np.testing.assert_allclose(got[f"{arch}|grad|{path}"], want,
                                       err_msg=f"rank {rank} {path}", **TOL)
    # (a): the norms' partial gradients without the normed inputs' sum
    for path in ("final_ln", "blocks|0|attn|ln", "blocks|0|ffn|ln"):
        want = results["jax"][f"{arch}|grad|{path}"]
        parts = [r[f"{arch}|grad" + "no_sum_h" + f"|{path}"]
                 for r in results["ranks"][:2]]
        assert all(np.abs(p - want).max() > 1e-3 for p in parts), path
        if path == "final_ln":
            np.testing.assert_allclose(parts[0] + parts[1], want, **TOL)
    # (b): q_norm / k_norm without their gradients' sum
    if small_config(arch).qk_norm:
        for leaf in ("q_norm", "k_norm"):
            path = f"blocks|0|attn|{leaf}"
            want = results["jax"][f"{arch}|grad|{path}"]
            parts = [r[f"{arch}|grad" + "no_sum_qk" + f"|{path}"]
                     for r in results["ranks"][:2]]
            assert all(np.abs(p - want).max() > 1e-3 for p in parts), path
            np.testing.assert_allclose(parts[0] + parts[1], want, **TOL)
    # (c): the vocab-split leaves hold their own rows' / columns' gradient
    for path in ("embed", "lm_head"):
        for r in results["ranks"]:
            assert r[f"{arch}|grad|{path}"].shape[path == "lm_head"] == 32


def _tp_collectives(cfg, remat=True):
    """The TP loss's sums and gathers a forward + backward: the
    embedding's sum and two a layer forward; with remat, each layer's
    ``wo`` sum again in its recompute (the ``w_down`` sum feeds nothing
    the backward reads, so the recompute stops before it); the backward's
    sums of the two normed inputs a layer (and of ``q_norm`` / ``k_norm``)
    and of the final one; one gather of the logits."""
    L = cfg.n_layers
    sums = 1 + 2 * L + (L if remat else 0) + L * (
        2 + (2 if cfg.qk_norm else 0)) + 1
    return {"tp all-reduce": sums, "tp all-gather": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_collectives_against_reference_hlo(results, arch):
    """The collectives of one agent's loss and backward, by kind and tag
    (:func:`_tp_collectives`), beside the reference's compiled
    ``value_and_grad``: 9 all-reduces and no all-gather there — XLA
    combines the backward's sums, keeps the forward's sums rather than
    recomputing them, and reduces the vocab-parallel cross-entropy over
    the model axis where the port gathers the logits (ROADMAP §3, "TP
    training collectives"); pinned so that a change on either side
    shows."""
    cfg = small_config(arch)
    for r in results["recs"]:
        assert r[f"{arch}|grad_collectives"] == _tp_collectives(cfg)
    hlo = results["hlo"][f"{arch}|grad"]
    assert hlo == HLO_GRAD[arch], hlo


# ---------------------------------------------------------------------------
# (iii)-(vi) trajectories
# ---------------------------------------------------------------------------

def _assemble(results, key, grid, name, specs):
    """A run's whole ``(A, ...)`` leaf from its ranks' blocks (the ``(2,
    2)`` grid's model blocks joined along the split dim)."""
    path = key.split("|", 1)[1]
    by_data = {}
    for arrays, rec in zip(results["ranks"], results["recs"]):
        r = rec.get(f"{name}|{grid}")
        if r is None:
            continue
        m = rec["coords"][1] if grid == "tp" else 0
        by_data.setdefault(r["block"][0], {})[m] = arrays[
            f"{name}|{grid}|{key}"]
    rows = []
    for a0 in sorted(by_data):
        parts = by_data[a0]
        split = [d for d, e in enumerate(specs[path]) if e is not None]
        if grid == "flat" or not split:
            rows.append(parts[0])
        else:
            rows.append(np.concatenate([parts[0], parts[1]],
                                       axis=split[0] + 1))
    return np.concatenate(rows, 0)


@pytest.mark.parametrize("name", list(RUNS))
def test_trajectory_equals_reference_and_flat_grid(results, name):
    """3 steps on the ``(2, 2)`` grid against the reference's tree step
    jitted with ``in_shardings`` from ``state_specs`` /
    ``batch_spec_tree`` (loss, consensus, gradient norm a step; every leaf
    of x and of the algorithm's slots at the end, gathered) and against
    the port's ``(2, 1)`` tree run across ranks (the same, and per-agent
    losses), within rtol / atol 1e-5; every rank of the grid reports the
    same metrics, so a replicated leaf is counted once and a split one's
    blocks summed."""
    arch = RUNS[name][0]
    specs = build_model(small_config(arch)).param_specs()
    jmetrics, jfinal = results["jax_runs"][name]
    tp = [r[f"{name}|tp"] for r in results["recs"]]
    flat = [r[f"{name}|flat"] for r in results["recs"]
            if f"{name}|flat" in r]
    assert len(tp) == 4 and len(flat) == 2
    for r in tp:
        assert r["metrics"] == tp[0]["metrics"]
        assert r["agent_losses"] == tp[0]["agent_losses"]
    for t in range(STEPS):
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(tp[0]["metrics"][t][k],
                                       jmetrics[t][k], err_msg=f"{t} {k}",
                                       **TOL)
            np.testing.assert_allclose(tp[0]["metrics"][t][k],
                                       flat[0]["metrics"][t][k],
                                       err_msg=f"{t} {k}", **TOL)
        np.testing.assert_allclose(tp[0]["agent_losses"][t],
                                   flat[0]["agent_losses"][t], **TOL)
    assert sorted(jfinal) == sorted(
        k[len(name) + 4:] for k in results["ranks"][0]
        if k.startswith(f"{name}|tp|"))
    for key, want in jfinal.items():
        got = _assemble(results, key, "tp", name, specs)
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        np.testing.assert_allclose(
            got, _assemble(results, key, "flat", name, specs),
            err_msg=key, **TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_replicated_leaves_bit_equal_across_model_ranks(results, name):
    """``ln``, ``final_ln``, ``q_norm`` and ``k_norm`` — in x and in
    every optimizer slot — are bit-equal on the two model ranks of each
    data rank after the run; the split leaves differ there."""
    by_data = {}
    for arrays, rec in zip(results["ranks"], results["recs"]):
        by_data.setdefault(rec["coords"][0], []).append(arrays)
    keys = [k for k in results["ranks"][0] if k.startswith(f"{name}|tp|")]
    rep = [k for k in keys if _replicated(k)]
    assert rep and len(rep) < len(keys)
    for a, b in by_data.values():
        for k in rep:
            assert np.array_equal(a[k], b[k]), k
        assert not all(np.array_equal(a[k], b[k]) for k in keys
                       if k.endswith("embed"))


def _step_collectives(cfg, alg, B, n_leaves, n_rep, model_index):
    """A ``(2, 2)`` rank's collectives a step: the TP loss's a agent
    (:func:`_tp_collectives`), one gossip permute a leaf, mix and
    nonzero-shift term of ring(A) (DSGT mixes y and x), the metrics'
    gather of the losses, the consensus's agent sum a leaf (a replicated
    leaf on model index 0 only) and the two scalar totals."""
    from repro_torch.core.topology import ring
    mixes = {"edm": 1, "dsgt": 2, "dsgd": 1}[alg]
    terms = sum(1 for t in ring(2 * B).terms if t.shift % (2 * B))
    tp = _tp_collectives(cfg)
    kept = n_leaves - (n_rep if model_index else 0)
    return {"tp all-reduce": B * tp["tp all-reduce"],
            "tp all-gather": B * tp["tp all-gather"],
            "gossip collective-permute": mixes * terms * n_leaves,
            "metrics all-gather": 1, "metrics all-reduce": kept + 2}


@pytest.mark.parametrize("name", list(RUNS))
def test_step_collectives_against_reference_hlo(results, name):
    """The collectives each rank records a step, by kind and tag
    (:func:`_step_collectives`), beside the reference's compiled step:
    the same collective-permutes (one a leaf, mix and nonzero-shift term:
    GSPMD lowers the shifts engine's rolls over the ``data``-sharded
    agent axis so), and fewer all-reduces than the port's sums, which
    XLA combines (ROADMAP §3, "TP training collectives"); pinned so that
    a change on either side shows."""
    arch, alg, B = RUNS[name]
    cfg = small_config(arch)
    specs = build_model(cfg).param_specs()
    n_rep = sum(1 for p in specs if _replicated(p))
    for rec in results["recs"]:
        want = _step_collectives(cfg, alg, B, len(specs), n_rep,
                                 rec["coords"][1])
        assert all(c == want for c in rec[f"{name}|tp"]["collectives"]), (
            rec[f"{name}|tp"]["collectives"][0], want)
    assert results["hlo"][name]["counts"] == HLO_STEP[name], \
        results["hlo"][name]
    assert HLO_STEP[name]["collective-permute"] == want[
        "gossip collective-permute"]


def test_rank_local_init_is_the_cut_of_the_one_process_state(results):
    """``init_state(mesh=)`` on the grid (``init_lm_rank`` under
    ``state_specs``: a rank never holds the whole model) is bit-equal to
    the one-process ``init_state`` cut by its ``state_specs``; the rank holds
    its heads', FFN columns' and vocabulary rows' blocks."""
    for rec in results["recs"]:
        assert rec["rank_init_equal"]
        sh = rec["rank_init_shapes"]
        assert sh["x|embed"] == [1, 32, 32]
        assert sh["x|lm_head"] == [1, 32, 32]
        assert sh["x|blocks|0|attn|wq"] == [1, 2, 32, 16]
        assert sh["x|blocks|0|attn|wk"] == [1, 2, 32, 8]
        assert sh["x|blocks|0|ffn|w_down"] == [1, 2, 32, 32]
        assert sh["x|blocks|0|attn|q_norm"] == [1, 2, 8]


def _losses(stdout):
    return [float(ln.split("loss=")[1].split()[0])
            for ln in stdout.splitlines() if ln.startswith("step ")]


def test_cli_under_torchrun_on_a_two_by_two_grid(results):
    """``torchrun --nproc-per-node 4`` with ``--agents 2`` (one agent a
    data rank) runs the TP tree on a ``(2, 2)`` grid over gloo (the bus
    off by default there), the header naming the grid and the rank's
    blocks; its losses are the one-process tree run's."""
    out = results["cli"]
    assert "grid=(2, 2) axes=data,model" in out
    assert "+tree" in out
    assert ("tp=model:2 rank_block: heads 2/2 (query/KV) of 4/4, FFN columns "
            "256 of 512, vocabulary rows 256 of 512") in out
    got = _losses(out)
    want = [m["loss"] for m in results["one"]["metrics"]]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, atol=2e-4)
