"""The expert-parallel MoE layer (``set_moe_mesh`` /
``apply_moe_shard_map`` on a ``("data", "model")`` rank grid) against the
JAX package's ``apply_moe_shard_map``, and its caller, serving across
ranks.

* The 1 × 1 grid in one process (:func:`make_sim_mesh`) against the
  reference's layer on a ``(1, 1)`` mesh, at the reference test's
  ``(E, k, shared)`` cases and tolerances.
* One module fixture spawns 4 gloo ranks (a ``file://`` rendezvous) and,
  beside them, one JAX subprocess on 4 host devices.  On ``(1, 4)`` and
  ``(2, 2)`` grids at capacity factors 8.0 and 1.0 in f32 (d 32, E 8,
  k 2, one shared expert, x ``(2, 16, 32)``: the ``(2, 2)`` grid's
  per-data-shard capacity and averaged aux make it another function than
  the plain layer) each rank's output, aux and every gradient leaf of
  ``Σ y · ct + aux`` (its expert block against the reference's slice)
  are held to the reference's 4-device ``jax.grad``; at ``(1, 4)`` also to
  the port's plain one-process ``apply_moe``.  ``(1, 4)`` in bf16, forward
  only.  The forward's collective record against the reference's lowered
  HLO (``hlo_analysis.count_collectives``).  The engine at
  ``deepseek_moe_16b``'s smoke config in f32 over the 4 ranks (each its
  rank-local init), tokens equal to the one-process engine's at
  capacities 8.0 and 1.25, one sum over the model axis a MoE layer call.
* The rank-local init bit-equal to the slice of ``model.init``;
  ``apply_moe`` raising on an expert block with no grid; the serve CLI
  under torchrun with 2 ranks and ``--moe-impl shard_map`` against the
  one-process CLI (from the rank-local init and from a consensus file),
  and raising without torchrun.
* ``grad_norm_at_mean``, ``heterogeneity_zeta2`` and
  ``consensus_distance_from_dev`` against ``repro.core.metrics``.
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

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import metrics as tmetrics
from repro_torch.models import build_model, moe as tmoe
from repro_torch.models.transformer import expert_param_specs, init_lm_rank
from repro_torch.serve import ContinuousBatchingEngine, PagedCacheConfig
from repro_torch.serve import poisson_load
from repro_torch.weights import expert_block

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD, EPS = 4, 1e-6
CFG = dict(name="ep", family="moe", n_layers=1, d_model=32, n_heads=2,
           n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=8,
           experts_per_token=2, n_shared_experts=1, dtype="float32")
GRIDS = ((1, 4), (2, 2))
CFS = (8.0, 1.0)
X_SHAPE = (2, 16, 32)
LEAVES = ("ln", "router", "w_gate", "w_up", "w_down", "shared|w_gate",
          "shared|w_up", "shared|w_down")
EXPERTS = ("w_gate", "w_up", "w_down")
# the engine over the ranks: deepseek_moe_16b's smoke config, 4 requests
ARCH = "deepseek_moe_16b"
ENGINE_CFS = (8.0, 1.25)
CHUNK = 16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _key(grid, cf):
    return f"{grid[0]}x{grid[1]}|{cf}"


def _inputs():
    """Seeded f32 parameters of one MoE layer, x and the cotangent."""
    rng = np.random.default_rng(0)
    d, E, ff = CFG["d_model"], CFG["n_experts"], CFG["d_ff"]

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    return {"ln": (0.1 * rng.standard_normal(d)).astype(np.float32),
            "router": w(d, E, fan=d), "w_gate": w(E, d, ff, fan=d),
            "w_up": w(E, d, ff, fan=d), "w_down": w(E, ff, d, fan=ff),
            "shared|w_gate": w(d, ff, fan=d), "shared|w_up": w(d, ff, fan=d),
            "shared|w_down": w(ff, d, fan=ff),
            "x": rng.standard_normal(X_SHAPE).astype(np.float32),
            "ct": rng.standard_normal(X_SHAPE).astype(np.float32)}


def _params(a, dtype, block=None, grad=False):
    """The port's nested layer dict from the flat arrays (the router f32),
    cut to model rank ``block = (m, M)``'s experts."""
    flat = {k: a[k] for k in LEAVES}
    if block is not None:
        flat = expert_block(flat, *block)
    p = {}
    for k, v in flat.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t if k == "router" else t.to(dtype)
        t.requires_grad_(grad)
        if k.startswith("shared|"):
            p.setdefault("shared", {})[k[7:]] = t
        else:
            p[k] = t
    return p


def _flat_grads(p):
    out = {k: v.grad for k, v in p.items() if k != "shared"}
    out.update({f"shared|{k}": v.grad for k, v in p["shared"].items()})
    return out


def _requests(vocab):
    reqs = poisson_load(4, rate=1000.0, vocab=vocab,
                        prompt_buckets=(12, 40), new_token_buckets=(6,),
                        prompt_dist="exact", seed=4)
    return [dataclasses.replace(r, arrival=0.0) for r in reqs]


def _engine_tokens(cf, params=None, block=None):
    """The continuous engine's tokens at the smoke config with capacity
    ``cf`` (plain attention), from ``model.init`` or a rank's block."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), capacity_factor=cf)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = (model.init(gen) if block is None
              else init_lm_rank(cfg, gen, *block,
                                specs=expert_param_specs(model.meta())))
    pcfg = PagedCacheConfig(page_size=8, num_pages=1 + 4 * 64 // 8,
                            max_slots=4, max_context=64)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="ref",
                                   prefill_chunk=CHUNK,
                                   max_step_tokens=2 * CHUNK, device="cpu")
    metrics = eng.run(_requests(cfg.vocab_size))
    toks = {str(r): t.tolist() for r, t in sorted(eng.completed.items())}
    return toks, metrics, cfg.n_layers


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    meshes = {g: make_moe_mesh(*g) for g in GRIDS}
    a = dict(np.load(f"{d}/inputs.npz"))
    ct = torch.from_numpy(a["ct"])
    out, rec = {}, {"collectives": {}}
    for g, mesh in meshes.items():
        block = (mesh.axis_index("model"), mesh.axis_size("model"))
        for cf in CFS:
            key = _key(g, cf)
            cfg = ModelConfig(**CFG, capacity_factor=cf)
            p = _params(a, torch.float32, block, grad=True)
            x = torch.from_numpy(a["x"]).requires_grad_()
            with comm.recording() as log:
                y, aux = tmoe.apply_moe_shard_map(p, cfg, x, EPS, mesh)
            ((y * ct).sum() + aux).backward()
            out[f"{key}|y"] = y.detach().numpy()
            out[f"{key}|aux"] = aux.detach().numpy()
            out[f"{key}|grad|x"] = x.grad.numpy()
            for k, v in _flat_grads(p).items():
                out[f"{key}|grad|{k}"] = v.numpy()
            rec["collectives"][key] = [
                [c.kind, list(c.shape), str(c.dtype), c.group_size, c.tag]
                for c in log]
    # (1, 4) in bf16, forward only
    mesh = meshes[(1, 4)]
    block = (mesh.axis_index("model"), 4)
    with torch.no_grad():
        y, aux = tmoe.apply_moe_shard_map(
            _params(a, torch.bfloat16, block),
            ModelConfig(**CFG, capacity_factor=8.0),
            torch.from_numpy(a["x"]).bfloat16(), EPS, mesh)
    out["bf16|y"], out["bf16|aux"] = y.float().numpy(), aux.numpy()
    # the engine over the (1, 4) grid, each rank its rank-local init
    tmoe.set_moe_mesh(mesh, "shard_map")
    try:
        for cf in ENGINE_CFS:
            with comm.recording() as log:
                toks, metrics, n_layers = _engine_tokens(cf, block=block)
            rec[f"engine|{cf}"] = {
                "tokens": toks, "steps": metrics["steps"],
                "mixed_steps": metrics["mixed_steps"], "n_layers": n_layers,
                "sums": sum(1 for c in log if c.kind == "all-reduce"
                            and c.tag == "moe" and c.group_size == 4),
                "other": [c.kind for c in log if not (
                    c.kind == "all-reduce" and c.tag == "moe")]}
    finally:
        tmoe.set_moe_mesh(None)
    np.savez(f"{d}/rank{rank}.npz", **out)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


_JAX_CODE = """
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.launch.hlo_analysis import count_collectives
from repro.models.moe import apply_moe_shard_map

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
a = dict(np.load(f"{d}/inputs.npz"))


def params(dt):
    p = {k: jnp.asarray(a[k], dt) for k in ("ln", "w_gate", "w_up",
                                             "w_down")}
    p["router"] = jnp.asarray(a["router"])
    p["shared"] = {k: jnp.asarray(a["shared|" + k], dt)
                   for k in ("w_gate", "w_up", "w_down")}
    return p


out, hlo_rec = {}, {}
x = jnp.asarray(a["x"])
for g in spec["grids"]:
    mesh = jax.make_mesh(tuple(g), ("data", "model"))
    for cf in spec["cfs"]:
        cfg = ModelConfig(**spec["cfg"], capacity_factor=cf)
        key = f"{g[0]}x{g[1]}|{cf}"

        def loss(p, x):
            y, aux = apply_moe_shard_map(p, cfg, x, spec["eps"], mesh)
            return jnp.sum(y * a["ct"]) + aux, (y, aux)

        f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
        (_, (y, aux)), (gp, gx) = f(params(jnp.float32), x)
        out[f"{key}|y"], out[f"{key}|aux"] = np.asarray(y), np.asarray(aux)
        out[f"{key}|grad|x"] = np.asarray(gx)
        for k, v in gp.items():
            if k == "shared":
                for kk, vv in v.items():
                    out[f"{key}|grad|shared|{kk}"] = np.asarray(vv)
            else:
                out[f"{key}|grad|{k}"] = np.asarray(v)
        fwd = jax.jit(lambda p, x: apply_moe_shard_map(p, cfg, x,
                                                       spec["eps"], mesh))
        hlo = fwd.lower(params(jnp.float32), x).compile().as_text()
        reduces = []
        for line in hlo.splitlines():
            if " all-reduce(" in line:
                shape = re.search(r"=\\s*(\\w+)\\[([\\d,]*)\\]", line)
                groups = re.search(r"replica_groups=\\{\\{([^}]*)\\}", line)
                reduces.append([[int(n) for n in shape.group(2).split(",")
                                 if n], len(groups.group(1).split(","))])
        hlo_rec[key] = {"counts": count_collectives(hlo),
                        "all_reduce": sorted(reduces)}
mesh = jax.make_mesh((1, 4), ("data", "model"))
cfg = ModelConfig(**spec["cfg"], capacity_factor=8.0)
y, aux = jax.jit(lambda p, x: apply_moe_shard_map(p, cfg, x, spec["eps"],
                                                  mesh))(
    params(jnp.bfloat16), x.astype(jnp.bfloat16))
out["bf16|y"], out["bf16|aux"] = (np.asarray(y, np.float32),
                                  np.asarray(aux))
np.savez(f"{d}/jax.npz", **out)
json.dump(hlo_rec, open(f"{d}/jax-hlo.json", "w"))
print("JAX_EP_OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    a = _inputs()
    np.savez(d / "inputs.npz", **a)
    spec = {"cfg": CFG, "grids": GRIDS, "cfs": CFS, "eps": EPS}
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
    # the port's one-process references meanwhile
    plain = {}
    for cf in CFS:
        p = _params(a, torch.float32, grad=True)
        x = torch.from_numpy(a["x"]).requires_grad_()
        y, aux = tmoe.apply_moe(p, ModelConfig(**CFG, capacity_factor=cf),
                                x, EPS)
        ((y * torch.from_numpy(a["ct"])).sum() + aux).backward()
        plain[cf] = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
                     "grad|x": x.grad.numpy(),
                     **{f"grad|{k}": v.numpy()
                        for k, v in _flat_grads(p).items()}}
    engine = {cf: _engine_tokens(cf)[0] for cf in ENGINE_CFS}
    deadline = time.time() + 240
    while not ctx.join(timeout=1):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            jax_proc.kill()
            raise AssertionError("the ranks did not finish in 240 s")
    out_j, err_j = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, out_j[-2000:] + err_j[-3000:]
    print(f"ranks and the JAX subprocess: {time.time() - t0:.1f} s")
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    recs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    return {"jax": dict(np.load(d / "jax.npz")),
            "hlo": json.loads((d / "jax-hlo.json").read_text()),
            "ranks": ranks, "recs": recs, "plain": plain, "engine": engine}


def _rel(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))


def _model_index(grid, rank):
    return rank % grid[1]


def _expert_slice(full, grid, rank):
    n = full.shape[0] // grid[1]
    m = _model_index(grid, rank)
    return full[m * n:(m + 1) * n]


@pytest.mark.parametrize("E,k,shared", [(4, 1, 0), (8, 2, 1), (16, 4, 2)])
def test_sim_grid_matches_reference(E, k, shared):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models.moe import apply_moe_shard_map as japply, init_moe
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.weights import params_from_tree
    kw = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=E,
              experts_per_token=k, n_shared_experts=shared,
              capacity_factor=8.0, dtype="float32")
    p = init_moe(jax.random.PRNGKey(0), JModelConfig(**kw))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32)))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want, aux_want = jax.jit(lambda p, x: japply(
        p, JModelConfig(**kw), x, 1e-6, mesh))(p, jnp.asarray(x))
    flat = params_from_tree(jax.tree.map(np.asarray, p))
    tp = {k: v for k, v in flat.items() if not k.startswith("shared|")}
    if shared:
        tp["shared"] = {k[7:]: v for k, v in flat.items()
                        if k.startswith("shared|")}
    got, aux = tmoe.apply_moe_shard_map(tp, ModelConfig(**kw),
                                        torch.from_numpy(x), 1e-6,
                                        make_sim_mesh())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(float(aux), float(aux_want), rtol=1e-4)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("cf", CFS)
def test_ranks_match_reference_forward_and_grads(results, grid, cf):
    """Each rank's output, aux and gradients against the reference's
    4-device ``jax.grad``: f32 output rtol 3e-4 / atol 3e-5, aux rtol
    1e-4, every gradient leaf within 1e-4 relative norm (an expert leaf:
    the rank's block against the reference's slice)."""
    key = _key(grid, cf)
    j = results["jax"]
    for rank, got in enumerate(results["ranks"]):
        np.testing.assert_allclose(got[f"{key}|y"], j[f"{key}|y"],
                                   rtol=3e-4, atol=3e-5, err_msg=key)
        np.testing.assert_allclose(got[f"{key}|aux"], j[f"{key}|aux"],
                                   rtol=1e-4, err_msg=key)
        for leaf in LEAVES + ("x",):
            want = j[f"{key}|grad|{leaf}"]
            if leaf in EXPERTS:
                want = _expert_slice(want, grid, rank)
            g = got[f"{key}|grad|{leaf}"]
            assert g.shape == want.shape, (key, leaf)
            assert _rel(g, want) <= 1e-4, (key, rank, leaf, _rel(g, want))


def test_two_by_two_grid_is_another_function(results):
    """At ``(2, 2)`` the per-data-shard capacity and the averaged aux
    differ from the plain layer (so a port that only sums the expert
    shards would be wrong there)."""
    j, plain = results["jax"], results["plain"][1.0]
    assert abs(float(j["2x2|1.0|aux"]) - float(plain["aux"])) > 1e-6
    got = results["ranks"][0]["2x2|1.0|y"]
    np.testing.assert_allclose(got, j["2x2|1.0|y"], rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("cf", CFS)
def test_model_axis_equals_plain_layer(results, cf):
    """At ``(1, 4)`` the layer is the plain ``apply_moe``: its output, aux
    and gradients, the router's not multiplied by the model axis."""
    key, plain = _key((1, 4), cf), results["plain"][cf]
    for rank, got in enumerate(results["ranks"]):
        np.testing.assert_allclose(got[f"{key}|y"], plain["y"], rtol=3e-4,
                                   atol=3e-5)
        np.testing.assert_allclose(got[f"{key}|aux"], plain["aux"],
                                   rtol=1e-5)
        for leaf in LEAVES + ("x",):
            want = plain[f"grad|{leaf}"]
            if leaf in EXPERTS:
                want = _expert_slice(want, (1, 4), rank)
            assert _rel(got[f"{key}|grad|{leaf}"], want) <= 1e-5, (
                cf, rank, leaf)


def test_bf16_forward_matches_reference(results):
    """``(1, 4)`` in bf16 (the router f32), forward only: every rank's
    output bit-equal to the others' and within rtol / atol 2e-2 of the
    reference's; aux within rtol 1e-3."""
    j = results["jax"]
    y0 = results["ranks"][0]["bf16|y"]
    for got in results["ranks"]:
        assert np.array_equal(got["bf16|y"], y0)
        np.testing.assert_allclose(got["bf16|y"], j["bf16|y"], **BF16_TOL)
        np.testing.assert_allclose(got["bf16|aux"], j["bf16|aux"],
                                   rtol=1e-3)


@pytest.mark.parametrize("grid", GRIDS)
def test_collectives_against_reference_hlo(results, grid):
    """The forward's record: one all-reduce of ``(T_l, d)`` over the model
    group a layer, and at ``use_dp`` one of aux over the data group — the
    all-reduces of the reference's lowered layer, shape for shape — plus,
    at ``use_dp``, the one all-gather of the data shards that the
    reference's GSPMD leaves out (its output stays sharded)."""
    for cf in CFS:
        key = _key(grid, cf)
        hlo = results["hlo"][key]
        dp, M = grid
        T, d = X_SHAPE[0] * X_SHAPE[1], X_SHAPE[2]
        for rec in results["recs"]:
            got = rec["collectives"][key]
            assert all(c[4] == "moe" for c in got)
            reduces = sorted([c[1], c[3]] for c in got
                             if c[0] == "all-reduce")
            assert len(reduces) == hlo["counts"]["all-reduce"], key
            assert reduces == hlo["all_reduce"], key
            gathers = [c for c in got if c[0] == "all-gather"]
            assert "all-gather" not in hlo["counts"]
            assert gathers == ([["all-gather", [T, d], "torch.float32", dp,
                                 "moe"]] if dp > 1 else []), key
            assert [c[0] for c in got][0] == "all-reduce"
            assert got[0][1:4] == [[T // dp, d], "torch.float32", M]


@pytest.mark.parametrize("cf", ENGINE_CFS)
def test_engine_over_ranks_equals_one_process(results, cf):
    """The continuous engine at the smoke config over 4 ranks (each its
    rank-local block of experts): tokens equal to the one-process
    engine's on the same requests; one sum over the model axis per MoE
    layer call (two layer calls a mixed dispatch: the decode rows and the
    chunk rows) and no other collective."""
    want = results["engine"][cf]
    for rec in results["recs"]:
        r = rec[f"engine|{cf}"]
        assert r["tokens"] == want, cf
        L = r["n_layers"]
        assert r["sums"] == L * (r["steps"] + r["mixed_steps"]), r
        assert r["other"] == []


@pytest.mark.parametrize("count", [2, 4])
def test_rank_init_bit_equal_to_slice_of_init(count):
    cfg = get_smoke_config(ARCH)
    full = build_model(cfg).init(torch.Generator().manual_seed(0))
    for m in range(count):
        got = init_lm_rank(cfg, torch.Generator().manual_seed(0), m, count,
                           specs=expert_param_specs(full))
        want = expert_block(full, m, count)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].shape == want[k].shape, k
            assert torch.equal(got[k], want[k]), (m, k)
        n = cfg.n_experts // count
        assert got["blocks|0|moe|w_gate"].shape[1] == n


def test_expert_block_of_a_numpy_tree():
    a = _inputs()
    tree = {k: a[k] for k in ("ln", "router", "w_gate", "w_up", "w_down")}
    tree["shared"] = {k: a[f"shared|{k}"] for k in EXPERTS}
    got = expert_block(tree, 1, 4)
    assert np.array_equal(got["w_gate"], a["w_gate"][2:4])
    assert np.array_equal(got["shared|w_gate"], a["shared|w_gate"])
    assert np.array_equal(got["router"], a["router"])


def test_expert_block_without_grid_raises():
    a = _inputs()
    cfg = ModelConfig(**CFG)
    p = _params(a, torch.float32, block=(0, 4))
    with pytest.raises(ValueError, match="set_moe_mesh"):
        tmoe.apply_moe(p, cfg, torch.from_numpy(a["x"]), EPS)
    # "gspmd" records the grid and changes nothing
    from repro_torch.launch.mesh import make_sim_mesh
    tmoe.set_moe_mesh(make_sim_mesh(), "gspmd")
    try:
        with pytest.raises(ValueError, match="set_moe_mesh"):
            tmoe.apply_moe(p, cfg, torch.from_numpy(a["x"]), EPS)
    finally:
        tmoe.set_moe_mesh(None)
    with pytest.raises(ValueError):
        tmoe.set_moe_mesh(None, "pjit")
    # on a registered 1 × 1 grid a block is the wrong expert count too
    tmoe.set_moe_mesh(make_sim_mesh(), "shard_map")
    try:
        with pytest.raises(ValueError, match="holds its block of 8"):
            tmoe.apply_moe(p, cfg, torch.from_numpy(a["x"]), EPS)
    finally:
        tmoe.set_moe_mesh(None)


CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--continuous-batching",
       "--prefill-chunk", "8", "--max-step-tokens", "16", "--prompt-dist",
       "exact", "--requests", "4"]


def _metrics(stdout):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("serve metrics: "))
    return json.loads(line[len("serve metrics: "):])


@pytest.mark.parametrize("weights", ["init", "ckpt"])
def test_serve_cli_under_torchrun_equals_one_process(tmp_path, weights):
    """``--moe-impl shard_map`` on 2 ranks under torchrun: every rank's
    tokens equal to the one-process CLI's (the smoke config is dropless,
    so the closed trace's schedule does not change them), from the
    rank-local init or each rank's block of a consensus file (``--ckpt``,
    a bare-path npz as ``export_consensus`` writes)."""
    from repro_torch.weights import tensor_to_array
    cli = list(CLI)
    if weights == "ckpt":
        params = build_model(get_smoke_config(ARCH)).init(
            torch.Generator().manual_seed(3))
        np.savez(tmp_path / "consensus.npz",
                 **{k: tensor_to_array(v) for k, v in params.items()})
        cli += ["--ckpt", str(tmp_path / "consensus.npz")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *cli], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-3000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *cli,
         "--moe-impl", "shard_map"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=180)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert "moe=shard_map grid=(1, 2) experts/rank=2" in ranks.stdout
    assert ranks.stdout.count("serve metrics: ") == 1      # rank 0 prints
    want, got = _metrics(one.stdout), _metrics(ranks.stdout)
    assert got["rank_token_digests"] == [want["token_digest"]] * 2
    assert got["tokens"] == want["tokens"]
    if weights == "ckpt":
        assert got["params_sha256"] == want["params_sha256"]


def test_serve_cli_shard_map_without_torchrun_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        serve.main(CLI + ["--moe-impl", "shard_map"])
    assert tmoe._MESH["mesh"] is None


def _agent_trees(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 6, 5)).astype(np.float32),
            "b": rng.standard_normal((4, 7)).astype(np.float32)}


def test_heterogeneity_zeta2_matches_reference():
    import jax.numpy as jnp
    from repro.core import metrics as jmetrics
    g = _agent_trees(1)
    want = jmetrics.heterogeneity_zeta2({k: jnp.asarray(v)
                                         for k, v in g.items()})
    got = tmetrics.heterogeneity_zeta2({k: torch.from_numpy(v)
                                        for k, v in g.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_consensus_distance_from_dev_matches_reference():
    import jax.numpy as jnp
    from repro.core import metrics as jmetrics
    dev = _agent_trees(2)
    want = jmetrics.consensus_distance_from_dev(
        {k: jnp.asarray(v) for k, v in dev.items()})
    got = tmetrics.consensus_distance_from_dev(
        {k: torch.from_numpy(v) for k, v in dev.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_grad_norm_at_mean_matches_reference():
    """‖∇f(x̄)‖² of a least-squares loss, the same gradient written in
    each framework."""
    import jax.numpy as jnp
    from repro.core import metrics as jmetrics
    x = _agent_trees(3)
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6)).astype(np.float32)

    def jgrad(p):
        return {"w": A @ p["w"] - 1.0, "b": 2.0 * p["b"]}

    def tgrad(p):
        return {"w": torch.from_numpy(A) @ p["w"] - 1.0, "b": 2.0 * p["b"]}

    want = jmetrics.grad_norm_at_mean(jgrad, {k: jnp.asarray(v)
                                              for k, v in x.items()})
    got = tmetrics.grad_norm_at_mean(tgrad, {k: torch.from_numpy(v)
                                             for k, v in x.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
