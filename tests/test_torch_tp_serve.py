"""Tensor-parallel serving (the reference's ``serve_param_specs`` /
``lm_cache_specs`` / ``paged_pool_specs`` layout on a ``(1, M)``
``("data", "model")`` rank grid) against the JAX package.

Two small f32 variants made by ``dataclasses.replace``: ``qwen3_14b``'s
(QK norm, gated FFN) and ``starcoder2_7b``'s (QKV bias, GELU FFN), both 2
layers, d 256, 8 / 4 heads, hd 32, d_ff 512, vocab 512.  Their weights are
the reference's ``init_lm`` (its zero biases and norms drawn nonzero with
numpy, so that their splits show), carried to the port.

* Spec parity: every spec tree of the port equals the reference's
  ``PartitionSpec`` tree path by path.
* One module fixture spawns 4 gloo ranks (a ``file://`` rendezvous) and,
  beside them, one JAX subprocess on 4 host devices.  At grids ``(1, 2)``
  (ranks 0–1) and ``(1, 4)`` each rank's prefill and decode logits are
  held within rtol / atol 1e-5 of the reference jitted with
  ``in_shardings`` from ``serve_param_specs`` / ``serve_cache_specs`` on
  ``jax.make_mesh((1, 4), ("data", "model"))`` and of the reference
  unsharded; its ``greedy_generate`` tokens and its paged engine's tokens
  equal both references', the port's one-process run's and the
  reference's unsharded ``ContinuousBatchingEngine``'s.  The collective
  record of a decode and a prefill forward beside the reference's
  compiled HLO (``hlo_analysis.count_collectives``): both pinned.
* The rank-local init bit-equal to ``shard_params(init_lm(...))``; a head
  count that does not split raising ``ValueError``; the serve CLI under
  torchrun on 2 ranks against one process.
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

from repro_torch.configs import get_config
from repro_torch.core.comm import GossipMesh
from repro_torch.core.sharding import (P, gather_params, leaf_block,
                                       shard_params)
from repro_torch.models import build_model
from repro_torch.models.transformer import (check_tp_split, init_lm_rank,
                                            lm_cache_specs, lm_param_specs)
from repro_torch.serve import (ContinuousBatchingEngine, PagedCacheConfig,
                               greedy_generate, grow_caches,
                               paged_pool_specs, poisson_load,
                               serve_cache_specs, serve_param_specs)
from repro_torch.weights import params_from_npz, tp_block

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ("qwen3_14b", "starcoder2_7b")
SMALL = dict(n_layers=2, d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
             d_ff=512, vocab_size=512, dtype="float32")
GRIDS = ((1, 2), (1, 4))
B, S, N_GEN = 2, 12, 6
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 16


def small_config(arch):
    return dataclasses.replace(get_config(arch), **SMALL)


def _key(arch, grid):
    return f"{arch}|{grid[0]}x{grid[1]}"


def _tokens():
    rng = np.random.default_rng(1)
    return rng.integers(0, SMALL["vocab_size"], (B, S)).astype(np.int32)


def _requests():
    reqs = poisson_load(4, rate=1000.0, vocab=SMALL["vocab_size"],
                        prompt_buckets=(12, 40), new_token_buckets=(6,),
                        prompt_dist="exact", seed=4)
    return [dataclasses.replace(r, arrival=0.0) for r in reqs]


def _pcfg():
    return PagedCacheConfig(page_size=8, num_pages=1 + 4 * 64 // 8,
                            max_slots=4, max_context=64)


def _reference_weights(arch, path):
    """The reference's ``init_lm`` of the small variant, its zero leaves
    (norms, biases) drawn from a seeded normal, saved flat by path."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models.transformer import init_lm
    from repro_torch.weights import _walk
    jcfg = dataclasses.replace(jget_config(arch), **SMALL)
    flat = {}
    _walk(jax.tree.map(np.asarray, init_lm(jcfg, jax.random.PRNGKey(0))), "",
          flat)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if not np.any(v):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    np.savez(path, **flat)


def _engine_run(model, params):
    """Tokens, dispatches and the recorded collectives of the paged engine
    (plain attention: the kernels' CPU dispatch) on the closed trace."""
    from repro_torch.core import comm
    eng = ContinuousBatchingEngine(model, params, _pcfg(), attn_impl="kernel",
                                   prefill_chunk=CHUNK,
                                   max_step_tokens=2 * CHUNK, device="cpu")
    with comm.recording() as log:
        metrics = eng.run(_requests())
    toks = {str(r): t.tolist() for r, t in sorted(eng.completed.items())}
    return toks, metrics, [[c.kind, list(c.shape), c.group_size, c.tag]
                           for c in log]


def _forward(model, params):
    """Prefill logits, one decode step's logits (after the prefill, caches
    grown), and greedy tokens; the collectives of the prefill and of the
    decode step."""
    from repro_torch.core import comm
    toks = torch.from_numpy(_tokens())
    with torch.inference_mode():
        with comm.recording() as log_p:
            lg0, caches = model.prefill(params, {"tokens": toks})
        caches = grow_caches(model, caches, B, S + 4)
        nxt = torch.argmax(lg0[:, -1], -1).to(torch.int32)[:, None]
        with comm.recording() as log_d:
            lg1, _ = model.decode_step(params, caches, nxt, S)
    out = greedy_generate(model, params, {"tokens": toks}, N_GEN)
    rec = [[[c.kind, list(c.shape), c.group_size, c.tag] for c in log]
           for log in (log_p, log_d)]
    return lg0.numpy(), lg1.numpy(), out.numpy(), rec


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    init_distributed("cpu", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=60)
    meshes = {g: make_moe_mesh(*g) for g in GRIDS}
    out, rec = {}, {}
    for arch in ARCHS:
        cfg = small_config(arch)
        full = params_from_npz(f"{d}/{arch}.npz")
        for g, mesh in meshes.items():
            if not mesh.member:
                continue
            key = _key(arch, g)
            model = build_model(cfg, mesh=mesh)
            params = shard_params(full, model.param_specs(), mesh)
            lg0, lg1, toks, colls = _forward(model, params)
            out[f"{key}|prefill"], out[f"{key}|decode"] = lg0, lg1
            out[f"{key}|greedy"] = toks
            engine, metrics, log = _engine_run(model, params)
            back = gather_params(params, model.param_specs(), mesh)
            rec[key] = {"collectives": colls, "engine": engine,
                        "gathered_equal": sorted(back) == sorted(full) and all(
                            torch.equal(back[k], full[k]) for k in full),
                        "steps": metrics["steps"],
                        "mixed_steps": metrics["mixed_steps"],
                        "engine_log": log,
                        "local_k": params["blocks|0|attn|wk"].shape[-1]
                        // cfg.hd}
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
from repro.launch.hlo_analysis import count_collectives
from repro.models.api import build_model
from repro.serve.engine import (build_serve_step, greedy_generate,
                                grow_caches, serve_cache_specs,
                                serve_param_specs)
from repro.serve.paged_cache import PagedCacheConfig
from repro.serve.scheduler import ContinuousBatchingEngine, poisson_load

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
toks = jnp.asarray(np.asarray(spec["tokens"], np.int32))
B, S = toks.shape
# GSPMD's automatic partitioning, as the reference's serving lowers
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out, hlo = {}, {}


def shard(tree, specs):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                        tree, specs, is_leaf=lambda s: isinstance(s, P))


def shardings(specs):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda s: isinstance(s, P))


def reduces(text):
    got = []
    for line in text.splitlines():
        if " all-reduce(" in line or " all-gather(" in line:
            kind = "all-reduce" if " all-reduce(" in line else "all-gather"
            m = re.search(r"=\\s*(\\w+)\\[([\\d,]*)\\]", line)
            got.append([kind, [int(n) for n in m.group(2).split(",") if n]])
    return sorted(got)


for arch in spec["archs"]:
    cfg = dataclasses.replace(get_config(arch), **spec["small"])
    model = build_model(cfg)
    like = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    a = dict(np.load(f"{d}/{arch}.npz"))
    flat, tdef = jax.tree_util.tree_flatten_with_path(like)
    leaves = ["|".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path) for path, _ in flat]
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(a[k]) for k in leaves])
    pspecs = serve_param_specs(model, fsdp=False, multi_pod=False)
    cspecs = serve_cache_specs(model, multi_pod=False)
    p_sh = shard(params, pspecs)
    batch = {"tokens": toks}
    b_sh = {"tokens": NamedSharding(mesh, P("data", None))}
    pre = jax.jit(lambda p, b: model.prefill(p, b),
                  in_shardings=(shardings(pspecs), b_sh))
    lg0_s, _ = pre(p_sh, batch)
    lg0, caches = model.prefill(params, batch)
    caches = grow_caches(model, caches, B, S + 4)
    nxt = jnp.argmax(lg0[:, -1].astype(jnp.float32), -1)[:, None].astype(
        jnp.int32)
    pos = jnp.asarray(S, jnp.int32)
    c_sh = shard(caches, cspecs)
    t_sh = NamedSharding(mesh, P("data", None))
    dec = jax.jit(lambda p, c, t, s: model.decode_step(p, c, t, s),
                  in_shardings=(shardings(pspecs), shardings(cspecs), t_sh,
                                NamedSharding(mesh, P())))
    lg1_s, _ = dec(p_sh, c_sh, nxt, pos)
    lg1, _ = model.decode_step(params, caches, nxt, pos)
    out[f"{arch}|prefill"], out[f"{arch}|decode"] = (np.asarray(lg0),
                                                     np.asarray(lg1))
    out[f"{arch}|prefill_sharded"] = np.asarray(lg0_s)
    out[f"{arch}|decode_sharded"] = np.asarray(lg1_s)
    out[f"{arch}|greedy"] = np.asarray(greedy_generate(model, params, batch,
                                                       spec["n_gen"]))
    out[f"{arch}|greedy_sharded"] = np.asarray(greedy_generate(
        model, p_sh, batch, spec["n_gen"]))
    # the compiled HLO's collectives, lowered as launch/dryrun.py lowers
    step = jax.jit(build_serve_step(model),
                   in_shardings=(shardings(pspecs), shardings(cspecs), t_sh,
                                 NamedSharding(mesh, P())))
    dec_hlo = step.lower(p_sh, c_sh, nxt, pos).compile().as_text()
    pre_hlo = pre.lower(p_sh, batch).compile().as_text()
    hlo[arch] = {"decode": count_collectives(dec_hlo),
                 "decode_ops": reduces(dec_hlo),
                 "prefill": count_collectives(pre_hlo),
                 "prefill_ops": reduces(pre_hlo)}
    # the unsharded continuous engine on the closed trace
    pcfg = PagedCacheConfig(**spec["pcfg"])
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="ref",
                                   prefill_chunk=spec["chunk"],
                                   max_step_tokens=2 * spec["chunk"])
    reqs = poisson_load(4, rate=1000.0, vocab=cfg.vocab_size,
                        prompt_buckets=(12, 40), new_token_buckets=(6,),
                        prompt_dist="exact", seed=4)
    reqs = [dataclasses.replace(r, arrival=0.0) for r in reqs]
    eng.run(reqs)
    hlo[arch]["engine"] = {str(r): np.asarray(t).tolist()
                           for r, t in sorted(eng.completed.items())}
np.savez(f"{d}/jax.npz", **out)
json.dump(hlo, open(f"{d}/jax.json", "w"))
print("JAX_TP_OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    for arch in ARCHS:
        _reference_weights(arch, d / f"{arch}.npz")
    pcfg = _pcfg()
    spec = {"archs": ARCHS, "small": SMALL, "tokens": _tokens().tolist(),
            "n_gen": N_GEN, "chunk": CHUNK,
            "pcfg": dict(page_size=pcfg.page_size, num_pages=pcfg.num_pages,
                         max_slots=pcfg.max_slots,
                         max_context=pcfg.max_context)}
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
    # the port's one-process runs meanwhile
    plain = {}
    for arch in ARCHS:
        model = build_model(small_config(arch))
        params = params_from_npz(str(d / f"{arch}.npz"))
        lg0, lg1, toks, _ = _forward(model, params)
        plain[arch] = {"prefill": lg0, "decode": lg1, "greedy": toks,
                       "engine": _engine_run(model, params)[0]}
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
    return {"jax": dict(np.load(d / "jax.npz")),
            "hlo": json.loads((d / "jax.json").read_text()),
            "ranks": [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)],
            "recs": [json.loads((d / f"rank{r}.json").read_text())
                     for r in range(WORLD)],
            "plain": plain}


def _members(grid):
    return range(grid[0] * grid[1])


# ---------------------------------------------------------------------------
# spec parity
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """A spec tree (the port's or the reference's) as ``{path: tuple of
    entries}``."""
    from jax.sharding import PartitionSpec as JP
    if isinstance(tree, (P, JP)):
        return {prefix: tuple(tree)}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}|{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch):
    """``lm_param_specs``, ``lm_cache_specs``, ``serve_param_specs``
    (fsdp off, one pod and multi-pod), ``serve_cache_specs`` (both) and
    ``paged_pool_specs`` equal the reference's ``PartitionSpec`` trees
    path by path; every parameter path has its spec."""
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtf
    from repro.models.api import build_model as jbuild
    from repro.serve import engine as jengine
    from repro.serve.paged_cache import paged_pool_specs as jpool_specs
    cfg = small_config(arch)
    jcfg = dataclasses.replace(jget_config(arch), **SMALL)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    pairs = [(jtf.lm_param_specs(jcfg), lm_param_specs(cfg)),
             (jtf.lm_cache_specs(jcfg), lm_cache_specs(cfg)),
             (jpool_specs(jcfg), paged_pool_specs(cfg))]
    for mp_ in (False, True):
        pairs.append((jengine.serve_param_specs(jmodel, fsdp=False,
                                                multi_pod=mp_),
                      serve_param_specs(model, fsdp=False, multi_pod=mp_)))
        pairs.append((jengine.serve_cache_specs(jmodel, mp_),
                      serve_cache_specs(model, mp_)))
    for want, got in pairs:
        assert _flat(got) == _flat(want)
    assert sorted(lm_param_specs(cfg)) == sorted(model.meta())
    assert model.param_specs() == lm_param_specs(cfg)
    assert model.cache_specs() == lm_cache_specs(cfg)
    assert _flat(serve_cache_specs(model, True))["0|k"] == (
        None, ("pod", "data"), None, "model", None)


@pytest.mark.parametrize("arch", ["whisper_small"])
def test_other_families_raise(arch):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    for fn in (model.param_specs, model.cache_specs,
               lambda: paged_pool_specs(cfg), lambda: check_tp_split(cfg, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn()
    with pytest.raises(NotImplementedError, match="later slice"):
        serve_param_specs(build_model(small_config("qwen3_14b")), fsdp=True,
                          multi_pod=False)


# ---------------------------------------------------------------------------
# the layout: blocks, rank-local init, splits that do not fit
# ---------------------------------------------------------------------------

def _grid_stub(m, M):
    """A ``(1, M)`` grid seen from model rank m, without a process group
    (:func:`shard_params` reads coordinates only)."""
    return GossipMesh((1, M), ("data", "model"), 1, 1, 1, m, (0, m),
                      ((0,), tuple(range(M))), (None, None), None, None,
                      torch.device("cpu"), "", False)


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_init_bit_equal_to_shard_of_init(arch, count):
    """``init_lm_rank`` draws ``init_lm``'s stream and keeps the rank's
    block: bit-equal to ``shard_params`` of the whole init on every rank,
    and to ``weights.tp_block`` of its numpy form; whole heads a rank."""
    cfg = small_config(arch)
    full = build_model(cfg).init(torch.Generator().manual_seed(0))
    specs = lm_param_specs(cfg)
    arrays = {k: v.numpy() for k, v in full.items()}
    for m in range(count):
        got = init_lm_rank(cfg, torch.Generator().manual_seed(0), m, count)
        want = shard_params(full, specs, _grid_stub(m, count))
        blocks = tp_block(arrays, specs, m, count)
        assert sorted(got) == sorted(want) == sorted(full)
        for k in got:
            assert torch.equal(got[k], want[k]), (m, k)
            assert np.array_equal(got[k].numpy(), blocks[k]), (m, k)
            assert want[k].is_contiguous()
        hd = cfg.hd
        assert got["blocks|0|attn|wq"].shape[-1] == cfg.n_heads * hd // count
        assert got["blocks|0|attn|wk"].shape[-1] == (cfg.n_kv_heads * hd
                                                    // count)
        assert got["blocks|0|attn|wo"].shape[1] == cfg.n_heads * hd // count
        assert got["embed"].shape[0] == cfg.vocab_size // count
        assert got["lm_head"].shape[1] == cfg.vocab_size // count
        assert torch.equal(got["final_ln"], full["final_ln"])
        # the block of model rank m: the m-th contiguous columns
        n = cfg.n_kv_heads * hd // count
        assert torch.equal(got["blocks|0|attn|wk"],
                           full["blocks|0|attn|wk"][..., m * n:(m + 1) * n])


def test_split_that_does_not_fit_raises():
    """``smollm_360m``'s 5 KV heads (15 query heads) do not split over 2
    model ranks in whole heads: the model on a 2-rank grid, the rank-local
    init and the serve CLI's check raise ``ValueError``, though ``wk``'s
    320 columns would divide; an uneven dim raises in ``shard_params``."""
    from repro_torch.configs import get_smoke_config
    cfg = get_config("smollm_360m")
    with pytest.raises(ValueError, match="5 KV heads"):
        check_tp_split(cfg, 2)
    with pytest.raises(ValueError, match="KV heads"):
        build_model(cfg, mesh=_grid_stub(0, 2))
    small = dataclasses.replace(get_smoke_config("smollm_360m"),
                                n_heads=15, n_kv_heads=5)
    with pytest.raises(ValueError, match="5 KV heads"):
        init_lm_rank(small, torch.Generator().manual_seed(0), 0, 2)
    check_tp_split(get_config("qwen3_14b"), 4)
    check_tp_split(get_config("qwen1_5_110b"), 4)
    with pytest.raises(ValueError, match="does not split"):
        leaf_block(torch.zeros(6, 5), P(None, "model"), {"model": (0, 2)},
                   "w")
    with pytest.raises(ValueError, match="not an axis"):
        leaf_block(torch.zeros(6, 4), P("pod", None), {"model": (0, 2)}, "w")


def test_loss_under_tp_raises():
    model = build_model(small_config("qwen3_14b"), mesh=_grid_stub(0, 2))
    with pytest.raises(NotImplementedError, match="train path"):
        model.loss({}, {})
    assert model.init_cache(2, 8, device="meta")[0]["k"].shape == (
        2, 2, 8, 2, 32)


# ---------------------------------------------------------------------------
# the ranks against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_match_reference(results, arch, grid):
    """Every rank of the grid: prefill and decode logits within rtol /
    atol 1e-5 of the reference sharded on 4 host devices and of the
    reference unsharded (and of the port's one process); greedy tokens
    equal to all three; ``gather_params`` of its blocks the whole
    weights, bit for bit."""
    key, j = _key(arch, grid), results["jax"]
    plain = results["plain"][arch]
    for r in _members(grid):
        got = results["ranks"][r]
        for what in ("prefill", "decode"):
            for want in (j[f"{arch}|{what}"], j[f"{arch}|{what}_sharded"],
                         plain[what]):
                np.testing.assert_allclose(got[f"{key}|{what}"], want,
                                           err_msg=f"{key} rank {r} {what}",
                                           **TOL)
        for want in (j[f"{arch}|greedy"], j[f"{arch}|greedy_sharded"],
                     plain["greedy"]):
            np.testing.assert_array_equal(got[f"{key}|greedy"], want)
        assert results["recs"][r][key]["local_k"] == (
            SMALL["n_kv_heads"] // grid[1])
        assert results["recs"][r][key]["gathered_equal"]


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_over_ranks(results, arch, grid):
    """The continuous engine over the grid's ranks (pools of K / M heads):
    tokens equal to the port's one-process engine and to the reference's
    unsharded ``ContinuousBatchingEngine`` on the same closed trace; each
    dispatch sums 2L + 1 times over the model axis (a mixed one twice
    that) and gathers the logits once (twice), and makes no other
    collective."""
    key = _key(arch, grid)
    want = results["plain"][arch]["engine"]
    assert want == results["hlo"][arch]["engine"]
    L = SMALL["n_layers"]
    for r in _members(grid):
        rec = results["recs"][r][key]
        assert rec["engine"] == want
        n = rec["steps"] + rec["mixed_steps"]
        kinds = [c[0] for c in rec["engine_log"]]
        assert kinds.count("all-reduce") == (2 * L + 1) * n
        assert kinds.count("all-gather") == n
        assert all(c[2] == grid[1] and c[3] == "tp"
                   for c in rec["engine_log"])


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_against_reference_hlo(results, arch):
    """The port's record of one decode and one prefill forward at ``(1,
    4)``: 2L + 1 all-reduces of the activations (the embedding, each
    layer's ``wo`` and ``w_down``) and one all-gather of the logits,
    every one over the 4 ranks of the model axis.  The reference's
    compiled programs, pinned: the same all-reduces, the stacked layers'
    two written once in the scan's loop body (so 1 + 2 in the text, 1 +
    2L executed); its decode step (``build_serve_step``, argmax
    included) gathers each rank's ``(B,)`` argmax value and index, two
    ``(B, 4)`` all-gathers, where the port gathers the ``(B, 1, V)``
    logits and takes one argmax; its prefill returns the logits split
    over the vocabulary and gathers nothing (ROADMAP §3)."""
    L, d, V = SMALL["n_layers"], SMALL["d_model"], SMALL["vocab_size"]
    key = _key(arch, (1, 4))
    for rec in results["recs"]:
        pre, dec = rec[key]["collectives"]
        for log, rows in ((pre, S), (dec, 1)):
            assert log == ([["all-reduce", [B, rows, d], 4, "tp"]]
                           * (2 * L + 1)
                           + [["all-gather", [B, 1, V], 4, "tp"]])
    hlo = results["hlo"][arch]
    assert hlo["decode"] == {"all-reduce": 3, "all-gather": 2}
    assert hlo["decode_ops"] == ([["all-gather", [B, 4]]] * 2
                                 + [["all-reduce", [B, 1, d]]] * 3)
    assert hlo["prefill"] == {"all-reduce": 3}
    assert hlo["prefill_ops"] == [["all-reduce", [B, S, d]]] * 3


# ---------------------------------------------------------------------------
# the serve CLI under torchrun
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3_14b", "--smoke", "--device", "cpu"]
CONTINUOUS = ["--continuous-batching", "--prefill-chunk", "8",
              "--max-step-tokens", "16", "--prompt-dist", "exact",
              "--requests", "4"]


def _metrics(stdout):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("serve metrics: "))
    return json.loads(line[len("serve metrics: "):])


@pytest.mark.parametrize("mode", ["continuous", "greedy"])
def test_serve_cli_under_torchrun_equals_one_process(tmp_path, mode):
    """A dense model under torchrun on 2 ranks: the ``(1, 2)`` grid, rank
    0 alone prints its summary with the grid, and every rank's tokens equal
    the one-process CLI's — the continuous engine from each rank's block
    of a consensus file (``--ckpt``, cut on load; the file's digest
    reported), ``greedy_generate`` from the rank-local init."""
    from repro_torch.weights import tensor_to_array
    cli = CLI + (CONTINUOUS if mode == "continuous" else
                 ["--batch", "2", "--prompt-len", "8", "--new-tokens", "4"])
    if mode == "continuous":
        from repro_torch.configs import get_smoke_config
        params = build_model(get_smoke_config("qwen3_14b")).init(
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
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *cli],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert "tp grid=(1, 2) heads/rank=2/2" in ranks.stdout
    assert "grid=(1, 2)" in [ln for ln in ranks.stdout.splitlines()
                             if ln.startswith("arch=")][0]
    assert "grid=" not in one.stdout
    if mode == "continuous":
        assert ranks.stdout.count("serve metrics: ") == 1  # rank 0 prints
        want, got = _metrics(one.stdout), _metrics(ranks.stdout)
        assert got["rank_token_digests"] == [want["token_digest"]] * 2
        assert got["params_sha256"] == want["params_sha256"]
    else:
        want = [ln for ln in one.stdout.splitlines() if "  req" in ln]
        got = [ln for ln in ranks.stdout.splitlines() if "  req" in ln]
        assert got == want and len(want) == 2
        digests = json.loads(next(
            ln for ln in ranks.stdout.splitlines()
            if ln.startswith("rank token digests: "))[20:].replace("'", '"'))
        assert len(set(digests)) == 1
