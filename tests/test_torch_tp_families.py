"""Tensor-parallel serving past the dense family (the reference's
``lm_param_specs`` / ``lm_cache_specs`` for the MoE, SSM, hybrid and VLM
families on a ``(1, M)`` ``("data", "model")`` rank grid) against the JAX
package.

Four small f32 variants made by ``dataclasses.replace``:
``deepseek_moe_16b``'s (8 experts top-2 and 2 shared experts, MHA),
``falcon_mamba_7b``'s (d_inner 64), ``jamba_1_5_large_398b``'s (5 layers:
``(ssm, dense)``, ``(ssm, moe)`` and ``(attn, dense)``) and
``pixtral_12b``'s (GQA, 3 frontend embeddings a row).  Their weights are
the reference's ``init_lm`` (its zero leaves drawn nonzero with numpy, so
that their splits show), carried to the port.

* Specs, rank-local init and splits that do not fit, in this process.
* One module fixture spawns 4 gloo ranks (a ``file://`` rendezvous) and,
  beside them, one JAX subprocess on 4 host devices (``AxisType.Auto``),
  which jits the reference with ``in_shardings`` from
  ``serve_param_specs`` / ``serve_cache_specs`` and, for the models with
  experts, the reference's ``apply_moe_shard_map`` on the same mesh (its
  dry-run's serving layout).  At grids ``(1, 2)`` (ranks 0–1) and ``(1,
  4)`` each rank's prefill logits and ``N_DEC`` teacher-forced decode
  steps' logits are held within rtol / atol 1e-5 of the sharded
  reference, of the unsharded reference and of the port's one process;
  its greedy tokens equal both; a bf16 model's ranks are bit-equal among
  themselves; the paged engine over the ranks (MoE, VLM) equals one
  process; the collectives a forward stand beside the reference's HLO.
* The serve CLI under torchrun on 2 ranks against one process.
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

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.comm import GossipMesh
from repro_torch.core.sharding import P, shard_params
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
SMALL = {
    "deepseek_moe_16b": dict(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=4, head_dim=16, d_ff=32,
                             n_experts=8, experts_per_token=2,
                             vocab_size=256, dtype="float32"),
    "falcon_mamba_7b": dict(n_layers=2, d_model=32, ssm_state=8,
                            vocab_size=256, dtype="float32"),
    "jamba_1_5_large_398b": dict(n_layers=5, d_model=32, n_heads=8,
                                 n_kv_heads=4, head_dim=8, d_ff=32,
                                 dense_d_ff=64, n_experts=4, ssm_state=8,
                                 vocab_size=256, dtype="float32"),
    "pixtral_12b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
                        head_dim=8, d_ff=128, vocab_size=256,
                        n_frontend_tokens=3, dtype="float32"),
}
ARCHS = tuple(SMALL)
ENGINE_ARCHS = ("deepseek_moe_16b", "pixtral_12b")   # attention mixers only
GRIDS = ((1, 2), (1, 4))
B, S, N_DEC, N_GEN = 2, 12, 3, 5
TOL = dict(rtol=1e-5, atol=1e-5)
CHUNK = 16


def small_config(arch, dtype="float32"):
    return dataclasses.replace(get_config(arch), **{**SMALL[arch],
                                                    "dtype": dtype})


def _key(arch, grid):
    return f"{arch}|{grid[0]}x{grid[1]}"


def _inputs(arch):
    """Prompt tokens, the teacher-forced decode tokens and (VLM) the
    frontend embeddings, from a seeded numpy stream."""
    cfg = small_config(arch)
    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    out = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
           "dec": rng.integers(0, V, (B, N_DEC)).astype(np.int32)}
    if cfg.n_frontend_tokens:
        out["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _requests(vocab):
    reqs = poisson_load(4, rate=1000.0, vocab=vocab, prompt_buckets=(12, 40),
                        new_token_buckets=(6,), prompt_dist="exact", seed=4)
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
    jcfg = dataclasses.replace(jget_config(arch), **SMALL[arch])
    flat = {}
    _walk(jax.tree.map(np.asarray, init_lm(jcfg, jax.random.PRNGKey(0))), "",
          flat)
    rng = np.random.default_rng(7)
    for k, v in flat.items():
        if not np.any(v):
            flat[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    np.savez(path, **flat)


def _rec(log):
    return [[c.kind, list(c.shape), c.group_size, c.tag] for c in log]


def _forward(model, params, arch):
    """Prefill logits, ``N_DEC`` teacher-forced decode steps' logits after
    it (caches grown), greedy tokens; the collectives of the prefill and
    of the first decode step."""
    from repro_torch.core import comm
    inp = _inputs(arch)
    batch = {"tokens": torch.from_numpy(inp["tokens"])}
    if "frontend" in inp:
        batch["frontend"] = torch.from_numpy(inp["frontend"])
    L0 = S + (inp["frontend"].shape[1] if "frontend" in inp else 0)
    with torch.inference_mode():
        with comm.recording() as log_p:
            lg0, caches = model.prefill(params, batch)
        caches = grow_caches(model, caches, B, L0 + N_DEC)
        dec = []
        for i in range(N_DEC):
            tok = torch.from_numpy(inp["dec"][:, i:i + 1])
            with comm.recording() as log_d:
                lg, caches = model.decode_step(params, caches, tok, L0 + i)
            dec.append(lg.float().numpy())
            if i == 0:
                rec = [_rec(log_p), _rec(log_d)]
    out = greedy_generate(model, params, batch, N_GEN)
    return lg0.float().numpy(), np.stack(dec), out.numpy(), rec


def _engine_run(model, params):
    """Tokens, dispatches and the recorded collectives of the paged engine
    (plain attention: the kernels' CPU dispatch) on the closed trace."""
    from repro_torch.core import comm
    eng = ContinuousBatchingEngine(model, params, _pcfg(), attn_impl="kernel",
                                   prefill_chunk=CHUNK,
                                   max_step_tokens=2 * CHUNK, device="cpu")
    with comm.recording() as log:
        metrics = eng.run(_requests(model.cfg.vocab_size))
    toks = {str(r): t.tolist() for r, t in sorted(eng.completed.items())}
    return toks, metrics, _rec(log)


def _rank_worker(rank, world, d):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.core.sharding import gather_params
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
            lg0, dec, toks, colls = _forward(model, params, arch)
            out[f"{key}|prefill"], out[f"{key}|decode"] = lg0, dec
            out[f"{key}|greedy"] = toks
            back = gather_params(params, model.param_specs(), mesh)
            r = {"collectives": colls,
                 "gathered_equal": sorted(back) == sorted(full) and all(
                     torch.equal(back[k], full[k]) for k in full)}
            if arch in ENGINE_ARCHS:
                r["engine"], metrics, r["engine_log"] = _engine_run(model,
                                                                    params)
                r["dispatches"] = metrics["steps"] + metrics["mixed_steps"]
            # bf16: the rank-local init of the bf16 variant, from seed 0
            m16 = build_model(small_config(arch, "bfloat16"), mesh=mesh)
            p16 = init_lm_rank(m16.cfg, torch.Generator().manual_seed(0),
                               mesh.axis_index("model"), g[1])
            lg0, dec, _, _ = _forward(m16, p16, arch)
            out[f"{key}|bf16_prefill"], out[f"{key}|bf16_decode"] = lg0, dec
            rec[key] = r
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
from repro.models.moe import set_moe_mesh
from repro.serve.engine import (build_serve_step, greedy_generate,
                                grow_caches, serve_cache_specs,
                                serve_param_specs)

spec = json.loads(open(sys.argv[1]).read())
d = sys.argv[2]
B, S, N_DEC = spec["B"], spec["S"], spec["n_dec"]
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


def ops(text):
    got = []
    for line in text.splitlines():
        for kind in ("all-reduce", "all-gather", "all-to-all",
                     "collective-permute", "reduce-scatter"):
            if re.search(r"\\s%s(-start)?\\(" % kind, line):
                m = re.search(r"=\\s*\\(?(\\w+)\\[([\\d,]*)\\]", line)
                got.append([kind, [int(n) for n in m.group(2).split(",")
                                   if n]])
    return sorted(got)


def decode_steps(step, params, caches, L0):
    lgs = []
    for i in range(N_DEC):
        tok = jnp.asarray(dec[:, i:i + 1])
        lg, caches = step(params, caches, tok, jnp.asarray(L0 + i, jnp.int32))
        lgs.append(np.asarray(lg, np.float32))
    return np.stack(lgs)


for arch in spec["archs"]:
    cfg = dataclasses.replace(get_config(arch), **spec["small"][arch])
    model = build_model(cfg)
    moe = bool(cfg.n_experts)
    like = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    a = dict(np.load(f"{d}/{arch}.npz"))
    flat, tdef = jax.tree_util.tree_flatten_with_path(like)
    leaves = ["|".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path) for path, _ in flat]
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(a[k]) for k in leaves])
    inp = dict(np.load(f"{d}/{arch}_inputs.npz"))
    dec = inp["dec"]
    batch = {"tokens": jnp.asarray(inp["tokens"])}
    b_sh = {"tokens": NamedSharding(mesh, P("data", None))}
    if "frontend" in inp:
        batch["frontend"] = jnp.asarray(inp["frontend"])
        b_sh["frontend"] = NamedSharding(mesh, P("data", None, None))
    L0 = S + (inp["frontend"].shape[1] if "frontend" in inp else 0)
    # unsharded: the plain MoE layer
    set_moe_mesh(None)
    lg0, caches = model.prefill(params, batch)
    caches = grow_caches(model, caches, B, L0 + N_DEC)
    out[f"{arch}|prefill"] = np.asarray(lg0, np.float32)
    out[f"{arch}|decode"] = decode_steps(model.decode_step, params, caches,
                                         L0)
    out[f"{arch}|greedy"] = np.asarray(greedy_generate(model, params, batch,
                                                       spec["n_gen"]))
    # sharded: the serving layout, the MoE layer expert-parallel on the mesh
    if moe:
        set_moe_mesh(mesh, impl="shard_map")
    pspecs = serve_param_specs(model, fsdp=False, multi_pod=False)
    cspecs = serve_cache_specs(model, multi_pod=False)
    p_sh = shard(params, pspecs)
    pre = jax.jit(lambda p, b: model.prefill(p, b),
                  in_shardings=(shardings(pspecs), b_sh)).lower(
                      p_sh, batch).compile()
    lg0_s, caches_s = pre(p_sh, batch)
    caches_s = grow_caches(model, caches_s, B, L0 + N_DEC)
    c_sh = shardings(cspecs)
    t_sh = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    dec_jit = jax.jit(lambda p, c, t, s: model.decode_step(p, c, t, s),
                      in_shardings=(shardings(pspecs), c_sh, t_sh, rep),
                      out_shardings=(rep, c_sh))
    out[f"{arch}|prefill_sharded"] = np.asarray(lg0_s, np.float32)
    out[f"{arch}|decode_sharded"] = decode_steps(
        dec_jit, p_sh, shard(caches_s, cspecs), L0)
    # the compiled HLO's collectives, lowered as launch/dryrun.py lowers
    step = jax.jit(build_serve_step(model),
                   in_shardings=(shardings(pspecs), c_sh, t_sh, rep))
    nxt = jnp.asarray(dec[:, :1])
    dec_hlo = step.lower(p_sh, shard(caches_s, cspecs), nxt,
                         jnp.asarray(L0, jnp.int32)).compile().as_text()
    pre_hlo = pre.as_text()
    hlo[arch] = {"decode": count_collectives(dec_hlo),
                 "decode_ops": ops(dec_hlo),
                 "prefill": count_collectives(pre_hlo),
                 "prefill_ops": ops(pre_hlo)}
    set_moe_mesh(None)
np.savez(f"{d}/jax.npz", **out)
json.dump(hlo, open(f"{d}/jax.json", "w"))
print("JAX_TP_FAMILIES_OK")
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_families")
    for arch in ARCHS:
        _reference_weights(arch, d / f"{arch}.npz")
        np.savez(d / f"{arch}_inputs.npz", **_inputs(arch))
    spec = {"archs": ARCHS, "small": SMALL, "B": B, "S": S, "n_dec": N_DEC,
            "n_gen": N_GEN}
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
        lg0, dec, toks, _ = _forward(model, params, arch)
        plain[arch] = {"prefill": lg0, "decode": dec, "greedy": toks}
        if arch in ENGINE_ARCHS:
            plain[arch]["engine"] = _engine_run(model, params)[0]
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
# (a) spec parity
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
    """``lm_param_specs``, ``lm_cache_specs``, ``serve_param_specs`` (fsdp
    off, one pod and multi-pod), ``serve_cache_specs`` (both) and, for
    the attention-only families, ``paged_pool_specs`` equal the
    reference's ``PartitionSpec`` trees path by path; every parameter
    path has its spec.  A family with SSM mixers has no paged pools: its
    ``paged_pool_specs`` raises."""
    from repro.configs import get_config as jget_config
    from repro.models import transformer as jtf
    from repro.models.api import build_model as jbuild
    from repro.serve import engine as jengine
    from repro.serve.paged_cache import paged_pool_specs as jpool_specs
    cfg = small_config(arch)
    jcfg = dataclasses.replace(jget_config(arch), **SMALL[arch])
    jmodel, model = jbuild(jcfg), build_model(cfg)
    pairs = [(jtf.lm_param_specs(jcfg), lm_param_specs(cfg)),
             (jtf.lm_cache_specs(jcfg), lm_cache_specs(cfg))]
    for mp_ in (False, True):
        pairs.append((jengine.serve_param_specs(jmodel, fsdp=False,
                                                multi_pod=mp_),
                      serve_param_specs(model, fsdp=False, multi_pod=mp_)))
        pairs.append((jengine.serve_cache_specs(jmodel, mp_),
                      serve_cache_specs(model, mp_)))
    if arch in ENGINE_ARCHS:
        pairs.append((jpool_specs(jcfg), paged_pool_specs(cfg)))
    else:
        with pytest.raises(NotImplementedError, match="attention"):
            paged_pool_specs(cfg)
    for want, got in pairs:
        assert _flat(got) == _flat(want)
    assert sorted(lm_param_specs(cfg)) == sorted(model.meta())
    assert model.param_specs() == lm_param_specs(cfg)
    assert model.cache_specs() == lm_cache_specs(cfg)


# ---------------------------------------------------------------------------
# (b) the layout: rank-local init, the paired in_proj
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
    block: bit-equal to ``shard_params`` of the whole init on every rank
    and to ``weights.tp_block`` of its numpy form, ``in_proj``'s paired
    cut included (rank m's columns of x, then the same columns of z); the
    rank holds its share of the experts, of the shared experts' columns
    and of the SSM channels."""
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
        for path, leaf in got.items():
            if path.endswith("ssm|in_proj"):
                di, n = cfg.d_inner, cfg.d_inner // count
                whole = full[path]
                assert torch.equal(leaf, torch.cat(
                    [whole[..., m * n:(m + 1) * n],
                     whole[..., di + m * n:di + (m + 1) * n]], -1)), path
            if path.endswith("ssm|A_log"):
                assert leaf.shape[1] == cfg.d_inner // count
            if path.endswith("moe|w_gate"):
                assert leaf.shape[1] == cfg.n_experts // count
            if path.endswith("moe|shared|w_down"):
                assert leaf.shape[1] == cfg.n_shared_experts * cfg.d_ff // count
        assert got["embed"].shape[0] == cfg.vocab_size // count


def test_init_holds_one_draw_at_a_time():
    """``init_from_specs`` (under ``init_lm`` and ``init_lm_rank``) frees
    each layer slice's draw before the next one: at every draw no earlier
    draw is alive, so the init's peak is the kept parameters plus one
    slice (a Jamba MoE slice is 12.9 GB in f32; four ranks drawing on one
    card ran out of memory holding two)."""
    import weakref
    from repro_torch.models.transformer import init_from_specs
    drawn, alive = [], []

    def init(shape, device):
        alive.append(sum(r() is not None for r in drawn))
        t = torch.ones(shape)
        drawn.append(weakref.ref(t))
        return t

    specs = {f"blocks|0|w{i}": ((3, 4, 8), torch.float32, init)
             for i in range(3)}
    keep = {"blocks|0|w1": (2, 2, 4, 1)}
    out = init_from_specs(specs, torch.Generator(), keep)
    assert alive == [0] * 9
    assert out["blocks|0|w1"].shape == (3, 4, 2)


def test_splits_that_do_not_fit_raise():
    """64 experts over 3 ranks, SSM channels that do not divide, and the
    VLM's heads: ``ValueError`` from the check, the model on the grid and
    the rank-local init; the encoder-decoder family raises
    ``NotImplementedError`` naming the odd vocabulary."""
    moe = get_config("deepseek_moe_16b")
    with pytest.raises(ValueError, match="64 experts"):
        check_tp_split(dataclasses.replace(moe, n_heads=12, n_kv_heads=12,
                                           vocab_size=3 * 1024, d_ff=1536),
                       3)
    check_tp_split(moe, 4)
    check_tp_split(get_config("falcon_mamba_7b"), 4)
    check_tp_split(get_config("jamba_1_5_large_398b"), 4)
    check_tp_split(get_config("pixtral_12b"), 4)
    ssm = dataclasses.replace(small_config("falcon_mamba_7b"), d_model=40,
                              vocab_size=240)
    with pytest.raises(ValueError, match="80 SSM channels"):
        check_tp_split(ssm, 3)
    with pytest.raises(ValueError, match="SSM channels"):
        build_model(ssm, mesh=_grid_stub(0, 3))
    with pytest.raises(ValueError, match="4 KV heads"):
        init_lm_rank(dataclasses.replace(small_config("pixtral_12b"),
                                         vocab_size=240),
                     torch.Generator().manual_seed(0), 0, 3)
    whisper = get_smoke_config("whisper_small")
    for fn in (lambda: check_tp_split(get_config("whisper_small"), 2),
               lambda: lm_param_specs(whisper),
               lambda: lm_cache_specs(whisper),
               lambda: build_model(whisper, mesh=_grid_stub(0, 2))):
        with pytest.raises(NotImplementedError, match="51,865"):
            fn()


def test_frontend_joins_after_the_embedding_sum():
    """A VLM's frontend rows are concatenated after the vocab-parallel
    embedding has been summed: with a model axis whose sum doubles (a
    stub of two ranks holding the same rows), the token rows double and
    the frontend rows pass unchanged — before the sum they would double
    too."""
    from repro_torch.models.transformer import _embed_inputs

    class Twice:
        size, index = 2, 0

        def embed(self, table, tokens):
            return 2 * table[tokens]

    table = torch.randn(16, 4)
    tokens = torch.tensor([[1, 5, 7]])
    fe = torch.randn(1, 2, 4)
    x = _embed_inputs({"embed": table}, tokens, fe, Twice())
    assert torch.equal(x[:, :2], fe)
    assert torch.equal(x[:, 2:], 2 * table[tokens])


# ---------------------------------------------------------------------------
# (c) the ranks against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_match_reference(results, arch, grid):
    """Every rank of the grid: prefill and ``N_DEC`` decode steps' logits
    within rtol / atol 1e-5 of the reference sharded on 4 host devices
    (the MoE layer expert-parallel), of the reference unsharded and of
    the port's one process; greedy tokens equal to the unsharded
    reference's and one process's; ``gather_params`` of its blocks the
    whole weights, bit for bit (the paired ``in_proj`` put back); a bf16
    model's logits bit-equal on every rank of the grid."""
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
        for want in (j[f"{arch}|greedy"], plain["greedy"]):
            np.testing.assert_array_equal(got[f"{key}|greedy"], want)
        assert results["recs"][r][key]["gathered_equal"]
        for what in ("bf16_prefill", "bf16_decode"):
            assert np.array_equal(got[f"{key}|{what}"],
                                  results["ranks"][0][f"{key}|{what}"]), (
                key, r, what)
            assert np.isfinite(got[f"{key}|{what}"]).all()


# ---------------------------------------------------------------------------
# (d) the paged engine over the ranks
# ---------------------------------------------------------------------------

def _sums_a_forward(cfg):
    """The sums over the model axis of one forward: the embedding's, then
    per layer one after the mixer (``wo``; a Mamba block's ``out_proj``,
    plus its ``x_proj``) and one after the FFN (dense or MoE, shared
    experts folded in; none for a Mamba layer without one)."""
    from repro_torch.configs.base import layer_kinds
    n = 1
    for mixer, ffn in layer_kinds(cfg):
        n += (2 if mixer == "ssm" else 1) + (ffn != "none")
    return n


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_paged_engine_over_ranks(results, arch, grid):
    """The continuous engine over the grid's ranks (pools of K / M heads):
    tokens equal to the port's one-process engine on the same closed
    trace; each dispatch sums 2L + 1 times over the model axis (a mixed
    one twice that) and gathers the logits once (twice), and makes no
    other collective."""
    key = _key(arch, grid)
    want = results["plain"][arch]["engine"]
    n_sums = _sums_a_forward(small_config(arch))
    assert n_sums == 2 * SMALL[arch]["n_layers"] + 1
    for r in _members(grid):
        rec = results["recs"][r][key]
        assert rec["engine"] == want
        kinds = [c[0] for c in rec["engine_log"]]
        assert kinds.count("all-reduce") == n_sums * rec["dispatches"]
        assert kinds.count("all-gather") == rec["dispatches"]
        assert all(c[2] == grid[1] and c[3] == "tp"
                   for c in rec["engine_log"])


# ---------------------------------------------------------------------------
# (e) the collectives a forward, beside the reference's HLO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_against_reference_hlo(results, arch):
    """The port's record of a prefill and a decode forward at ``(1, 4)``:
    one all-reduce of the embedding, then each layer's in order — an
    attention layer's after ``wo`` ``(B, S, d)``; a Mamba layer's after
    ``x_proj`` ``(B, S, dt_rank + 2·d_state)`` and after ``out_proj``;
    a dense FFN's after ``w_down``; an MoE layer's one ``(B·S, d)`` sum
    of its routed and shared partials — and one all-gather of the
    logits, every one over the 4 ranks of the model axis, tagged ``tp``:
    2L + 1 sums for the MoE, SSM and VLM models.  The reference's
    compiled programs beside them (:func:`_reference_hlo`): the same sums
    executed, and the collectives that differ named."""
    from repro_torch.configs.base import layer_kinds
    cfg = small_config(arch)
    d, V = cfg.d_model, cfg.vocab_size
    xp = cfg.dt_rank + 2 * cfg.ssm_state
    key = _key(arch, (1, 4))
    for rows, which in ((S, 0), (1, 1)):
        n_rows = rows + (cfg.n_frontend_tokens if which == 0 else 0)
        want = [["all-reduce", [B, rows, d], 4, "tp"]]
        for mixer, ffn in layer_kinds(cfg):
            if mixer == "ssm":
                want += [["all-reduce", [B, n_rows, xp], 4, "tp"],
                         ["all-reduce", [B, n_rows, d], 4, "tp"]]
            else:
                want.append(["all-reduce", [B, n_rows, d], 4, "tp"])
            if ffn == "moe":
                want.append(["all-reduce", [B * n_rows, d], 4, "tp"])
            elif ffn == "dense":
                want.append(["all-reduce", [B, n_rows, d], 4, "tp"])
        want.append(["all-gather", [B, 1, V], 4, "tp"])
        for rec in results["recs"]:
            assert rec[key]["collectives"][which] == want, (arch, which)
        assert len(want) - 1 == _sums_a_forward(cfg)
    hlo = results["hlo"][arch]
    for which, rows in (("prefill", S), ("decode", 1)):
        want, executed = _reference_hlo(cfg, rows, which == "decode")
        got = hlo[f"{which}_ops"]
        assert got == want, (which, got)
        assert hlo[which] == {k: sum(o[0] == k for o in want)
                              for k in {o[0] for o in want}}
        # executed, the scan's body once a block: the port's sums
        assert executed == _sums_a_forward(cfg)


def _reference_hlo(cfg, rows, decode):
    """The collectives of the reference's compiled prefill (``rows`` S)
    or decode step (``rows`` 1, ``build_serve_step``) at ``(1, 4)``, as
    its HLO text holds them — the stacked layers' written once in the
    scan's body — and the all-reduces it executes.  The embedding's sum;
    a layer's as the port's (ROADMAP §3 names each difference): a Mamba
    block's ``x_proj`` and ``out_proj`` sums, and four
    collective-permutes that pair the x and z columns of the contiguous
    ``in_proj`` split (three of ``d_inner / M`` columns, one of ``2 ·
    d_inner / M``; the port cuts ``in_proj`` paired and moves nothing);
    an MoE layer's one sum — the shared experts' partial folded into the
    routed psum by XLA too, in ``(B, S, d)`` where it has shared experts
    and the shard_map's ``(B·S, d)`` where not; the decode step's two
    ``(B, 4)`` all-gathers of each rank's argmax value and index where the
    port gathers the logits."""
    from repro_torch.configs.base import block_period, layer_kinds
    d, M = cfg.d_model, 4
    n = rows + (cfg.n_frontend_tokens if not decode else 0)
    xp = cfg.dt_rank + 2 * cfg.ssm_state
    body = []
    for mixer, ffn in layer_kinds(cfg)[:block_period(cfg)]:
        if mixer == "ssm":
            body += [["all-reduce", [B, n, xp]], ["all-reduce", [B, n, d]]]
            body += [["collective-permute", [B, n, cfg.d_inner // M]]] * 3
            body.append(["collective-permute", [B, n, 2 * cfg.d_inner // M]])
        else:
            body.append(["all-reduce", [B, n, d]])
        if ffn == "dense" or ffn == "moe" and cfg.n_shared_experts:
            body.append(["all-reduce", [B, n, d]])
        elif ffn == "moe":
            body.append(["all-reduce", [B * n, d]])
    ops = [["all-reduce", [B, rows, d]]] + body
    if decode:
        ops += [["all-gather", [B, M]]] * 2
    n_blocks = cfg.n_layers // block_period(cfg)
    executed = 1 + n_blocks * sum(o[0] == "all-reduce" for o in body)
    return sorted(ops), executed


# ---------------------------------------------------------------------------
# (f) the serve CLI under torchrun
# ---------------------------------------------------------------------------

CONTINUOUS = ["--continuous-batching", "--prefill-chunk", "8",
              "--max-step-tokens", "16", "--prompt-dist", "exact",
              "--requests", "4"]


def _metrics(stdout):
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("serve metrics: "))
    return json.loads(line[len("serve metrics: "):])


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "falcon_mamba_7b"])
def test_serve_cli_under_torchrun_equals_one_process(tmp_path, arch):
    """The MoE model under torchrun on 2 ranks with ``--moe-impl
    shard_map`` is served in the reference's serving layout (experts over
    the ranks, attention and the shared experts split): the continuous
    engine from each rank's block of a consensus file (``--ckpt``), every
    rank's token digest equal to the one-process CLI's.  The SSM model
    under torchrun: the fixed batch from the rank-local init, every
    rank's tokens equal to one process's."""
    from repro_torch.weights import tensor_to_array
    cli = ["--arch", arch, "--smoke", "--device", "cpu"]
    if arch == "deepseek_moe_16b":
        params = build_model(get_smoke_config(arch)).init(
            torch.Generator().manual_seed(3))
        np.savez(tmp_path / "consensus.npz",
                 **{k: tensor_to_array(v) for k, v in params.items()})
        cli += CONTINUOUS + ["--ckpt", str(tmp_path / "consensus.npz")]
        flags = ["--moe-impl", "shard_map"]
    else:
        cli += ["--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]
        flags = []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *cli], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert one.returncode == 0, one.stderr[-3000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *cli,
         *flags], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=180)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert "tp grid=(1, 2)" in ranks.stdout
    if arch == "deepseek_moe_16b":
        assert "experts/rank=2" in ranks.stdout
        want, got = _metrics(one.stdout), _metrics(ranks.stdout)
        assert got["rank_token_digests"] == [want["token_digest"]] * 2
        assert got["params_sha256"] == want["params_sha256"]
    else:
        assert "d_inner/rank=256" in ranks.stdout
        want = [ln for ln in one.stdout.splitlines() if "  req" in ln]
        got = [ln for ln in ranks.stdout.splitlines() if "  req" in ln]
        assert got == want and len(want) == 2
        digests = json.loads(next(
            ln for ln in ranks.stdout.splitlines()
            if ln.startswith("rank token digests: "))[20:].replace("'", '"'))
        assert len(set(digests)) == 1


def test_moe_under_torchrun_without_shard_map_raises(tmp_path):
    """An MoE model under torchrun without ``--moe-impl shard_map``: the
    CLI raises and names the flag (the ``gspmd`` form has no multi-rank
    counterpart in the port)."""
    from repro_torch.launch import serve
    env = {"RANK": "0", "WORLD_SIZE": "2"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with pytest.raises(ValueError, match="--moe-impl shard_map"):
            serve.main(["--arch", "deepseek_moe_16b", "--smoke", "--device",
                        "cpu"])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
