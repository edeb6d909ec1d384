"""The port's serving slice against the JAX package's, on the smoke config.

Weights are made by the JAX package's ``init_lm`` and carried across with
``repro_torch.weights``; prompts and traces come from the same numpy
draws (``poisson_load``).  Variants as in the JAX serving tests: dense,
gqa (``n_kv_heads=2``) and a 16-row sliding window (ring pages), in f32.

* paged decode and chunked-prefill logits match JAX's at atol 1e-4,
  rtol 1e-3 (the JAX tests' own bound), argmax exact;
* the port's engines (legacy and chunked with a token budget, each with
  ``attn_impl`` ``ref`` and ``kernel`` — the plain kernel versions on the
  CPU) emit exactly the JAX engine's greedy tokens, and the port's
  ``greedy_generate`` exactly JAX's;
* the page allocator's state equals JAX's along one admit / advance /
  advance_prefill / release sequence;
* NaN-poisoned unallocated pages never reach a live slot;
* the serving CLI runs on the CPU and loads a JAX parameter checkpoint.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro.serve.paged_cache import PageAllocator as JPageAllocator
from repro.serve.paged_cache import PagedCacheConfig as JPagedCacheConfig
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro.serve.scheduler import poisson_load as j_poisson_load
from repro.train import checkpoint

from repro_torch import weights
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serve import (NULL_PAGE, ContinuousBatchingEngine,
                               PageAllocator, PagedCacheConfig, Request,
                               greedy_generate, init_paged_pools,
                               poisson_load)

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-3, 1e-4
VARIANTS = ("dense", "gqa", "window")
PROMPTS = (5, 12, 20)          # ragged: straddles page and window borders


def _cfgs(variant):
    jcfg, tcfg = jget_smoke_config("smollm_360m"), get_smoke_config(
        "smollm_360m")
    window = 16 if variant == "window" else 0
    if variant == "gqa":
        jcfg = dataclasses.replace(jcfg, n_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, n_kv_heads=2)
    return jcfg, tcfg, window


@functools.lru_cache(maxsize=None)
def _models(variant):
    """(JAX model, JAX params, port model, port params) of one variant."""
    jcfg, tcfg, window = _cfgs(variant)
    jmodel = jbuild_model(jcfg, decode_window=window)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = weights.params_from_tree(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(tcfg, decode_window=window), tparams


def _pcfg(window=0, max_slots=4, cls=PagedCacheConfig):
    ctx = window or 64
    return cls(page_size=8, num_pages=1 + max_slots * (-(-ctx // 8)),
               max_slots=max_slots, max_context=ctx, window=window)


def _requests(vocab, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, vocab, (S,))
                    .astype(np.int32), max_new=max_new, arrival=0.0)
            for i, S in enumerate(PROMPTS)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# logits of the paged entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_paged_logits_match_jax(variant):
    """Both engines admit the same ragged prompts (legacy prefill + page
    scatter); then four decode steps of ``decode_step_paged`` from the
    same tokens give the same logits, slot by slot."""
    jmodel, jparams, tmodel, tparams = _models(variant)
    window = tmodel.decode_window
    jeng = JEngine(jmodel, jparams, _pcfg(window, cls=JPagedCacheConfig))
    teng = ContinuousBatchingEngine(tmodel, tparams, _pcfg(window),
                                    device="cpu")
    for r in _requests(tmodel.cfg.vocab_size):
        assert jeng.try_admit(r) and teng.try_admit(r)
    np.testing.assert_array_equal(jeng.tok, teng.tok)
    pt = teng.alloc.page_table.copy()
    for step in range(4):
        lens = teng.alloc.lengths.copy()
        kv = np.where(teng.alloc.active, lens + 1, 0).astype(np.int32)
        if window:
            kv = np.minimum(kv, window).astype(np.int32)
        want, jeng.pools = jmodel.decode_step_paged(
            jparams, jeng.pools, jnp.asarray(jeng.tok), jnp.asarray(lens),
            jnp.asarray(pt), jnp.asarray(kv))
        with torch.inference_mode():
            got, _ = tmodel.decode_step_paged(
                tparams, teng.pools, _t(teng.tok), _t(lens), _t(pt), _t(kv),
                attn_fn=ref.paged_attention_ref)
        want = np.asarray(want, np.float32)[:3, 0]
        got = got.numpy()[:3, 0]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{variant} step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for i in range(3):
            jeng.tok[i, 0] = teng.tok[i, 0] = int(want[i].argmax())
            jeng.alloc.advance(i)
            teng.alloc.advance(i)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_chunk_paged_logits_match_jax(variant):
    """A 20-token prompt in 8-token chunks (the last one ragged) through
    ``prefill_chunk_paged``: every chunk's logits match JAX's."""
    jmodel, jparams, tmodel, tparams = _models(variant)
    window = tmodel.decode_window
    S, C = 20, 8
    tokens = np.random.default_rng(7).integers(
        0, tmodel.cfg.vocab_size, (S,)).astype(np.int32)
    from repro.serve.paged_cache import init_paged_pools as j_init_pools
    jpools = j_init_pools(jmodel.cfg, _pcfg(window, cls=JPagedCacheConfig))
    tpools = init_paged_pools(tmodel.cfg, _pcfg(window), "cpu")
    alloc = PageAllocator(_pcfg(window))
    slot = alloc.admit(S, S, chunked=True)
    pt_row = alloc.page_table[slot]
    for cur in range(0, S, C):
        n = min(C, S - cur)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = tokens[cur:cur + n]
        want, jpools = jmodel.prefill_chunk_paged(
            jparams, jpools, jnp.asarray(chunk), jnp.asarray(pt_row),
            jnp.asarray(cur, jnp.int32), jnp.asarray(n, jnp.int32))
        with torch.inference_mode():
            got, _ = tmodel.prefill_chunk_paged(
                tparams, tpools, _t(chunk), _t(pt_row), cur, n,
                attn_fn=ref.paged_prefill_attention_ref)
        want = np.asarray(want, np.float32)[0, :n]
        got = got.numpy()[0, :n]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        alloc.advance_prefill(slot, n)
    assert not alloc.prefilling[slot]


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_step_mixed_logits_match_jax(variant):
    """Two decoding slots and one slot mid-prefill: two mixed steps (the
    decode batch, then a chunk, in every layer) give JAX's decode and
    chunk logits."""
    jmodel, jparams, tmodel, tparams = _models(variant)
    window = tmodel.decode_window
    jeng = JEngine(jmodel, jparams, _pcfg(window, cls=JPagedCacheConfig))
    teng = ContinuousBatchingEngine(tmodel, tparams, _pcfg(window),
                                    device="cpu")
    for r in _requests(tmodel.cfg.vocab_size)[:2]:
        assert jeng.try_admit(r) and teng.try_admit(r)
    S, C = 14, 8
    prompt = np.random.default_rng(3).integers(
        0, tmodel.cfg.vocab_size, (S,)).astype(np.int32)
    slot = teng.alloc.admit(S, S, chunked=True)
    assert jeng.alloc.admit(S, S, chunked=True) == slot
    for cur in range(0, S, C):
        n = min(C, S - cur)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = prompt[cur:cur + n]
        lens = teng.alloc.lengths.copy()
        decoding = teng.alloc.active & ~teng.alloc.prefilling
        kv = np.where(decoding, lens + 1, 0).astype(np.int32)
        if window:
            kv = np.minimum(kv, window).astype(np.int32)
        pt, _ = teng.alloc.decode_tables()
        pt_row = teng.alloc.page_table[slot]
        want_d, want_c, jeng.pools = jmodel.decode_step_mixed(
            jparams, jeng.pools, jnp.asarray(jeng.tok), jnp.asarray(lens),
            jnp.asarray(pt), jnp.asarray(kv), jnp.asarray(chunk),
            jnp.asarray(pt_row), jnp.asarray(cur, jnp.int32),
            jnp.asarray(n, jnp.int32))
        with torch.inference_mode():
            got_d, got_c, _ = tmodel.decode_step_mixed(
                tparams, teng.pools, _t(teng.tok), _t(lens), _t(pt), _t(kv),
                _t(chunk), _t(pt_row), cur, n,
                attn_fn=ref.paged_attention_ref,
                prefill_attn_fn=ref.paged_prefill_attention_ref)
        pairs = ((np.asarray(want_d, np.float32)[:2, 0], got_d.numpy()[:2, 0]),
                 (np.asarray(want_c, np.float32)[0, :n], got_c.numpy()[0, :n]))
        for want, got in pairs:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for i in range(2):
            jeng.tok[i, 0] = teng.tok[i, 0] = int(pairs[0][0][i].argmax())
            jeng.alloc.advance(i)
            teng.alloc.advance(i)
        jeng.alloc.advance_prefill(slot, n)
        teng.alloc.advance_prefill(slot, n)
    assert not teng.alloc.prefilling[slot]


# ---------------------------------------------------------------------------
# engines: greedy tokens equal JAX's
# ---------------------------------------------------------------------------

PATHS = {"legacy": dict(), "chunked": dict(prefill_chunk=8,
                                           max_step_tokens=10)}


def _trace(vocab):
    return poisson_load(6, rate=500.0, vocab=vocab, prompt_buckets=(12, 20),
                        new_token_buckets=(4, 9), seed=5)


@functools.lru_cache(maxsize=None)
def _jax_tokens(variant, path):
    jmodel, jparams, tmodel, _ = _models(variant)
    eng = JEngine(jmodel, jparams,
                  _pcfg(tmodel.decode_window, cls=JPagedCacheConfig),
                  attn_impl="ref", **PATHS[path])
    reqs = j_poisson_load(6, rate=500.0, vocab=tmodel.cfg.vocab_size,
                          prompt_buckets=(12, 20),
                          new_token_buckets=(4, 9), seed=5)
    eng.run(reqs)
    return {rid: toks.tolist() for rid, toks in eng.completed.items()}


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_tokens_match_jax_engine(variant, path, attn_impl):
    """Same Poisson trace (numpy draws equal JAX's), same weights: the
    port's engine emits exactly the JAX engine's greedy tokens."""
    _, _, tmodel, tparams = _models(variant)
    reqs = _trace(tmodel.cfg.vocab_size)
    eng = ContinuousBatchingEngine(tmodel, tparams,
                                   _pcfg(tmodel.decode_window),
                                   attn_impl=attn_impl, device="cpu",
                                   **PATHS[path])
    metrics = eng.run(reqs)
    want = _jax_tokens(variant, path)
    assert {r: t.tolist() for r, t in eng.completed.items()} == want
    assert metrics["tokens"] == sum(len(t) for t in want.values())
    if path == "chunked":
        assert metrics["compile_count"] == 2


def test_poisson_load_matches_jax():
    for dist in ("bucket", "exact"):
        got = poisson_load(8, 100.0, vocab=64, prompt_buckets=(8, 24),
                           prompt_dist=dist, seed=3)
        want = j_poisson_load(8, 100.0, vocab=64, prompt_buckets=(8, 24),
                              prompt_dist=dist, seed=3)
        for g, w in zip(got, want):
            assert (g.rid, g.max_new, g.arrival) == (w.rid, w.max_new,
                                                     w.arrival)
            np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_generate_matches_jax(variant):
    jmodel, jparams, tmodel, tparams = _models(variant)
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(j_greedy_generate(jmodel, jparams,
                                        {"tokens": jnp.asarray(toks)}, 6))
    got = greedy_generate(tmodel, tparams, {"tokens": _t(toks)}, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# allocator, masked tail, compile accounting
# ---------------------------------------------------------------------------

def _alloc_state(al):
    return (al.page_table.tolist(), al.lengths.tolist(),
            list(al.free_pages), list(al.free_slots), al.active.tolist(),
            al.prompt_len.tolist(), al.prefill_cursor.tolist(),
            al.prefilling.tolist(), al.pages_in_use, al.n_active)


@pytest.mark.parametrize("window", [0, 16])
def test_allocator_state_matches_jax(window):
    kw = dict(page_size=8, num_pages=13, max_slots=3, max_context=32,
              window=window)
    ops_seq = [("admit", 10, 6, False), ("admit", 20, 17, True),
               ("advance", 0), ("advance_prefill", 1, 8),
               ("admit", 9, 9, True), ("advance_prefill", 1, 9),
               ("advance", 1), ("release", 0), ("advance_prefill", 2, 4),
               ("admit", 30, 25, False), ("release", 1),
               ("advance_prefill", 2, 5), ("advance", 2), ("release", 2)]
    jal, tal = JPageAllocator(JPagedCacheConfig(**kw)), PageAllocator(
        PagedCacheConfig(**kw))
    for op in ops_seq:
        outs = []
        for al in (jal, tal):
            if op[0] == "admit":
                outs.append(al.admit(op[1], op[2], chunked=op[3]))
            else:
                outs.append(getattr(al, op[0])(*op[1:]))
        assert outs[0] == outs[1], op          # the same slot id
        assert _alloc_state(tal) == _alloc_state(jal), op
        pt, lens = tal.decode_tables()
        jpt, jlens = jal.decode_tables()
        np.testing.assert_array_equal(pt, np.asarray(jpt))
        np.testing.assert_array_equal(lens, np.asarray(jlens))


def test_allocator_rejects_misuse():
    al = PageAllocator(PagedCacheConfig(page_size=8, num_pages=6,
                                        max_slots=3, max_context=24))
    s = al.admit(9, 5)
    with pytest.raises(RuntimeError):
        al.advance_prefill(s, 1)              # not mid-prefill
    al.release(s)
    with pytest.raises(RuntimeError):
        al.release(s)                         # double release
    with pytest.raises(ValueError):
        al.admit(4, 5)                        # context < prompt
    for bad in (dict(page_size=6, num_pages=8, max_slots=1, max_context=16),
                dict(page_size=8, num_pages=16, max_slots=1, max_context=64,
                     window=20),
                dict(page_size=8, num_pages=3, max_slots=1, max_context=64)):
        with pytest.raises(ValueError):
            PagedCacheConfig(**bad)


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
def test_paged_never_reads_unallocated_pages(attn_impl):
    """NaN-poison every page no live slot owns (the null page stays a clean
    write sink): live slots' logits are unchanged and finite."""
    _, _, tmodel, tparams = _models("dense")
    eng = ContinuousBatchingEngine(tmodel, tparams, _pcfg(), device="cpu")
    for r in _requests(tmodel.cfg.vocab_size):
        assert eng.try_admit(r)
    lens = eng.alloc.lengths.copy()
    kv = np.where(eng.alloc.active, lens + 1, 0).astype(np.int32)
    pt = eng.alloc.page_table.copy()
    attn_fn = {"ref": ref.paged_attention_ref,
               "kernel": ops.paged_attention}[attn_impl]
    owned = set(pt[eng.alloc.active].reshape(-1).tolist()) | {NULL_PAGE}
    bad = [p for p in range(eng.pcfg.num_pages) if p not in owned]
    outs = []
    with torch.inference_mode():
        for poison in (False, True):
            pools = tuple({n: t.clone() for n, t in pi.items()}
                          for pi in eng.pools)
            if poison:
                for pi in pools:
                    for t in pi.values():
                        t[:, bad] = float("nan")
            logits, _ = tmodel.decode_step_paged(
                tparams, pools, _t(eng.tok), _t(lens), _t(pt), _t(kv),
                attn_fn=attn_fn)
            outs.append(logits.numpy()[eng.alloc.active])
    assert np.isfinite(outs[1]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_legacy_compile_count_counts_distinct_shapes():
    """On the legacy path ``compile_count`` counts the decode step once and
    each prompt length and page count the first time it is served, the
    shapes the reference compiles for; a repeated shape adds nothing."""
    _, _, tmodel, tparams = _models("dense")
    eng = ContinuousBatchingEngine(tmodel, tparams, _pcfg(), device="cpu")

    def admit(S, rid):
        r = Request(rid=rid, tokens=np.arange(S, dtype=np.int32) % 17,
                    max_new=2, arrival=0.0)
        assert eng.try_admit(r)

    # (prompt length, rid, count): pages = ceil((S + 1) / 8)
    for S, rid, count in ((5, 0, 2), (12, 1, 4), (12, 2, 4), (13, 3, 5)):
        admit(S, rid)
        assert eng.compile_count == count, (S, rid)
    eng.step()
    assert eng.compile_count == 6              # + the decode step
    eng.reset()
    admit(20, 4)
    assert eng.compile_count == 8              # survives reset()


def test_engine_validates_its_arguments():
    _, _, tmodel, tparams = _models("window")
    for kw in (dict(prefill_chunk=17), dict(prefill_chunk=0),
               dict(prefill_chunk=8, max_step_tokens=0),
               dict(attn_impl="pallas")):
        with pytest.raises(ValueError):
            ContinuousBatchingEngine(tmodel, tparams, _pcfg(16),
                                     device="cpu", **kw)
    with pytest.raises(ValueError, match="window"):
        ContinuousBatchingEngine(tmodel, tparams, _pcfg(0), device="cpu")


# ---------------------------------------------------------------------------
# the serving CLI on the CPU
# ---------------------------------------------------------------------------

def test_serve_cli_on_cpu_loads_a_jax_checkpoint(tmp_path):
    """``--ckpt`` reads a parameter npz of ``repro.train.checkpoint.save``
    (the bare-path tree, as ``export_consensus`` writes it), and the
    chunked engine serves a trace with it and prints ``generated``."""
    _, jparams, _, _ = _models("dense")
    ckpt = str(tmp_path / "consensus.npz")
    checkpoint.save(ckpt, jparams)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "smollm_360m", "--smoke", "--continuous-batching",
         "--prefill-chunk", "8", "--max-step-tokens", "16", "--prompt-dist",
         "exact", "--max-slots", "4", "--page-size", "8", "--requests", "4",
         "--ckpt", ckpt],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"loaded consensus params from {ckpt}" in out.stdout
    assert "generated" in out.stdout and "compiles=2" in out.stdout


def test_serve_cli_main_returns_metrics_and_rejects_unported_archs():
    from repro_torch.launch import serve
    m = serve.main(["--device", "cpu", "--arch", "smollm_360m", "--smoke",
                    "--continuous-batching", "--requests", "3",
                    "--attn-impl", "ref"])
    assert m["requests"] == 3 and m["tokens"] > 0
    out = serve.main(["--device", "cpu", "--arch", "smollm_360m", "--smoke",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    # the encoder-decoder family serves its fixed batch (frames for the
    # encoder, n_frontend_tokens a request); it has no paged path, as in
    # the reference
    out = serve.main(["--device", "cpu", "--arch", "whisper_small",
                      "--smoke", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    with pytest.raises(NotImplementedError, match="no paged decode path"):
        serve.main(["--device", "cpu", "--arch", "whisper_small",
                    "--smoke", "--continuous-batching"])
    # the SSM family serves through greedy_generate only, as in the
    # reference: its state is fixed-size, not paged
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        serve.main(["--device", "cpu", "--arch", "falcon_mamba_7b",
                    "--smoke", "--continuous-batching"])


def test_run_fixed_batch_counts_match_jax():
    """The batch-synchronous baseline serves the same trace in the same
    number of dispatches and counts the same tokens as JAX's."""
    from repro.serve.scheduler import run_fixed_batch as j_run_fixed_batch
    from repro_torch.serve import run_fixed_batch
    jmodel, jparams, tmodel, tparams = _models("dense")
    reqs = _trace(tmodel.cfg.vocab_size)
    want = j_run_fixed_batch(jmodel, jparams, reqs, batch_size=4)
    got = run_fixed_batch(tmodel, tparams, reqs, batch_size=4, device="cpu")
    assert set(got) == set(want)
    for key in ("requests", "tokens", "steps"):
        assert got[key] == want[key], key
