"""The port's MoE serving against the JAX package's, on the
``deepseek_moe_16b`` smoke config in f32.

Weights are the JAX package's ``init_lm`` with the norm weights set to
seeded values, carried across; prompts and traces are the same numpy
draws.  Each case runs at the smoke config's dropless capacity (8.0) and
at 1.25, where the reference is asserted to drop assignments: in serving
the decode batch's idle slots and the chunk's padding rows are routed
too and take capacity from live tokens, so the port must hand its MoE the
rows the reference's engine does.

* paged decode, chunked-prefill and mixed logits match JAX's at atol
  1e-4, rtol 1e-3 (``test_torch_serve.py``'s bound), argmax exact;
* at capacity 1.25 the port's engines (legacy and chunked, ``attn_impl``
  ``ref`` and ``kernel``, the plain kernel versions on the CPU) emit
  exactly the JAX engine's greedy tokens; ``greedy_generate`` equals
  JAX's at both capacities.

The paged-entry checks take any model pair; ``test_torch_dense_variants``
runs them on the QK-norm config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro.serve.paged_cache import PagedCacheConfig as JPagedCacheConfig
from repro.serve.paged_cache import init_paged_pools as j_init_pools
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro.serve.scheduler import poisson_load as j_poisson_load

from repro_torch import weights
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.serve import (ContinuousBatchingEngine, PageAllocator,
                               PagedCacheConfig, Request, greedy_generate,
                               init_paged_pools, poisson_load)

from test_torch_moe import count_drops, drop_counter, seeded_norms  # noqa: F401,E501

torch.set_num_threads(1)  # xdist workers share the cores

RTOL, ATOL = 1e-3, 1e-4
ARCH = "deepseek_moe_16b"
CAPACITIES = [8.0, 1.25]
PROMPTS = (5, 12, 20)


@functools.lru_cache(maxsize=None)
def models(arch, capacity_factor=None):
    """(JAX model, JAX params, port model, port params) of ``arch``'s
    smoke config (at ``capacity_factor`` when given), norms seeded."""
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jmodel = jbuild_model(jcfg)
    jparams = seeded_norms(jmodel.init(jax.random.PRNGKey(0)), seed=4)
    tparams = weights.params_from_tree(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, build_model(tcfg), tparams


def pcfg(max_slots=4, cls=PagedCacheConfig):
    return cls(page_size=8, num_pages=1 + max_slots * 8, max_slots=max_slots,
               max_context=64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _requests(vocab, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, tokens=rng.integers(0, vocab, (S,))
                    .astype(np.int32), max_new=max_new, arrival=0.0)
            for i, S in enumerate(PROMPTS)]


def check_decode_paged(jmodel, jparams, tmodel, tparams):
    """Three ragged prompts admitted by both engines (legacy prefill +
    page scatter), then four ``decode_step_paged`` steps over the slot
    batch, one slot idle: the live slots' logits agree."""
    jeng = JEngine(jmodel, jparams, pcfg(cls=JPagedCacheConfig))
    teng = ContinuousBatchingEngine(tmodel, tparams, pcfg(), device="cpu")
    for r in _requests(tmodel.cfg.vocab_size):
        assert jeng.try_admit(r) and teng.try_admit(r)
    np.testing.assert_array_equal(jeng.tok, teng.tok)
    pt = teng.alloc.page_table.copy()
    for step in range(4):
        lens = teng.alloc.lengths.copy()
        kv = np.where(teng.alloc.active, lens + 1, 0).astype(np.int32)
        want, jeng.pools = jax.jit(jmodel.decode_step_paged)(
            jparams, jeng.pools, jnp.asarray(jeng.tok), jnp.asarray(lens),
            jnp.asarray(pt), jnp.asarray(kv))
        with torch.inference_mode():
            got, _ = tmodel.decode_step_paged(
                tparams, teng.pools, _t(teng.tok), _t(lens), _t(pt), _t(kv),
                attn_fn=ref.paged_attention_ref)
        want = np.asarray(want, np.float32)[:3, 0]
        got = got.numpy()[:3, 0]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for i in range(3):
            jeng.tok[i, 0] = teng.tok[i, 0] = int(want[i].argmax())
            jeng.alloc.advance(i)
            teng.alloc.advance(i)


def check_prefill_paged(jmodel, jparams, tmodel, tparams, S=20, C=8):
    """An S-token prompt in C-token chunks (the last one padded) through
    ``prefill_chunk_paged``: every chunk's live rows agree."""
    tokens = np.random.default_rng(7).integers(
        0, tmodel.cfg.vocab_size, (S,)).astype(np.int32)
    jpools = j_init_pools(jmodel.cfg, pcfg(cls=JPagedCacheConfig))
    tpools = init_paged_pools(tmodel.cfg, pcfg(), "cpu")
    alloc = PageAllocator(pcfg())
    slot = alloc.admit(S, S, chunked=True)
    pt_row = alloc.page_table[slot]
    for cur in range(0, S, C):
        n = min(C, S - cur)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = tokens[cur:cur + n]
        want, jpools = jax.jit(jmodel.prefill_chunk_paged)(
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


def check_mixed(jmodel, jparams, tmodel, tparams, S=14, C=8):
    """Two decoding slots and one mid-prefill: mixed steps give JAX's
    decode and chunk logits."""
    jeng = JEngine(jmodel, jparams, pcfg(cls=JPagedCacheConfig))
    teng = ContinuousBatchingEngine(tmodel, tparams, pcfg(), device="cpu")
    for r in _requests(tmodel.cfg.vocab_size)[:2]:
        assert jeng.try_admit(r) and teng.try_admit(r)
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
        pt, _ = teng.alloc.decode_tables()
        pt_row = teng.alloc.page_table[slot]
        want_d, want_c, jeng.pools = jax.jit(jmodel.decode_step_mixed)(
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
        pairs = ((np.asarray(want_d, np.float32)[:2, 0],
                  got_d.numpy()[:2, 0]),
                 (np.asarray(want_c, np.float32)[0, :n],
                  got_c.numpy()[0, :n]))
        for want, got in pairs:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        for i in range(2):
            jeng.tok[i, 0] = teng.tok[i, 0] = int(pairs[0][0][i].argmax())
            jeng.alloc.advance(i)
            teng.alloc.advance(i)
        jeng.alloc.advance_prefill(slot, n)
        teng.alloc.advance_prefill(slot, n)


@pytest.mark.parametrize("capacity_factor", CAPACITIES)
def test_paged_entries_logits_match_jax(capacity_factor, count_drops):
    jm, jp, tm, tp = models(ARCH, capacity_factor)
    check_decode_paged(jm, jp, tm, tp)
    check_prefill_paged(jm, jp, tm, tp)
    check_mixed(jm, jp, tm, tp)
    jax.effects_barrier()
    assert (sum(count_drops) > 0) == (capacity_factor < 2)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

PATHS = {"legacy": dict(), "chunked": dict(prefill_chunk=16,
                                           max_step_tokens=20)}
TRACE = dict(rate=500.0, prompt_buckets=(12, 40), new_token_buckets=(4, 9),
             seed=5)


@functools.lru_cache(maxsize=None)
def _jax_tokens(capacity_factor, path):
    """(tokens by request, dropped assignments) of the JAX engine."""
    jmodel, jparams, tmodel, _ = models(ARCH, capacity_factor)
    mp = pytest.MonkeyPatch()
    seen = drop_counter(mp)
    try:
        eng = JEngine(jmodel, jparams, pcfg(cls=JPagedCacheConfig),
                      attn_impl="ref", **PATHS[path])
        eng.run(j_poisson_load(6, vocab=tmodel.cfg.vocab_size, **TRACE))
        jax.effects_barrier()
    finally:
        mp.undo()
    return ({rid: toks.tolist() for rid, toks in eng.completed.items()},
            sum(seen))


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_tokens_match_jax_engine(path, attn_impl):
    """At capacity 1.25, where the reference drops: the padding trap."""
    capacity_factor = 1.25
    _, _, tmodel, tparams = models(ARCH, capacity_factor)
    eng = ContinuousBatchingEngine(tmodel, tparams, pcfg(),
                                   attn_impl=attn_impl, device="cpu",
                                   **PATHS[path])
    metrics = eng.run(poisson_load(6, vocab=tmodel.cfg.vocab_size, **TRACE))
    want, drops = _jax_tokens(capacity_factor, path)
    assert drops > 0
    assert {r: t.tolist() for r, t in eng.completed.items()} == want
    assert metrics["tokens"] == sum(len(t) for t in want.values())


@pytest.mark.parametrize("capacity_factor", CAPACITIES)
def test_greedy_generate_matches_jax(capacity_factor, count_drops):
    jmodel, jparams, tmodel, tparams = models(ARCH, capacity_factor)
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(j_greedy_generate(jmodel, jparams,
                                        {"tokens": jnp.asarray(toks)}, 6))
    got = greedy_generate(tmodel, tparams, {"tokens": _t(toks)}, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    jax.effects_barrier()
    assert (sum(count_drops) > 0) == (capacity_factor < 2)
