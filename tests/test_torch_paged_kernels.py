"""The port's paged-attention ops against the JAX package's Pallas kernels.

On the CPU, ``repro_torch.kernels.ops.paged_attention`` and
``paged_prefill_attention`` run their plain versions; here they are held
against ``repro.kernels.ops.paged_attention`` / ``paged_prefill_attention``
(Pallas, interpret mode) and the JAX oracles, on NaN-poisoned pools, at
atol 2e-5 (the JAX tests' own bound: both sides are f32, the kernel's
online softmax and the oracle's full softmax sum in different orders).
The CUDA kernels themselves are held against the same plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import paged_attention as j_paged_attention
from repro.kernels.ops import paged_prefill_attention as j_paged_prefill
from repro.kernels.ref import paged_prefill_attention_ref as j_prefill_ref
from repro.models.attention import sdpa_ref as j_sdpa_ref

from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import paged_attention_flat
from repro_torch.kernels.paged_prefill import paged_prefill_flat
from repro_torch.serve.paged_cache import NULL_PAGE

torch.set_num_threads(1)  # xdist workers share the cores

ATOL = 2e-5

# (B, K, G, hd, page_size, num_pages, kv_len, {slot: pages}): the ragged
# batch of tests/test_serve.py (idle slot 1, full slot 2) and one at the
# full-width head geometry of smollm_360m (K 5, G 3, hd 64)
DECODE_CASES = {
    "ragged": (4, 2, 3, 16, 8, 12, [5, 0, 24, 17],
               {0: [1], 2: [2, 3, 4], 3: [5, 6, 7]}),
    "smollm_heads": (3, 5, 3, 64, 16, 10, [40, 0, 33],
                     {0: [4, 2, 9], 2: [1, 7, 3]}),
}


def _decode_inputs(case):
    B, K, G, hd, page_size, num_pages, kv_len, used = DECODE_CASES[case]
    rng = np.random.default_rng(0)
    n_pages = max(len(p) for p in used.values())
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(num_pages, page_size, K, hd)).astype(np.float32)
    vp = rng.normal(size=(num_pages, page_size, K, hd)).astype(np.float32)
    pt = np.zeros((B, n_pages), np.int32)
    for b, pages in used.items():
        pt[b, :len(pages)] = pages
    owned = {p for ps in used.values() for p in ps}
    for p in range(num_pages):
        if p not in owned:          # the null page too, as in the JAX test
            kp[p] = np.nan
            vp[p] = np.nan
    return q, kp, vp, pt, np.asarray(kv_len, np.int32), page_size


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_plain_paged_attention_matches_pallas(case):
    """Plain decode attention == the Pallas kernel on every slot, the idle
    one included (a zero tile).  The kernel reads the poisoned pools; the
    plain version, which gathers whole page-table rows (null tail entries
    included, at weight 0), gets them with NaN zeroed, as the JAX test
    feeds its oracle."""
    q, kp, vp, pt, kv_len, page_size = _decode_inputs(case)
    want = np.asarray(j_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(kv_len), page_size=page_size))
    got = ops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(np.nan_to_num(kp)),
        torch.from_numpy(np.nan_to_num(vp)), torch.from_numpy(pt),
        torch.from_numpy(kv_len), page_size=page_size).numpy()
    idle = kv_len == 0
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert (want[idle] == 0).all() and (got[idle] == 0).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


# (window, chunk_start, C, chunk_len): tests/test_chunked_prefill.py's
# KERNEL_CASES — linear first/mid/ragged-last chunks, ring before/at/long
# after the wrap, ragged ring tails, C == window
KERNEL_CASES = [
    (0, 0, 4, 4), (0, 4, 4, 4), (0, 9, 4, 3), (0, 20, 4, 1),
    (8, 0, 4, 4), (8, 4, 4, 4), (8, 7, 4, 4), (8, 8, 4, 4),
    (8, 13, 4, 3), (8, 37, 4, 2), (8, 37, 8, 8),
]
# + the full-width head geometry (K 5, G 3, hd 64), ring and linear
PREFILL_CASES = [(w, s, C, n, 2, 2, 8) for w, s, C, n in KERNEL_CASES] + [
    (16, 37, 8, 6, 5, 3, 64), (0, 21, 8, 5, 5, 3, 64)]


def _prefill_inputs(window, start, C, K, G, hd):
    """One slot's history written into NaN-poisoned pools (every row the
    slot does not own is NaN; the null page is a zero write sink)."""
    rng = np.random.default_rng(0)
    page_size, n_pages, num_pages = 4, 6, 16
    k_hist = rng.standard_normal((start, K, hd)).astype(np.float32)
    v_hist = rng.standard_normal((start, K, hd)).astype(np.float32)
    k_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    v_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    n_slot_pages = (window // page_size) if window else n_pages
    phys = rng.choice(np.arange(1, num_pages), size=n_slot_pages,
                      replace=False)
    pt_row = np.zeros((n_pages,), np.int32)
    pt_row[:n_slot_pages] = phys
    k_pool[NULL_PAGE] = 0.0
    v_pool[NULL_PAGE] = 0.0
    for p in range(start):
        row = p % window if window else p
        pg, r = row // page_size, row % page_size
        k_pool[pt_row[pg], r] = k_hist[p]
        v_pool[pt_row[pg], r] = v_hist[p]
    q = rng.standard_normal((1, C, K * G, hd)).astype(np.float32)
    k_c = rng.standard_normal((1, C, K, hd)).astype(np.float32)
    v_c = rng.standard_normal((1, C, K, hd)).astype(np.float32)
    return q, k_c, v_c, k_pool, v_pool, pt_row, page_size, k_hist, v_hist


@pytest.mark.parametrize("window,start,C,clen,K,G,hd", PREFILL_CASES)
def test_plain_paged_prefill_matches_pallas(window, start, C, clen, K, G,
                                            hd):
    """Plain prefill attention == the Pallas kernel == the JAX oracle ==
    dense causal attention over history + chunk, all on NaN-poisoned
    pools (finite output: no path read a row the slot does not own)."""
    q, k_c, v_c, k_pool, v_pool, pt_row, page_size, k_hist, v_hist = \
        _prefill_inputs(window, start, C, K, G, hd)
    ker = np.asarray(j_paged_prefill(
        q, k_c, v_c, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt_row), jnp.asarray(start, jnp.int32),
        jnp.asarray(clen, jnp.int32), page_size=page_size,
        window=window))[:, :clen]
    oracle = np.asarray(j_prefill_ref(
        q, k_c, v_c, jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(pt_row), start, clen, window=window))[:, :clen]
    got = ops.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k_c), torch.from_numpy(v_c),
        torch.from_numpy(k_pool), torch.from_numpy(v_pool),
        torch.from_numpy(pt_row), start, clen, page_size=page_size,
        window=window).numpy()[:, :clen]
    assert np.isfinite(got).all(), "plain version read a poisoned row"
    np.testing.assert_allclose(got, ker, atol=ATOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL)
    truth = np.asarray(j_sdpa_ref(
        jnp.asarray(q[:, :clen]),
        jnp.asarray(np.concatenate([k_hist, k_c[0, :clen]])[None]),
        jnp.asarray(np.concatenate([v_hist, v_c[0, :clen]])[None]),
        causal=True, window=window, q_offset=start))
    np.testing.assert_allclose(got, truth, atol=ATOL)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    """On the CPU the ops run the plain versions (identical results) and
    no kernel launch is counted; the CUDA wrappers refuse CPU tensors."""
    q, kp, vp, pt, kv_len, page_size = _decode_inputs("ragged")
    args = [torch.from_numpy(a) for a in (q, np.nan_to_num(kp),
                                          np.nan_to_num(vp), pt, kv_len)]
    before = ops.launch_counts()
    got = ops.paged_attention(*args, page_size=page_size)
    torch.testing.assert_close(
        got, ref.paged_attention_ref(*args, page_size=page_size),
        rtol=0, atol=0)
    pq, kc, vc, kpool, vpool, pt_row, ps, _, _ = _prefill_inputs(8, 13, 4,
                                                                 2, 2, 8)
    pargs = [torch.from_numpy(a) for a in (pq, kc, vc, kpool, vpool, pt_row)]
    got = ops.paged_prefill_attention(*pargs, 13, 3, page_size=ps, window=8)
    torch.testing.assert_close(
        got, ref.paged_prefill_attention_ref(*pargs, 13, 3, page_size=ps,
                                        window=8),
        rtol=0, atol=0, equal_nan=True)
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_attention_flat(*args, page_size=page_size)
    kern_q = pargs[0].reshape(4, 2, 2, 8).permute(1, 0, 2, 3).reshape(2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        paged_prefill_flat(kern_q.contiguous(),
                           pargs[1][0].permute(1, 0, 2).contiguous(),
                           pargs[2][0].permute(1, 0, 2).contiguous(),
                           *pargs[3:], 13, 3, page_size=ps, window=8)
    assert ops.launch_counts() == before


def test_kernel_wrappers_check_head_dim_and_dtype():
    q = torch.zeros(1, 1, 1, 12)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention_flat(q, q, q, q, q, page_size=8)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_flat(torch.zeros(1, 1, 1, 8, dtype=torch.float64),
                             q, q, q, q, page_size=8)
