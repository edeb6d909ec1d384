"""Flash GQA attention: the port's plain version against the Pallas kernel.

JAX side: ``repro.kernels.ops.flash_attention(..., interpret=True)``, the
Pallas kernel in interpret mode on the CPU.  Port side:
``repro_torch.kernels.ref.flash_attention_ref``, the plain version that
the CUDA kernel is held against on the card, reached through
``repro_torch.kernels.ops.flash_attention`` on CPU tensors.  Inputs come
from numpy with a seed; bf16 inputs are the same f32 values rounded to
bf16 on both sides (round to nearest even, so the same bits).  Tolerances
are the JAX kernel tests' (``tests/test_kernels.py``): 2e-5 in f32, 3e-2
in bf16 (both sides round one f32 result to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)  # xdist workers share the cores

# the JAX package's ATTN_CASES: (B, H, K, Sq, Sk, hd, causal, window)
ATTN_CASES = [
    (1, 4, 4, 256, 256, 64, True, 0),      # MHA causal
    (2, 8, 2, 256, 256, 64, True, 0),      # GQA 4:1
    (1, 4, 1, 128, 384, 64, False, 0),     # MQA non-causal, Sq != Sk
    (1, 2, 2, 512, 512, 128, True, 256),   # sliding window
    (1, 15, 5, 128, 128, 64, True, 0),     # smollm-style 15:5 heads
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(B, H, K, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, hd), dtype=np.float32),
            rng.standard_normal((B, K, Sk, hd), dtype=np.float32),
            rng.standard_normal((B, K, Sk, hd), dtype=np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _pallas(jq, jk, jv, causal, window):
    out = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                               blk_q=128, blk_k=128, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=[f"c{i}" for i in range(len(ATTN_CASES))])
def test_plain_matches_pallas_kernel(case, dtype):
    B, H, K, Sq, Sk, hd, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(B, H, K, Sq, Sk, hd, 3),
                                       dtype)
    want = _pallas(jq, jk, jv, causal, window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def test_window_at_least_seq_equals_full():
    (tq, tk, tv), = [_both(_inputs(1, 2, 2, 256, 256, 64, 4), "f32")[1]]
    full = ops.flash_attention(tq, tk, tv, causal=True, window=0)
    win = ops.flash_attention(tq, tk, tv, causal=True, window=4096)
    assert torch.equal(full, win)


def test_fully_masked_rows_are_zero_on_both():
    """Causal, Sq = 512 over Sk = 128 keys with window 128: a query at
    position q ≥ 255 has no live key (k ≤ 127 < q − 127), so the Pallas
    kernel and the port give 0 there.  The JAX package's own
    ``ref.flash_attention_ref`` (its ``sdpa_ref``) gives the mean of v on
    those rows instead; ROADMAP.md records the difference."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 3, 1, 512, 128, 64, 5),
                                       "f32")
    want = _pallas(jq, jk, jv, True, 128)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=128).numpy()
    assert np.all(want[:, :, 255:] == 0) and np.all(got[:, :, 255:] == 0)
    assert np.all(np.abs(want[:, :, :255]).sum(-1) > 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    sdpa = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=True,
                                               window=128))
    np.testing.assert_allclose(sdpa[:, :, 255:],
                               np.broadcast_to(np.asarray(jv).mean(
                                   2, keepdims=True), sdpa[:, :, 255:].shape),
                               rtol=1e-5, atol=1e-5)


def test_op_contract_on_cpu():
    _, (tq, tk, tv) = _both(_inputs(1, 4, 2, 128, 256, 32, 6), "f32")
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(tq, tk, tv, causal=False)
    assert torch.equal(out, ref.flash_attention_ref(tq, tk, tv,
                                                    causal=False))
    assert ops.launch_counts()["flash_attention"] == before
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(tq[:, :, :100], tk, tv)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(tq, tk, tv, blk_k=96)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(tq[:, :3], tk, tv)
