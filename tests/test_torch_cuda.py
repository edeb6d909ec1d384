"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Bit-equality for the EDM updates (plain and with the bf16 / int8 EF
wire) and the combines (f32 / bf16 and the int8 dequantize-combine): the
kernels round every product, sum and quotient as the plain versions do
(explicitly rounded intrinsics, no FMA contraction); "bit-equal" lets a
NaN match any NaN.  The EF inputs hold the wire's edge tiles: all zero,
NaN, ±Inf beside finite values, ±Inf in an all-zero tile, tiny
magnitudes and exact rounding ties.  The paged attention kernels use an online softmax
where the plain versions gather and take a full softmax, so they agree to
a tolerance: f32 at atol 2e-5 (the JAX tests' bound for the Pallas
kernels); bf16, compared in f32, at atol 2e-5 + 2⁻⁷·|want| (both sides
round one f32 result to bf16, so they differ by at most one bf16 ulp of
the reference).  Kernel and plain version see the same pools; on pools
NaN-poisoned wherever the slot owns no row the kernel must give the same
bits, finite, so it read none of them.  The bf16 flash and prefill
kernels run on the tensor cores; their tile edges (head dims, groups,
partial query and key tiles, windows, the prefill's key splits) have
cases of their own, under the same gates.

These tests need a CUDA device and nvcc and skip elsewhere; this file
imports nothing of JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)  # xdist workers share the cores

ALPHA, BETA = 0.2, 0.9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _edm_inputs(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device)
            for _ in range(4)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(4, 1024, 128), (3, 24, 128),
                                   (1, 8, 128)])
def test_cuda_edm_update_bit_equal_to_plain(cuda, shape):
    x, g, m, psi = _edm_inputs(shape, cuda, seed=3)
    want = ref.edm_update_ref(x, g, m, psi, alpha=ALPHA, beta=BETA)
    before = ops.launch_counts()["edm_update"]
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    assert ops.launch_counts()["edm_update"] == before + 1
    for w, o in zip(want, got):
        assert torch.equal(w, o)
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA,
                             out=(m, psi, None))
    assert got[0].data_ptr() == m.data_ptr()
    for w, o in zip(want, got):
        assert torch.equal(w, o)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 3, 5, 16])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
def test_cuda_gossip_axpy_bit_equal_to_plain(cuda, n, dtype, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    operands = [torch.randn(4, 100, 128, generator=gen,
                            device=cuda).to(dtype) for _ in range(n)]
    weights = [1.0 / (k + 3) for k in range(n)]
    got = ops.gossip_axpy(operands, weights, out_dtype=out_dtype)
    want = ref.gossip_axpy_ref(operands, weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.requires_cuda
def test_cuda_wrappers_check_their_inputs(cuda):
    x, g, m, psi = _edm_inputs((2, 8, 128), cuda, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.edm_update_bus(x, g, m, psi.transpose(1, 2).contiguous()
                           .transpose(1, 2), alpha=ALPHA, beta=BETA)
    with pytest.raises(ValueError, match="operands"):
        ops.gossip_axpy([x] * 17, [0.0] * 17)
    with pytest.raises(ValueError, match="dtype"):
        ops.gossip_axpy([x.double()], [1.0])


@pytest.mark.requires_cuda
def test_cuda_fused_step_bit_equal_to_plain_step(cuda):
    """One EDM + ring-gossip step on a small bus: fused kernels against
    the plain chain and weighted sum."""
    from repro_torch.core import build_mixer, make_edm_bus, ring

    x, g, m, psi = _edm_inputs((4, 64, 128), cuda, seed=5)
    outs = []
    for fused in (True, False):
        mix = build_mixer(ring(4), mode="static", engine="ppermute",
                          agents_per_device=4, use_fused_kernel=fused)
        opt = make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=fused)
        x2, st = opt.step(x, g, {"m": m.clone(), "psi": psi.clone()})
        outs.append((x2, st["m"], st["psi"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert np.isfinite(outs[0][0].cpu().numpy()).all()


# ---------------------------------------------------------------------------
# the EF wire kernels
# ---------------------------------------------------------------------------

def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits, except that a NaN matches any NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    ia, ib = a.view(ints), b.view(ints)
    if torch.equal(ia, ib):
        return True
    return bool(((ia == ib) | (torch.isnan(a) & torch.isnan(b))).all())


def _ef_inputs(A, block_rows, n_tiles, device, seed):
    """(x, g, m, ψ, e) buses of A agents × n_tiles tiles.  Per agent the
    first 7 tiles are random, all zero, NaN, ±Inf beside finite values,
    ±Inf in an all-zero tile, tiny (~1e-30) and exact ties (absmax 127):
    x, g, m and ψ are zero on tiles 1, 4, 5 and 6 so that c = e there;
    the rest random."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (A, n_tiles, block_rows * 128)
    x, g, m, psi, e = (torch.randn(shape, generator=gen, device=device)
                       for _ in range(5))
    for t in (x, g, m, psi):
        t[:, [1, 4, 5, 6]] = 0.0
    e[:, 1] = 0.0
    e[:, 2, ::97] = float("nan")
    e[:, 3, 5], e[:, 3, 11] = float("inf"), -float("inf")
    e[:, 4] = 0.0
    e[:, 4, 7], e[:, 4, 13] = float("inf"), -float("inf")
    e[:, 5] *= 1e-30
    e[:, 6] = torch.randint(-127, 127, shape[2:], generator=gen,
                            device=device).float() + 0.5
    e[:, 6, 0] = 127.0
    return [t.reshape(A, n_tiles * block_rows, 128) for t in (x, g, m, psi,
                                                               e)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("A,block_rows,n_tiles", [(2, 8, 9), (3, 24, 8),
                                                  (1, 512, 7)])
def test_cuda_edm_update_ef_bit_equal_to_plain(cuda, fmt, A, block_rows,
                                               n_tiles):
    x, g, m, psi, e = _ef_inputs(A, block_rows, n_tiles, cuda, seed=A)
    want = ref.edm_update_ef_ref(x, g, m, psi, e, alpha=ALPHA, beta=BETA,
                                 fmt=fmt, block_rows=block_rows)
    before = ops.launch_counts()["edm_update_ef"]
    got = ops.edm_update_bus_ef(x, g, m, psi, e, alpha=ALPHA, beta=BETA,
                                fmt=fmt, block_rows=block_rows)
    torch.cuda.synchronize()
    assert ops.launch_counts()["edm_update_ef"] == before + 1
    flat = [got[0], got[1], *(got[2] if fmt == "int8" else (got[2],)),
            got[3]]
    want = [w.reshape(f.shape) for w, f in zip(want, flat)]
    for w, o in zip(want, flat):
        assert same_bits(o, w)
    if fmt == "int8":     # the edge rules, on the card
        q, scale = got[2]
        assert bool((scale[:, 1] == 0).all() and (scale[:, 4] == 0).all())
        assert bool((q.reshape(A, n_tiles, -1)[:, 4] == 0).all())
    # in place: m', ψ', e' over m, ψ, e
    m2, p2, e2 = m.clone(), psi.clone(), e.clone()
    inplace = ops.edm_update_bus_ef(x, g, m2, p2, e2, alpha=ALPHA,
                                    beta=BETA, fmt=fmt,
                                    block_rows=block_rows,
                                    out=(m2, p2, e2))
    assert inplace[0].data_ptr() == m2.data_ptr()
    assert inplace[3].data_ptr() == e2.data_ptr()
    for a, b in ((inplace[0], got[0]), (inplace[1], got[1]),
                 (inplace[3], got[3])):
        assert same_bits(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("block_rows", [8, 512])
def test_cuda_gossip_axpy_q8_bit_equal_to_plain(cuda, n, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(n)
    rows = 3 * block_rows
    qs = [torch.randint(-127, 128, (2, rows, 128), generator=gen,
                        device=cuda).to(torch.int8) for _ in range(n)]
    scales = [torch.rand(2, 3, generator=gen, device=cuda)
              for _ in range(n)]
    weights = [1.0 / (k + 3) for k in range(n)]
    before = ops.launch_counts()["gossip_axpy_q8"]
    got = ops.gossip_axpy_wire(list(zip(qs, scales)), weights, fmt="int8",
                               block_rows=block_rows)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gossip_axpy_q8"] == before + 1
    want = ref.gossip_axpy_q8_ref(qs, ref.wire_coefs(weights, scales),
                                  block_rows=block_rows)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_cuda_fused_ef_step_bit_equal_to_plain_ef_step(cuda, fmt):
    """One EF EDM + ring-gossip step on a small bus: the fused kernels
    against the plain EF chain (the codec) and the combine's plain
    version on the same rolled payloads."""
    from repro_torch.core import (build_mixer, make_codec, make_edm_bus_ef,
                                  ring, wire_terms)

    x, g, m, psi, e = _ef_inputs(4, 8, 8, cuda, seed=9)
    e = e.nan_to_num(0.0, 0.0, 0.0)          # finite: the codec's path
    codec = make_codec(fmt, 8)
    topo = ring(4)
    weights = [t.weight for t in topo.terms]

    def plain_mix(payload):
        pays = wire_terms(topo, payload, codec)
        if fmt == "bf16":
            return ref.gossip_axpy_ref(pays, weights,
                                       out_dtype=torch.float32)
        qs, scales = zip(*pays)
        return ref.gossip_axpy_q8_ref(qs, ref.wire_coefs(weights, scales),
                                      block_rows=8)

    fused_mix = build_mixer(topo, mode="static", engine="ppermute",
                            agents_per_device=4, use_fused_kernel=True,
                            wire=codec)
    outs = []
    for fused, mix in ((True, fused_mix), (False, plain_mix)):
        opt = make_edm_bus_ef(ALPHA, BETA, mix, codec,
                              use_fused_kernel=fused)
        x2, st = opt.step(x, g, {"m": m.clone(), "psi": psi.clone(),
                                 "e": e.clone()})
        outs.append((x2, st["m"], st["psi"], st["e"]))
    for a, b in zip(*outs):
        assert same_bits(a, b)
    assert bool(torch.isfinite(outs[0][0]).all())


# ---------------------------------------------------------------------------
# paged attention kernels (serving)
# ---------------------------------------------------------------------------

def _tol(dtype):
    """assert_close's (rtol, atol): |got − want| ≤ atol + rtol·|want|."""
    return dict(atol=2e-5, rtol=0.0 if dtype == torch.float32 else 2.0 ** -7)


def _decode_case(B, K, G, hd, page_size, kv_len, seed, dtype, device,
                 n_pages=0):
    """Ragged slot batch: slot b owns ceil(kv_len[b] / page_size) pages of a
    shuffled pool; every other page, the null page included, is NaN.  The
    page table has as many pages as the longest slot needs, or
    ``n_pages`` if more (the tail entries are the null page)."""
    rng = np.random.default_rng(seed)
    kv_len = np.asarray(kv_len, np.int32)
    used = [-(-int(n) // page_size) for n in kv_len]
    n_pages = max(max(used), n_pages)
    num_pages = 1 + sum(used) + 2
    phys = rng.permutation(np.arange(1, num_pages))
    pt = np.zeros((B, n_pages), np.int32)
    at = 0
    for b, n in enumerate(used):
        pt[b, :n] = phys[at:at + n]
        at += n
    q = rng.standard_normal((B, K, G, hd)).astype(np.float32)
    kp = rng.standard_normal((num_pages, page_size, K, hd)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page_size, K, hd)).astype(np.float32)
    dead = np.setdiff1d(np.arange(num_pages), phys[:at])
    kp[dead] = np.nan
    vp[dead] = np.nan

    def t(a):
        return torch.from_numpy(a).to(device)
    return (t(q).to(dtype), t(kp).to(dtype), t(vp).to(dtype), t(pt),
            t(kv_len))


DECODE_CASES = [
    # the ragged batch of tests/test_serve.py: idle slot 1, full slot 2
    dict(B=4, K=2, G=3, hd=16, page_size=8, kv_len=[5, 0, 24, 17]),
    # smollm_360m's heads at the serve CLI's shapes: 8 slots, 4 pages each
    dict(B=8, K=5, G=3, hd=64, page_size=16,
         kv_len=[64, 0, 17, 33, 1, 48, 16, 63]),
    # smollm_360m's heads, 16 slots, contexts up to 1024, one idle
    dict(B=16, K=5, G=3, hd=64, page_size=16,
         kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700, 129, 33, 1000,
                 64, 900, 15, 384]),
    # head dim 128 at the same 16 slots: deepseek_moe_16b's heads (MHA,
    # G 1), qwen3_moe_235b_a22b's (G 16: two blocks a KV head) and
    # pixtral_12b's (K 8, G 4)
    dict(B=16, K=16, G=1, hd=128, page_size=16,
         kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700, 129, 33, 1000,
                 64, 900, 15, 384]),
    dict(B=16, K=4, G=16, hd=128, page_size=16,
         kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700, 129, 33, 1000,
                 64, 900, 15, 384]),
    dict(B=16, K=8, G=4, hd=128, page_size=16,
         kv_len=[1024, 0, 1, 17, 255, 256, 511, 640, 700, 129, 33, 1000,
                 64, 900, 15, 384]),
    # a tensor-parallel rank of qwen3_14b over 4 ranks (K 2, G 5: f32 in
    # the 8-row register bucket, bf16 5 of an m16 tile's rows), 8 slots
    dict(B=8, K=2, G=5, hd=128, page_size=16,
         kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
    # tensor-parallel ranks over 4: deepseek_moe_16b's (K 4, G 1),
    # pixtral_12b's (K 2, G 4) and jamba_1_5_large_398b's (K 2, G 8)
    dict(B=8, K=4, G=1, hd=128, page_size=16,
         kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
    dict(B=8, K=2, G=4, hd=128, page_size=16,
         kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
    dict(B=8, K=2, G=8, hd=128, page_size=16,
         kv_len=[1024, 0, 256, 700, 1, 513, 129, 900]),
]


# the edges of the cluster-split kernel (splits of 128 or 256 keys with 8
# blocks a cluster, one block on short tables): one key, a slot exactly one
# split long (and one key either side), exactly a page, full tables, every
# slot idle, head dims 8 / 24 (lanes past hd/8) / 128 / 256, groups 1 / 4 /
# 8 / 9 (two blocks a head), pages of 8 and 32 rows
DECODE_EDGE_CASES = [
    dict(B=2, K=2, G=3, hd=64, page_size=16, kv_len=[1, 1024]),
    dict(B=4, K=2, G=3, hd=64, page_size=16, kv_len=[128, 129, 127, 1024]),
    dict(B=3, K=2, G=3, hd=64, page_size=16, kv_len=[16, 32, 1024]),
    dict(B=3, K=2, G=3, hd=64, page_size=16, kv_len=[1024, 1024, 1024]),
    dict(B=3, K=2, G=3, hd=64, page_size=16, kv_len=[0, 0, 0], n_pages=8),
    dict(B=3, K=2, G=3, hd=8, page_size=8, kv_len=[700, 5, 64]),
    dict(B=2, K=2, G=4, hd=128, page_size=16, kv_len=[513, 300]),
    dict(B=2, K=1, G=8, hd=256, page_size=32, kv_len=[1000, 31]),
    dict(B=4, K=3, G=1, hd=64, page_size=8, kv_len=[0, 9, 400, 64]),
    dict(B=2, K=2, G=9, hd=24, page_size=8, kv_len=[77, 300]),
    dict(B=1, K=1, G=2, hd=16, page_size=32, kv_len=[2048]),
]


def _check_decode(c, seed, dtype, device):
    q, kp, vp, pt, kv_len = _decode_case(c["B"], c["K"], c["G"], c["hd"],
                                         c["page_size"], c["kv_len"], seed,
                                         dtype, device, c.get("n_pages", 0))
    kc, vc = kp.nan_to_num(), vp.nan_to_num()     # dead rows zeroed
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention(q, kc, vc, pt, kv_len,
                              page_size=c["page_size"])
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == before + 1
    # the plain version gathers whole page-table rows (null tail entries
    # at weight 0), so both take the pools with the poison zeroed
    want = ref.paged_attention_ref(q, kc, vc, pt, kv_len,
                                   page_size=c["page_size"])
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    poisoned = ops.paged_attention(q, kp, vp, pt, kv_len,
                                   page_size=c["page_size"])
    assert bool(torch.isfinite(poisoned).all())
    assert bool((poisoned[kv_len == 0] == 0).all())
    assert torch.equal(poisoned, got), "the kernel read a poisoned row"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_cuda_paged_attention_matches_plain(cuda, case, dtype):
    _check_decode(DECODE_CASES[case], case, dtype, cuda)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(DECODE_EDGE_CASES)))
def test_cuda_paged_attention_edges_match_plain(cuda, case, dtype):
    _check_decode(DECODE_EDGE_CASES[case], 100 + case, dtype, cuda)


def _prefill_case(window, start, C, K, G, hd, page_size, n_pages, num_pages,
                  seed, dtype, device):
    """One slot's history written into NaN-poisoned pools (the null page is
    a zero write sink), as tests/test_chunked_prefill.py builds it."""
    rng = np.random.default_rng(seed)
    k_hist = rng.standard_normal((start, K, hd)).astype(np.float32)
    v_hist = rng.standard_normal((start, K, hd)).astype(np.float32)
    k_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    v_pool = np.full((num_pages, page_size, K, hd), np.nan, np.float32)
    n_slot = (window // page_size) if window else n_pages
    pt_row = np.zeros((n_pages,), np.int32)
    pt_row[:n_slot] = rng.choice(np.arange(1, num_pages), size=n_slot,
                                 replace=False)
    k_pool[0] = 0.0
    v_pool[0] = 0.0
    for p in range(start):
        row = p % window if window else p
        k_pool[pt_row[row // page_size], row % page_size] = k_hist[p]
        v_pool[pt_row[row // page_size], row % page_size] = v_hist[p]
    q = rng.standard_normal((1, C, K * G, hd)).astype(np.float32)
    k_c = rng.standard_normal((1, C, K, hd)).astype(np.float32)
    v_c = rng.standard_normal((1, C, K, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(device).to(dtype)
            for a in (q, k_c, v_c, k_pool, v_pool)] + [
        torch.from_numpy(pt_row).to(device)]


# (window, start, C, chunk_len, K, G, hd, page_size, n_pages, num_pages):
# the 11 KERNEL_CASES of tests/test_chunked_prefill.py; smollm_360m's heads
# at the serve CLI's shapes (16-token chunks, a partial query tile, 4 pages
# per slot), then with 128-token chunks, linear and a 256-row ring
PREFILL_CASES = [(w, s, C, n, 2, 2, 8, 4, 6, 16) for w, s, C, n in [
    (0, 0, 4, 4), (0, 4, 4, 4), (0, 9, 4, 3), (0, 20, 4, 1),
    (8, 0, 4, 4), (8, 4, 4, 4), (8, 7, 4, 4), (8, 8, 4, 4),
    (8, 13, 4, 3), (8, 37, 4, 2), (8, 37, 8, 8)]] + [
    (0, s, 16, n, 5, 3, 64, 16, 4, 40)
    for s, n in ((0, 16), (16, 16), (16, 7), (32, 1))] + [
    (w, s, 128, n, 5, 3, 64, 16, 64, 80)
    for w in (0, 256) for s, n in ((0, 128), (128, 128), (640, 77))] + [
    # head dim 128: deepseek_moe_16b's heads (K 16, G 1),
    # qwen3_moe_235b_a22b's (K 4, G 16) and pixtral_12b's (K 8, G 4),
    # 128-token chunks at context 1024 (77 rows: a partial query tile)
    (w, s, 128, n, K, G, 128, 16, 64, 80)
    for K, G in ((16, 1), (4, 16), (8, 4))
    for w, s, n in ((0, 0, 128), (0, 640, 128), (0, 640, 77),
                    (256, 640, 128))] + [
    # a tensor-parallel rank of qwen3_14b over 4 ranks: K 2, G 5 (640
    # query rows a KV head), few blocks at a short history
    (w, s, 128, n, 2, 5, 128, 16, 64, 80)
    for w, s, n in ((0, 0, 128), (0, 128, 128), (0, 640, 128),
                    (0, 640, 77), (0, 896, 128), (256, 640, 128))] + [
    # tensor-parallel ranks over 4: deepseek_moe_16b's (K 4, G 1),
    # pixtral_12b's (K 2, G 4) and jamba_1_5_large_398b's (K 2, G 8)
    (w, s, 128, n, K, G, 128, 16, 64, 80)
    for K, G in ((4, 1), (2, 4), (2, 8))
    for w, s, n in ((0, 0, 128), (0, 640, 128), (0, 640, 77),
                    (256, 640, 128))]
# the edges of the bf16 kernel's tiles and splits: 100 earlier rows (not
# a multiple of the 64-key tile or of a split), a 1-token chunk after 700
# rows, a 256-row ring with the chunk past the window, a 96-row ring at
# G 4 and hd 128, hd 256 at G 8 with 32-row pages, hd 16 at G 1
PREFILL_EDGE_CASES = [
    (0, 100, 128, 128, 5, 3, 64, 16, 64, 80),
    (0, 700, 128, 1, 5, 3, 64, 16, 64, 80),
    (256, 1000, 128, 128, 5, 3, 64, 16, 64, 80),
    (96, 77, 32, 20, 2, 4, 128, 16, 8, 12),
    (0, 300, 64, 64, 1, 8, 256, 32, 10, 12),
    (0, 45, 16, 9, 3, 1, 16, 8, 8, 10),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_CASES + PREFILL_EDGE_CASES)
def test_cuda_paged_prefill_matches_plain(cuda, case, dtype):
    window, start, C, clen, K, G, hd, page_size, n_pages, num_pages = case
    q, kc, vc, kp, vp, pt_row = _prefill_case(
        window, start, C, K, G, hd, page_size, n_pages, num_pages, 1, dtype,
        cuda)
    before = ops.launch_counts()["paged_prefill"]
    got = ops.paged_prefill_attention(q, kc, vc, kp, vp, pt_row, start,
                                      clen, page_size=page_size,
                                      window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_prefill"] == before + 1
    want = ref.paged_prefill_attention_ref(q, kc, vc, kp, vp, pt_row, start,
                                           clen, page_size=page_size,
                                           window=window)
    clean = ops.paged_prefill_attention(q, kc, vc, kp.nan_to_num(),
                                        vp.nan_to_num(), pt_row, start, clen,
                                        page_size=page_size, window=window)
    got, want, clean = got[:, :clen], want[:, :clen], clean[:, :clen]
    assert got.dtype == dtype
    assert bool(torch.isfinite(got).all()), "the kernel read a poisoned row"
    assert torch.equal(got, clean), "the kernel read a poisoned row"
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))



@pytest.mark.requires_cuda
def test_cuda_paged_prefill_on_two_streams_equals_in_sequence(cuda):
    """Two bf16 prefill launches with split keys, on two streams at once,
    give the bits of the same launches in sequence: each stream merges
    its splits through tickets of its own."""
    cases = [(0, 640, 128, 128, 5, 3, 64, 16, 64, 80),
             (256, 1000, 128, 128, 5, 3, 64, 16, 64, 80)]
    inputs = [_prefill_case(w, s, C, K, G, hd, ps, n, num, 7 + i,
                            torch.bfloat16, cuda)
              for i, (w, s, C, _, K, G, hd, ps, n, num) in enumerate(cases)]

    def run(i):
        window, start, _, clen, *_, ps, _, _ = cases[i]
        q, kc, vc, kp, vp, pt_row = inputs[i]
        return ops.paged_prefill_attention(q, kc, vc, kp, vp, pt_row, start,
                                           clen, page_size=ps,
                                           window=window)

    want = [run(0), run(1)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(20):
        outs = [None, None]
        for i, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs[i] = run(i)
        torch.cuda.synchronize()
        for i in range(2):
            assert torch.equal(outs[i], want[i]), f"stream {i} differs"


@pytest.mark.requires_cuda
def test_cuda_paged_wrappers_check_their_inputs(cuda):
    q, kp, vp, pt, kv_len = _decode_case(2, 1, 1, 16, 8, [3, 9], 0,
                                         torch.float32, cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.paged_attention(q, kp, vp, pt.long(), kv_len, page_size=8)
    with pytest.raises(ValueError, match="dtype"):
        ops.paged_attention(q, kp.bfloat16(), vp, pt, kv_len, page_size=8)
    with pytest.raises(ValueError, match="shape"):
        ops.paged_attention(q, kp, vp, pt, kv_len, page_size=16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(q, kp.cpu(), vp, pt, kv_len, page_size=8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", [0, 16])
def test_cuda_kernel_engine_equals_greedy_generate(cuda, window):
    """The chunked engine on the card, through both kernels, emits exactly
    the dense ``greedy_generate`` tokens (smoke config, f32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, greedy_generate,
                                   poisson_load)

    model = build_model(get_smoke_config("smollm_360m"),
                        decode_window=window)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    ctx = window or 64
    pcfg = PagedCacheConfig(page_size=8, num_pages=1 + 4 * (-(-ctx // 8)),
                            max_slots=4, max_context=ctx, window=window)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                   prefill_chunk=8, max_step_tokens=10,
                                   device=cuda)
    reqs = poisson_load(6, rate=500.0, vocab=model.cfg.vocab_size,
                        prompt_buckets=(12, 20), new_token_buckets=(4, 9),
                        prompt_dist="exact", seed=3)
    before = ops.launch_counts()
    eng.run(reqs)
    after = ops.launch_counts()
    assert after["paged_attention"] > before["paged_attention"]
    assert after["paged_prefill"] > before["paged_prefill"]
    for r in reqs:
        want = greedy_generate(
            model, params, {"tokens": torch.from_numpy(r.tokens)[None]
                            .to(cuda)}, n_steps=r.max_new)[0]
        assert eng.completed[r.rid].tolist() == want.cpu().tolist()


# ---------------------------------------------------------------------------
# flash GQA attention
# ---------------------------------------------------------------------------

# (B, H, K, Sq, Sk, hd, causal, window): the JAX package's ATTN_CASES, a
# window as long as the sequence, a case whose rows q >= 255 see no key,
# smollm_360m's heads, and odd head dims and groups
FLASH_CASES = [
    (1, 4, 4, 256, 256, 64, True, 0),
    (2, 8, 2, 256, 256, 64, True, 0),
    (1, 4, 1, 128, 384, 64, False, 0),
    (1, 2, 2, 512, 512, 128, True, 256),
    (1, 15, 5, 128, 128, 64, True, 0),
    (1, 2, 2, 256, 256, 64, True, 4096),
    (1, 15, 5, 512, 128, 64, True, 128),
    (2, 15, 5, 256, 256, 64, False, 100),
    (1, 6, 2, 128, 256, 8, True, 0),
    (1, 64, 1, 128, 128, 256, True, 0),
]


def _flash_inputs(B, H, K, Sq, Sk, hd, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for shape in ((B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd))]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, case, dtype):
    """Kernel against its plain version on the same inputs (f32 atol 2e-5;
    bf16 one bf16 ulp of the plain result on top); fully masked rows 0."""
    B, H, K, Sq, Sk, hd, causal, window = case
    q, k, v = _flash_inputs(B, H, K, Sq, Sk, hd, dtype, cuda, seed=Sq + hd)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              blk_q=128, blk_k=128)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    if causal and window and Sq > Sk:
        dead = torch.arange(Sq, device=cuda) >= Sk - 1 + window
        assert torch.count_nonzero(got[:, :, dead]) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_never_reads_dead_keys(cuda, dtype):
    """Causal with Sk > Sq: keys at positions >= Sq are visible to no
    query.  NaN there must leave the output bit-equal to the clean one."""
    q, k, v = _flash_inputs(2, 15, 5, 256, 512, 64, dtype, cuda, seed=7)
    clean = ops.flash_attention(q, k, v, causal=True)
    k[:, :, 256:] = float("nan")
    v[:, :, 256:] = float("nan")
    poisoned = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(clean, poisoned)
    assert bool(torch.isfinite(poisoned).all())


# (B, H, K, Sq, Sk, hd, causal, window) past the op's shape contract,
# through the kernel's own entry point: the bf16 kernel's tiles are 128
# query rows and 128 keys (64 for hd > 128), hd padded to a multiple of
# 64.  Head dims 8, 16, 128, 256 (and 72, 192); groups 1, 3, 4, 8; Sq != Sk
# both ways; windows that are not a multiple of the key tile; Sq not a
# multiple of 128.
FLASH_EDGE_CASES = [
    (1, 6, 2, 200, 200, 8, True, 0),
    (2, 3, 3, 130, 70, 16, True, 37),
    (1, 8, 2, 136, 300, 128, False, 0),
    (1, 8, 1, 250, 250, 256, True, 100),
    (1, 12, 3, 300, 200, 64, True, 50),
    (2, 15, 5, 333, 333, 64, False, 129),
    (1, 4, 1, 96, 500, 72, False, 65),
    (1, 8, 1, 190, 190, 192, True, 0),
    (1, 16, 2, 1, 257, 64, False, 0),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_cuda_flash_attention_edges_match_plain(cuda, case, dtype):
    """The kernel's tile edges against its plain version (same gates as
    above); rows with no live key are 0; one launch."""
    from repro_torch.kernels.flash_attention import flash_attention_flat

    B, H, K, Sq, Sk, hd, causal, window = case
    q, k, v = _flash_inputs(B, H, K, Sq, Sk, hd, dtype, cuda, seed=Sq + hd)
    before = ops.launch_counts()["flash_attention"]
    got = flash_attention_flat(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    qp = torch.arange(Sq, device=cuda)[:, None]
    kp = torch.arange(Sk, device=cuda)[None, :]
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=cuda)
    if causal:
        live &= kp <= qp
    if window:
        live &= kp > qp - window
    dead = ~live.any(dim=1)
    assert torch.count_nonzero(got[:, :, dead]) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,hd,G", [(200, 64, 3), (77, 128, 4),
                                     (130, 256, 1), (100, 16, 8)])
def test_cuda_flash_attention_partial_tile_never_reads_dead_keys(
        cuda, dtype, Sq, hd, G):
    """Causal with Sk > Sq, Sq not a multiple of the key tile: the block's
    last key tile ends inside real keys that no query sees.  NaN there
    must leave the output bit-equal to the clean one."""
    from repro_torch.kernels.flash_attention import flash_attention_flat

    K = 2
    q, k, v = _flash_inputs(1, G * K, K, Sq, 512, hd, dtype, cuda, seed=Sq)
    clean = flash_attention_flat(q, k, v, causal=True)
    k[:, :, Sq:] = float("nan")
    v[:, :, Sq:] = float("nan")
    poisoned = flash_attention_flat(q, k, v, causal=True)
    assert torch.equal(clean, poisoned)
    assert bool(torch.isfinite(poisoned).all())


@pytest.mark.requires_cuda
def test_cuda_flash_attention_checks_its_inputs(cuda):
    q, k, v = _flash_inputs(1, 4, 2, 128, 128, 64, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="multiples"):
        ops.flash_attention(q[:, :, :100], k, v)


# ---------------------------------------------------------------------------
# the EDM update and the combine on parameter leaves (the tree path)
# ---------------------------------------------------------------------------

LEAF_SHAPES = [(4, 960), (3, 7), (4, 32, 960), (3, 5, 3), (1, 1), (4, 3, 37)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_cuda_leaf_edm_update_bit_equal_to_plain(cuda, shape, dtype):
    """``ops.edm_update`` packs a leaf of any shape, launches once and
    unpacks to the leaf's dtype: bit-equal to the plain chain through the
    same pack and unpack."""
    x, g, m, psi = (t.to(dtype) for t in _edm_inputs(shape, cuda, seed=11))
    before = ops.launch_counts()["edm_update"]
    got = ops.edm_update(x, g, m, psi, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    assert ops.launch_counts()["edm_update"] == before + 1
    packed = [ops.pack_leaf(t) for t in (x, g, m, psi)]
    want = ref.edm_update_ref(*packed, alpha=ALPHA, beta=BETA)
    for o, w, like in zip(got, want, (m, psi, x)):
        assert o.dtype == dtype and o.shape == like.shape
        assert torch.equal(o, ops.unpack_leaf(w, like.shape, dtype))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LEAF_SHAPES)
def test_cuda_leaf_gossip_axpy_bit_equal_to_plain(cuda, shape, dtype, n):
    """The combine takes a leaf as it is, any element count (a ragged
    tail of up to 3 elements): bit-equal to its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(len(shape) * 10 + n)
    operands = [torch.randn(shape, generator=gen, device=cuda).to(dtype)
                for _ in range(n)]
    weights = [1.0 / (k + 3) for k in range(n)]
    got = ops.gossip_axpy(operands, weights)
    want = ref.gossip_axpy_ref(operands, weights)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.requires_cuda
def test_cuda_fused_tree_step_bit_equal_to_plain(cuda):
    """One tree EDM + ring-gossip step with the kernels (one EDM and one
    combine launch per leaf) against the plain versions through the same
    per-leaf pack, unpack and rolls."""
    from repro_torch.core import make_mixer, make_optimizer, ring, wire_terms

    gen = torch.Generator(device=cuda).manual_seed(13)
    tree = lambda: {f"l{i}": torch.randn(s, generator=gen, device=cuda)  # noqa: E731
                    .bfloat16() for i, s in enumerate(LEAF_SHAPES)
                    if s[0] == 4}
    x, g, m = tree(), tree(), tree()
    topo = ring(4)
    mix = make_mixer(topo, "ppermute", agents_per_device=4,
                     use_fused_kernel=True)
    opt = make_optimizer("edm", alpha=ALPHA, beta=BETA, mix=mix,
                         use_fused_kernel=True)
    state = {"m": m, "psi": {p: v.clone() for p, v in x.items()}}
    before = ops.launch_counts()
    x2, st = opt.step(x, g, state)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["edm_update"] - before["edm_update"] == len(x)
    assert after["gossip_axpy"] - before["gossip_axpy"] == len(x)
    weights = [t.weight for t in topo.terms]
    for p in x:
        packed = [ops.pack_leaf(t) for t in (x[p], g[p], m[p], x[p])]
        m_p, psi_p, phi_p = ref.edm_update_ref(*packed, alpha=ALPHA,
                                               beta=BETA)
        phi = ops.unpack_leaf(phi_p, x[p].shape, x[p].dtype)
        assert torch.equal(st["m"][p], ops.unpack_leaf(m_p, x[p].shape,
                                                       torch.bfloat16))
        assert torch.equal(st["psi"][p], ops.unpack_leaf(
            psi_p, x[p].shape, torch.bfloat16))
        assert torch.equal(x2[p], ref.gossip_axpy_ref(
            wire_terms(topo, phi), weights))


# ---------------------------------------------------------------------------
# the ring combine (the rolls fused in) and the graphed bus step
# ---------------------------------------------------------------------------

def _ring_bus(A, rows, device, seed, edges):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((A, rows, 128), generator=gen, device=device)
    if edges:   # NaN and ±Inf in every agent's block, at different places
        for a in range(A):
            x[a, a % rows, 3] = float("nan")
            x[a, (a + 5) % rows, 7] = float("inf")
            x[a, (a + 9) % rows, 11] = -float("inf")
    return x


def _same_bits(a, b):
    """Equal shape and bits, a NaN matching any NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype
    ints = torch.int32 if a.element_size() == 4 else torch.int16
    ia, ib = a.view(ints), b.view(ints)
    return bool(((ia == ib) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("A,rows", [(1, 8), (2, 9), (3, 24), (4, 1024),
                                    (8, 17), (32, 3)])
def test_cuda_ring_combine_bit_equal_to_plain(cuda, A, rows, edges):
    """The ring kernel against the rolls plus the plain combine, every A
    (ring(2)'s two terms name the same neighbour, ring(1) has one), odd
    row counts, NaN and ±Inf; out of place and into ``out=``."""
    from repro_torch.core import ring
    x = _ring_bus(A, rows, cuda, seed=A * 100 + rows, edges=edges)
    terms = [(t.shift, float(t.weight)) for t in ring(A).terms]
    want = ref.ring_combine_ref(x, terms)
    before = ops.launch_counts()["ring_combine"]
    got = ops.ring_combine(x, terms)
    out = torch.full_like(x, 7.0)
    into = ops.ring_combine(x, terms, out=out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ring_combine"] == before + 2
    assert into is out
    assert _same_bits(got, want) and _same_bits(out, want)


@pytest.mark.requires_cuda
def test_cuda_ring_combine_checks_its_inputs(cuda):
    from repro_torch.kernels.ring_dma import ring_combine_flat
    x = torch.zeros(4, 8, 128, device=cuda)
    terms = [(0, 0.5), (1, 0.25), (-1, 0.25)]
    with pytest.raises(ValueError, match="overlaps"):
        ring_combine_flat(x, terms, out=x)
    with pytest.raises(ValueError, match="f32"):
        ring_combine_flat(x.bfloat16(), terms)
    with pytest.raises(ValueError, match="shift 2"):
        ring_combine_flat(x, [(0, 0.5), (2, 0.5)])
    with pytest.raises(ValueError, match="CUDA"):
        ring_combine_flat(x.cpu(), terms)


# (A, per-agent shape): one agent; the register path (A ≤ 8) and the
# memory path (A > 8); element counts that are and are not multiples of 4
TABLE_SHAPES = [(1, (8, 128)), (3, (24, 128)), (4, (1024, 128)),
                (4, (5, 3)), (8, (7,)), (12, (9, 128)), (12, (33,))]


def _table(K, A, gen):
    src = torch.randint(0, A, (K, A), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(K, A, generator=gen, device="cuda")
    w[K // 2] = 0.0                               # a weight-0 (pad) slot
    return src, w


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [1, 3, 16])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("A,shape", TABLE_SHAPES)
def test_cuda_table_combine_bit_equal_to_plain(cuda, A, shape, dtype,
                                               out_dtype, K):
    """The source-table combine against its plain version, NaN and ±Inf
    in the payload (read through weight-0 slots too), out of place and
    into ``out=``."""
    gen = torch.Generator(device=cuda).manual_seed(A * 100 + K)
    x = torch.randn((A,) + shape, generator=gen, device=cuda)
    flat = x.view(A, -1)
    flat[0, 0], flat[-1, -1] = float("nan"), float("inf")
    flat[A // 2, flat.shape[1] // 2] = -float("inf")
    x = x.to(dtype)
    src, w = _table(K, A, gen)
    want = ref.table_combine_ref(x, src, w, out_dtype=out_dtype)
    before = ops.launch_counts()["table_combine"]
    got = ops.table_combine(x, src, w, out_dtype=out_dtype)
    out = torch.full_like(want, 7.0)
    into = ops.table_combine(x, src, w, out_dtype=out_dtype, out=out)
    torch.cuda.synchronize()
    assert ops.launch_counts()["table_combine"] == before + 2
    assert into is out and got.dtype == want.dtype == (out_dtype or dtype)
    assert _same_bits(got, want) and _same_bits(out, want)


@pytest.mark.requires_cuda
def test_cuda_table_combine_checks_its_inputs(cuda):
    from repro_torch.kernels.table_combine import table_combine_flat
    x = torch.zeros(4, 8, 128, device=cuda)
    src = torch.zeros(3, 4, dtype=torch.int32, device=cuda)
    w = torch.zeros(3, 4, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        table_combine_flat(x, src, w, out=x)
    with pytest.raises(ValueError, match="src"):
        table_combine_flat(x, src[:, :3], w[:, :3])
    with pytest.raises(ValueError, match="src"):
        table_combine_flat(x, torch.zeros(17, 4, dtype=torch.int32,
                                          device=cuda), torch.zeros(17, 4,
                                                                    device=cuda))
    with pytest.raises(ValueError, match="w must be f32"):
        table_combine_flat(x, src, w.double())
    with pytest.raises(ValueError, match="on cpu"):
        table_combine_flat(x, src.cpu(), w)


# the port's bus kernels as a device trace names them
TRACE_NAMES = {"edm_update": "edm_update_kernel",
               "gossip_axpy": "gossip_axpy_kernel",
               "gossip_axpy_q8": "gossip_axpy_q8_kernel",
               "ring_combine": "ring_combine_kernel",
               "table_combine": "table_combine_kernel"}
GRAPH_CASES = {"ring": {},
               "round_robin": dict(topology="exp",
                                   gossip_schedule="round_robin"),
               "warmup_cosine": dict(warmup_steps=2, total_steps=6)}


def _traced_launches(fn):
    """Run ``fn`` under torch.profiler: launches of each TRACE_NAMES
    kernel on the device.  The profiler's window is held open 0.2 s past
    the device's drain (``chip_smoke.PROFILE_SETTLE_S``): a region closed
    at the drain can lose the records of its last kernels, the EDM update
    and the combine among them."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    counts = dict.fromkeys(TRACE_NAMES, 0)
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for name, kernel in TRACE_NAMES.items():
                if kernel in ev.key:
                    counts[name] += ev.count
    return counts


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_cuda_graphed_bus_step_bit_equal_to_eager(cuda, case, monkeypatch):
    """4 smoke steps replayed from CUDA graphs against 4 eager steps from
    one state and one token stream, deterministic algorithms on: metrics
    and the state buses bit-equal.  The wrappers count the eager steps
    only (one a graph key, then replays); the last step runs under the
    profiler, and the replay's device trace holds the eager step's
    kernels.  The ring (the ring kernel), round_robin on the exp graph
    (a ring round and a rolled round: two graphs) and warmup_cosine (the
    LR scale a device scalar written before each replay)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("smollm_360m"))
    run = RunConfig(global_batch=4, seq_len=16, algorithm="edm", alpha=0.2,
                    beta=0.9, gossip_engine="ppermute", agents_per_device=4,
                    remat=False, **GRAPH_CASES[case])
    gen = torch.Generator(device=cuda).manual_seed(4)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(4)]

    def trajectory(graphed):
        step = build_train_step(model, run, make_gossip_schedule(run, 4),
                                use_fused_kernel=True, device=cuda)
        state = init_state(model, run, 4, seed=0, device=cuda)
        if graphed:
            step = graph_train_step(step, state, batches[0])
        ops.reset_launch_counts()
        history = []
        for b in batches[:-1]:
            state, metrics = step(state, b)
            history.append({k: v.clone() for k, v in metrics.items()})

        def last():
            nonlocal state
            state, metrics = step(state, batches[-1])
            history.append({k: v.clone() for k, v in metrics.items()})

        traced = _traced_launches(last)
        return state, history, ops.launch_counts(), traced, step

    torch.use_deterministic_algorithms(True)
    try:
        eager, h_eager, c_eager, t_eager, _ = trajectory(False)
        graph, h_graph, c_graph, t_graph, g_step = trajectory(True)
    finally:
        torch.use_deterministic_algorithms(False)
    n_keys = 2 if case == "round_robin" else 1
    assert g_step.replays == 4 - n_keys
    assert c_eager["edm_update"] == 4 and c_graph["edm_update"] == n_keys
    combines = ("ring_combine", "gossip_axpy")
    assert sum(c_eager[k] for k in combines) == 4
    assert sum(c_graph[k] for k in combines) == n_keys
    assert c_eager["ring_combine"] == (2 if case == "round_robin" else 4)
    # the replayed step ran the eager step's kernels, one of each
    assert t_graph == t_eager and t_eager["edm_update"] == 1
    assert sum(t_eager[k] for k in combines) == 1
    for a, b in zip(h_graph, h_eager):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(graph["params"], eager["params"])
    for k in ("m", "psi"):
        assert torch.equal(graph["opt"][k], eager["opt"][k])


# (RunConfig fields, straggler late slots, churn events): the delayed
# pipeline on the ring (the ring kernel), with the int8 wire (the q8
# combine), with a straggler (the table kernel on late steps), and churn
# (the table kernel in the degraded epoch, the ring kernel outside it)
PIPE_CASES = {
    "overlap": (dict(overlap="delayed"), None, None),
    "overlap_int8": (dict(overlap="delayed", wire="int8"), None, None),
    "straggler": (dict(overlap="delayed"), ((1, (1,)), (3, (2,))), None),
    "churn": ({}, None, [(0, []), (1, [3]), (3, [])]),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_cuda_graphed_overlap_and_churn_steps_bit_equal_to_eager(
        cuda, case, monkeypatch):
    """5 smoke steps replayed from CUDA graphs against 5 eager steps, from
    one state and one token stream, deterministic algorithms on: metrics,
    the buses and the pipeline bit-equal; the replays' device trace holds
    the eager steps' kernels."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.elastic import DropPlan, StragglerPlan
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step

    fields, late, churn = PIPE_CASES[case]
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("smollm_360m"))
    run = RunConfig(global_batch=4, seq_len=16, algorithm="edm", alpha=0.2,
                    beta=0.9, gossip_engine="ppermute", agents_per_device=4,
                    remat=False, **fields)
    sched = make_gossip_schedule(
        run, 4, churn=None if churn is None else DropPlan.from_events(
            4, churn))
    plan = None if late is None else StragglerPlan(3, late)
    gen = torch.Generator(device=cuda).manual_seed(5)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(5)]

    def trajectory(graphed):
        step = build_train_step(model, run, sched, use_fused_kernel=True,
                                straggler_plan=plan, device=cuda)
        state = init_state(model, run, 4, seed=0, device=cuda)
        if graphed:
            step = graph_train_step(step, state, batches[0])
        history, traced = [], dict.fromkeys(TRACE_NAMES, 0)
        for b in batches:
            def one():
                nonlocal state
                state, metrics = step(state, b)
                history.append({k: v.clone() for k, v in metrics.items()})
            for k, v in _traced_launches(one).items():
                traced[k] += v
        return state, history, traced

    torch.use_deterministic_algorithms(True)
    try:
        eager, h_eager, t_eager = trajectory(False)
        graph, h_graph, t_graph = trajectory(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert t_graph == t_eager and t_eager["edm_update"] == 5
    if case in ("straggler", "churn"):
        assert t_eager["table_combine"] == 2 and t_eager["ring_combine"] == 3
    for a, b in zip(h_graph, h_eager):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(graph["params"], eager["params"])
    for k in eager["opt"]:
        assert torch.equal(graph["opt"][k], eager["opt"][k]), k
    if "pipeline" in eager:
        assert graph["pipeline"]["parity"] == eager["pipeline"]["parity"]
        assert torch.equal(graph["pipeline"]["slot"],
                           eager["pipeline"]["slot"])


# ---------------------------------------------------------------------------
# policy groups: the combines on a group's rows in place, the grouped step
# ---------------------------------------------------------------------------

# a bus of 4 agents and 96 rows, the group its rows [32, 72): a nonzero
# offset, rows a multiple of the q8 tile (8 rows here)
GROUP_BUS, GROUP_ROWS, GROUP_BR = (4, 96, 128), (32, 72), 8


def _group_bus(cuda, seed, dtype=torch.float32):
    """A bus whose group rows hold values with NaN / ±Inf, every other row
    (the neighbouring groups) NaN: a kernel that reads outside the group
    turns its output NaN where the plain version's is not."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    bus = torch.full(GROUP_BUS, float("nan"), device=cuda)
    r0, r1 = GROUP_ROWS
    bus[:, r0:r1] = torch.randn((4, r1 - r0, 128), generator=gen,
                                device=cuda)
    bus[0, r0, 5], bus[1, r0 + 3, 9] = float("inf"), -float("inf")
    bus[2, r1 - 1, 100] = float("nan")
    return bus.to(dtype)


def _strided_call(kind, x, out, dtype):
    """One combine on a group slice ``x`` (of a bus), into ``out``: the
    kernel op and its plain version's value."""
    from repro_torch.core import ring
    terms = [(t.shift, float(t.weight)) for t in ring(4).terms]
    if kind == "ring":
        return ops.ring_combine(x, terms, out=out), \
            ref.ring_combine_ref(x, terms)
    if kind == "table":
        src = torch.tensor([[0, 1, 2, 3], [3, 0, 1, 2], [0, 1, 2, 3]],
                           dtype=torch.int32, device=x.device)
        w = torch.tensor([[0.5] * 4, [0.25] * 4, [0.0, 0.25, 0.25, 0.25]],
                         device=x.device)
        return ops.table_combine(x, src, w, out_dtype=out.dtype, out=out), \
            ref.table_combine_ref(x, src, w, out_dtype=out.dtype)
    if kind == "axpy":
        # the self term read in place, the rolled neighbours fresh
        ops_ = [x, torch.roll(x, 1, 0), torch.roll(x, -1, 0)]
        ws = [0.5, 0.25, 0.25]
        return ops.gossip_axpy(ops_, ws, out_dtype=out.dtype, out=out), \
            ref.gossip_axpy_ref(ops_, ws, out_dtype=out.dtype)
    gen = torch.Generator(device=x.device).manual_seed(9)
    q = torch.randint(-127, 128, x.shape, generator=gen, device=x.device,
                      dtype=torch.int8)
    s = torch.rand((4, x.shape[1] // GROUP_BR), generator=gen,
                   device=x.device)
    pays = [(q, s), (torch.roll(q, 1, 0), torch.roll(s, 1, 0))]
    coefs = ref.wire_coefs([0.75, 0.25], [s, pays[1][1]])
    return (ops.gossip_axpy_wire(pays, [0.75, 0.25], fmt="int8",
                                 block_rows=GROUP_BR, out=out),
            ref.gossip_axpy_q8_ref([q, pays[1][0]], coefs,
                                   block_rows=GROUP_BR))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind,dtype", [
    ("ring", torch.float32), ("table", torch.float32),
    ("table", torch.bfloat16), ("axpy", torch.float32),
    ("axpy", torch.bfloat16), ("q8", torch.float32)])
def test_cuda_combines_on_a_group_slice_bit_equal_to_plain(cuda, kind,
                                                           dtype):
    """Each combine reads a group's rows ``bus[:, 32:72]`` in place (the
    rest of the bus NaN) and writes ``out[:, 32:72]`` of another bus in
    place: bit-equal to its plain version, and no other row of ``out``
    written.  The same values in a dense bus give the same bits."""
    r0, r1 = GROUP_ROWS
    bus = _group_bus(cuda, seed=11, dtype=dtype)
    x = bus[:, r0:r1]
    assert not x.is_contiguous()
    out_dtype = torch.float32 if kind in ("table", "axpy", "q8") \
        and dtype == torch.bfloat16 else dtype
    if kind == "q8":
        out_dtype = torch.float32
    dst = torch.full(GROUP_BUS, 7.0, device=cuda, dtype=out_dtype)
    name = {"ring": "ring_combine", "table": "table_combine",
            "axpy": "gossip_axpy", "q8": "gossip_axpy_q8"}[kind]
    before = ops.launch_counts()[name]
    got, want = _strided_call(kind, x, dst[:, r0:r1], dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == before + 1
    assert got.data_ptr() == dst[:, r0:r1].data_ptr()
    assert _same_bits(dst[:, r0:r1], want)
    assert bool((dst[:, :r0] == 7.0).all() and (dst[:, r1:] == 7.0).all())
    # the unstrided call on the same values: the same bits
    dense, want2 = _strided_call(kind, x.contiguous(), torch.empty_like(
        dst[:, r0:r1]), dtype)
    torch.cuda.synchronize()
    assert _same_bits(dense, want2) and _same_bits(dense, dst[:, r0:r1])


@pytest.mark.requires_cuda
def test_cuda_strided_combines_check_their_inputs(cuda):
    from repro_torch.kernels.ring_dma import ring_combine_flat
    from repro_torch.kernels.table_combine import table_combine_flat
    bus = torch.zeros(GROUP_BUS, device=cuda)
    terms = [(0, 0.5), (1, 0.25), (-1, 0.25)]
    # two groups of one bus interleave: their spans meet
    with pytest.raises(ValueError, match="overlaps"):
        ring_combine_flat(bus[:, :32], terms, out=bus[:, 32:64])
    src = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    w = torch.ones(1, 4, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        table_combine_flat(bus[:, :32], src, w, out=bus[:, 32:64])
    # an agent block that is not dense, and a stride off 16 bytes
    with pytest.raises(ValueError, match="dense"):
        table_combine_flat(bus[:, :, :64], src, w)
    odd = torch.zeros(4, 8 * 128 + 1, device=cuda)[:, :8 * 128]
    with pytest.raises(ValueError, match="16 bytes"):
        ring_combine_flat(odd.view(4, 8, 128), terms)


def _grouped_run(groups, **kw):
    from repro_torch.configs.base import RunConfig
    return RunConfig(global_batch=4, seq_len=16, algorithm="edm", alpha=0.2,
                     beta=0.9, gossip_engine="ppermute", agents_per_device=4,
                     topology="ring", gossip_groups=groups, remat=False, **kw)


GROUP_POLICY = (
    '[{"name": "embed", "match": ["embed", "lm_head"], "gossip_every": 0},'
    ' {"name": "attn", "match": ["|attn|"]},'
    ' {"name": "ffn", "match": ["|ffn|"], "gossip_every": 2, "wire": "int8"},'
    ' {"name": "norm", "match": ["final_ln"], "wire": "bf16",'
    ' "schedule": "round_robin"}]')


@pytest.mark.requires_cuda
def test_cuda_graphed_grouped_step_bit_equal_to_eager(cuda, monkeypatch):
    """The 4-group policy (opt-out, f32 ring, int8 every other step, bf16
    on round_robin) at the smoke config: 4 steps replayed from CUDA graphs
    (2 graph keys) against 4 eager steps, deterministic: metrics and buses
    bit-equal; the opt-out rows of x equal the EDM kernel's φ rows; the
    replays' device traces hold the eager steps' kernels (EDM and ring
    every step, the bf16 combine every step, q8 on odd steps)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, bus_layout_for,
                                   init_state, make_gossip_schedule,
                                   resolve_features)
    from repro_torch.train.graphs import graph_train_step

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("smollm_360m"))
    run = _grouped_run(GROUP_POLICY)
    layout = bus_layout_for(model, 4, resolve_features(run).groups)
    embed = next(g for g in layout.groups if g.name == "embed")
    gen = torch.Generator(device=cuda).manual_seed(6)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(4)]

    def trajectory(graphed):
        step = build_train_step(model, run, make_gossip_schedule(run, 4),
                                use_fused_kernel=True, device=cuda)
        state = init_state(model, run, 4, seed=0, device=cuda)
        if graphed:
            step = graph_train_step(step, state, batches[0])
        history, traced = [], []
        rows = slice(embed.row, embed.row + embed.rows)
        for b in batches:
            x0 = state["params"][:, rows].clone()
            psi0 = state["opt"]["psi"][:, rows].clone()

            def one():
                nonlocal state
                state, metrics = step(state, b)
                history.append({k: v.clone() for k, v in metrics.items()})
            traced.append(_traced_launches(one))
            # the opt-out rows of x' are φ's: (ψ' + x) − ψ, as the kernel
            # rounds it
            phi = (state["opt"]["psi"][:, rows] + x0) - psi0
            history[-1]["x_rows"] = state["params"][:, rows].clone()
            assert torch.equal(history[-1]["x_rows"], phi)
            assert not torch.equal(phi, x0)
        return state, history, traced, step

    torch.use_deterministic_algorithms(True)
    try:
        eager, h_eager, t_eager, _ = trajectory(False)
        graph, h_graph, t_graph, g_step = trajectory(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(g_step.graphs) == 2 and g_step.replays == 2
    assert t_graph == t_eager
    for t, tr in enumerate(t_eager):
        assert tr["edm_update"] == 1 and tr["ring_combine"] == 1, (t, tr)
        assert tr["gossip_axpy"] == 1, (t, tr)            # bf16 → f32
        assert tr["gossip_axpy_q8"] == t % 2, (t, tr)
    for a, b in zip(h_graph, h_eager):
        for k in ("loss", "consensus", "grad_norm"):
            assert torch.equal(a[k], b[k]), k
        assert torch.equal(a["x_rows"], b["x_rows"])
    assert torch.equal(graph["params"], eager["params"])
    for k in ("m", "psi"):
        assert torch.equal(graph["opt"][k], eager["opt"][k]), k
    assert bool(torch.isfinite(eager["params"]).all())


@pytest.mark.requires_cuda
def test_cuda_two_group_f32_ring_equals_ungrouped(cuda):
    """The 2-group all-gossip f32 layout on the ring (two ring launches a
    step, each on its group's rows in place) against the ungrouped ring
    step: 3 steps, every unpacked leaf bit-equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import bus as tbus
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, bus_layout_for,
                                   init_state, make_gossip_schedule,
                                   resolve_features)
    model = build_model(get_smoke_config("smollm_360m"))
    gen = torch.Generator(device=cuda).manual_seed(8)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(3)]
    leaves = []
    for groups in ("", '[{"name": "attn", "match": ["|attn|"]}]'):
        run = _grouped_run(groups)
        layout = bus_layout_for(model, 4, resolve_features(run).groups)
        step = build_train_step(model, run, make_gossip_schedule(run, 4),
                                use_fused_kernel=True, device=cuda)
        state = init_state(model, run, 4, seed=0, device=cuda)
        before = ops.launch_counts()["ring_combine"]
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        assert ops.launch_counts()["ring_combine"] - before == \
            3 * (2 if groups else 1)
        leaves.append([tbus.unpack_tree(layout, t) for t in (
            state["params"], state["opt"]["m"], state["opt"]["psi"])])
    for a, b in zip(*leaves):
        for p in a:
            assert torch.equal(a[p], b[p]), p


def _mamba_inputs(cfg, seed):
    from repro_torch.models import mamba
    gen = torch.Generator().manual_seed(seed)
    p = mamba.init_mamba(cfg, gen)
    for name in ("ln", "conv_b"):
        p[name] = 0.1 * torch.randn(p[name].shape, generator=gen)
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    cache = {"h": torch.randn((2, cfg.d_inner, cfg.ssm_state),
                              generator=gen),
             "conv": torch.randn((2, cfg.ssm_conv - 1, cfg.d_inner),
                                 generator=gen)}
    return p, x, cache


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_cuda_mamba_block_matches_cpu(cuda, mode):
    """The Mamba block (the chunked scan in two chunks, or one decode
    step) and its gradients on the card against the same f32 inputs on
    the CPU: the same ops, reduction order and ``exp`` aside, so each
    output within a normwise relative error of 1e-5 (f32 against an f64
    run of the block is 0.4–1e-6; elementwise bounds trip on the
    gradients' cancelling sums)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import mamba
    cfg = get_smoke_config("falcon_mamba_7b")
    p, x, cache = _mamba_inputs(cfg, seed=11)
    if mode == "decode":
        x = x[:, :1]

    def run(device):
        leaves = {k: v.to(device).requires_grad_() for k, v in p.items()}
        c = ({k: v.to(device) for k, v in cache.items()}
             if mode == "decode" else None)
        y, new = mamba.apply_mamba(leaves, cfg, x.to(device), mode=mode,
                                   cache=c, chunk=12)
        grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
        outs = [y] + ([new["h"], new["conv"]] if new else []) + list(grads)
        return [t.detach().cpu() for t in outs]

    for i, (got, want) in enumerate(zip(run(cuda), run("cpu"))):
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, (i, rel)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["smollm_360m", "falcon_mamba_7b"])
def test_cuda_remat_gradients_bit_equal(cuda, arch, monkeypatch):
    """``remat`` "full" and "dots" against ``remat=False`` on the card,
    deterministic algorithms on: loss and every gradient bit-equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config(arch))
    params = model.init(torch.Generator(device=cuda).manual_seed(1))
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 24), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))

    def grads(**kw):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        loss = model.loss(leaves, {"tokens": tokens}, **kw)
        return [loss.detach()] + list(torch.autograd.grad(
            loss, list(leaves.values())))

    torch.use_deterministic_algorithms(True)
    try:
        want = grads(remat=False)
        for policy in ("full", "dots"):
            for g, w in zip(grads(remat=True, remat_policy=policy), want):
                assert torch.equal(g, w), policy
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("groups,remat", [("", False), ("ssm", True)])
def test_cuda_graphed_ssm_step_bit_equal_to_eager(cuda, groups, remat,
                                                  monkeypatch):
    """The SSM smoke model on the ring bus, ungrouped and under ``ssm``
    (the state rows opt out) with ``remat`` on: 3 steps replayed from a
    CUDA graph against 3 eager steps, deterministic: metrics and buses
    bit-equal; the replays' traces hold one EDM and one ring kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("falcon_mamba_7b"))
    run = RunConfig(global_batch=4, seq_len=16, algorithm="edm", alpha=0.2,
                    beta=0.9, gossip_engine="ppermute", agents_per_device=4,
                    gossip_groups=groups, remat=remat)
    gen = torch.Generator(device=cuda).manual_seed(9)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(3)]

    def trajectory(graphed):
        step = build_train_step(model, run, make_gossip_schedule(run, 4),
                                use_fused_kernel=True, device=cuda)
        state = init_state(model, run, 4, seed=0, device=cuda)
        if graphed:
            step = graph_train_step(step, state, batches[0])
        history, traced = [], []
        for b in batches:
            def one(b=b):
                nonlocal state
                state, metrics = step(state, b)
                history.append({k: v.clone() for k, v in metrics.items()})
            traced.append(_traced_launches(one))
        return state, history, traced

    torch.use_deterministic_algorithms(True)
    try:
        eager, h_eager, t_eager = trajectory(False)
        graph, h_graph, t_graph = trajectory(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert t_graph == t_eager
    for tr in t_eager:
        assert tr["edm_update"] == 1 and tr["ring_combine"] == 1, tr
    for a, b in zip(h_graph, h_eager):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(graph["params"], eager["params"])
    for k in ("m", "psi"):
        assert torch.equal(graph["opt"][k], eager["opt"][k]), k


def _graphed_against_eager(cuda, model, run, batches):
    """3 bus steps replayed from a CUDA graph against 3 eager steps from
    one state, deterministic algorithms on: (graphed state, eager state,
    graphed metrics, eager metrics, graphed traces, eager traces)."""
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    from repro_torch.train.graphs import graph_train_step
    A = run.global_batch

    def trajectory(graphed):
        step = build_train_step(model, run, make_gossip_schedule(run, A),
                                use_fused_kernel=True, device=cuda)
        state = init_state(model, run, A, seed=0, device=cuda)
        if graphed:
            step = graph_train_step(step, state, batches[0])
        history, traced = [], []
        for b in batches:
            def one(b=b):
                nonlocal state
                state, metrics = step(state, b)
                history.append({k: v.clone() for k, v in metrics.items()})
            traced.append(_traced_launches(one))
        return state, history, traced

    torch.use_deterministic_algorithms(True)
    try:
        eager, h_eager, t_eager = trajectory(False)
        graph, h_graph, t_graph = trajectory(True)
    finally:
        torch.use_deterministic_algorithms(False)
    return graph, eager, h_graph, h_eager, t_graph, t_eager


def _assert_same_run(graph, eager, h_graph, h_eager, t_graph, t_eager):
    assert t_graph == t_eager
    for tr in t_eager:
        assert tr["edm_update"] == 1 and tr["ring_combine"] == 1, tr
    for a, b in zip(h_graph, h_eager):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(graph["params"], eager["params"])
    for k in ("m", "psi"):
        assert torch.equal(graph["opt"][k], eager["opt"][k]), k


def _bus_run(**kw):
    from repro_torch.configs.base import RunConfig
    return RunConfig(**dict(dict(
        global_batch=4, seq_len=16, algorithm="edm", alpha=0.2, beta=0.9,
        gossip_engine="ppermute", agents_per_device=4, remat=False), **kw))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "pixtral_12b",
                                  "whisper_small"])
def test_cuda_hybrid_and_vlm_loss_match_cpu(cuda, arch):
    """The hybrid smoke model's layer stack (Mamba, attention and MoE
    layers, the aux loss), the VLM smoke model's loss with a frontend and
    the encoder-decoder's with its frames, with their gradients, on the
    card against the same f32 weights and inputs on the CPU: normwise
    relative error within 1e-5 (the Mamba block's card bound)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    model = build_model(get_smoke_config(arch))
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=gen)}
    if cfg.family in ("vlm", "encdec"):
        batch["frontend"] = torch.randn((2, cfg.n_frontend_tokens,
                                         cfg.d_model), generator=gen)

    def run(device):
        leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
        loss = model.loss(leaves, {k: v.to(device) for k, v in batch.items()},
                          remat=False)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return [t.detach().cpu() for t in [loss, *grads]]

    for i, (got, want) in enumerate(zip(run(cuda), run("cpu"))):
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-5, (i, rel)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("groups", ["", "ssm:0,moe"])
def test_cuda_graphed_hybrid_step_bit_equal_to_eager(cuda, groups,
                                                     monkeypatch):
    """The hybrid smoke model on the ring bus (the MoE's gather dispatch
    and the Mamba scan in one graph), ungrouped and under ``ssm:0,moe``
    (state and expert rows opt out): 3 replayed steps against 3 eager
    steps, metrics and buses bit-equal, one EDM and one ring kernel in
    each step's trace."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("jamba_1_5_large_398b"))
    gen = torch.Generator(device=cuda).manual_seed(9)
    batches = [{"tokens": torch.randint(0, model.cfg.vocab_size, (4, 1, 16),
                                        generator=gen, device=cuda)}
               for _ in range(3)]
    _assert_same_run(*_graphed_against_eager(
        cuda, model, _bus_run(gossip_groups=groups), batches))


@pytest.mark.requires_cuda
def test_cuda_graphed_vlm_step_refreshes_the_frontend(cuda, monkeypatch):
    """The VLM smoke model's graphed step copies every step's frontend
    into its static buffer: 3 steps (the first eager and captured, two
    replays), each with a new frontend — step 1 repeats step 0's tokens,
    so a replay that read a stale frontend would part from the eager
    step — bit-equal to 3 eager steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("pixtral_12b"))
    cfg = model.cfg
    gen = torch.Generator(device=cuda).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1, 16), generator=gen,
                           device=cuda)
    batches = [{"tokens": tokens if t < 2 else tokens.flip(-1),
                "frontend": torch.randn((4, 1, cfg.n_frontend_tokens,
                                         cfg.d_model), generator=gen,
                                        device=cuda)}
               for t in range(3)]
    _assert_same_run(*_graphed_against_eager(cuda, model, _bus_run(),
                                             batches))


@pytest.mark.requires_cuda
def test_cuda_graphed_encdec_step_refreshes_the_frames(cuda, monkeypatch):
    """The encoder-decoder smoke model's graphed step copies every step's
    frames into its static buffer: 3 steps (the first eager and captured,
    two replays), each with new frames — step 1 repeats step 0's tokens —
    bit-equal to 3 eager steps, one EDM and one ring kernel in each
    step's trace."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    model = build_model(get_smoke_config("whisper_small"))
    cfg = model.cfg
    gen = torch.Generator(device=cuda).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (4, 1, 16), generator=gen,
                           device=cuda)
    batches = [{"tokens": tokens if t < 2 else tokens.flip(-1),
                "frontend": torch.randn((4, 1, cfg.n_frontend_tokens,
                                         cfg.d_model), generator=gen,
                                        device=cuda)}
               for t in range(3)]
    _assert_same_run(*_graphed_against_eager(cuda, model, _bus_run(),
                                             batches))


# ---------------------------------------------------------------------------
# the peer-pointer ring (kernel 8's multi-rank form): ranks on one card
# ---------------------------------------------------------------------------

RING_W = ((0, 1 / 3), (1, 1 / 3), (-1, 1 / 3))   # ring(n)'s terms
PEER_EDGE_ROWS = 4096


def _peer_payload_at(start, stop, rank, epoch, device, specials):
    """Elements [start, stop) of rank ``rank``'s payload at ``epoch``: a
    hash of (element, rank, epoch), so a rank computes its neighbours'
    payloads without reading them (the check is independent of the
    protocol it tests); NaN and ±Inf at fixed elements when ``specials``."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    h = (idx * 2654435761 + rank * 97 + epoch * 7919) % 1000003
    vals = h.to(torch.float32) / 1000003.0 - 0.5
    if specials:
        for pos, v in ((5, float("nan")), (17, float("inf")),
                       (33, float("-inf"))):
            p = pos + 64 * rank
            if start <= p < stop:
                vals[p - start] = v
    return vals


def _peer_fill(x, rank, epoch, specials, chunk=1 << 28):
    flat = x.view(-1)
    for s in range(0, flat.numel(), chunk):
        e = min(s + chunk, flat.numel())
        flat[s:e] = _peer_payload_at(s, e, rank, epoch, x.device, specials)


def _peer_rank(rank, world, rows, epochs, timeout, timeout_case, d):
    """One rank of :func:`_ring_peer_check` (a spawned process): a
    ``PeerRing`` on the card, its handle exchanged over gloo, the step
    protocol for ``epochs`` epochs, its output against the plain version
    on its own and its neighbours' payloads (every element, bit for bit,
    a NaN matching a NaN; past element 2³¹ the first and last 4096 rows).
    ``timeout_case``: rank 1 never publishes, rank 0's wait must time out
    and raise.  Writes ``rank<r>.json`` to ``d``."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.kernels.ring_peer import PeerRing
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    shape = (1, rows, 128)
    ring = PeerRing(shape, dev, rank, world, timeout_s=timeout)
    handles = [None] * world
    dist.all_gather_object(handles, ring.handle)
    ring.open(handles)
    left, right = (rank - 1) % world, (rank + 1) % world
    rec = {"rank": rank, "ok": True}
    specials = rows * 128 < (1 << 31)
    if timeout_case:
        if rank == 0:
            _peer_fill(ring.payload_for_write(), rank, 0, specials)
            try:
                ring.combine(RING_W)
                rec.update(ok=False, error="no timeout")
            except RuntimeError as err:
                rec["raised"] = str(err)
                rec["ok"] = "waited more than" in str(err)
    else:
        out = torch.empty(shape, device=dev)
        spans = ([(0, rows)] if specials else
                 [(0, PEER_EDGE_ROWS), (rows - PEER_EDGE_ROWS, rows)])
        for epoch in range(epochs):
            _peer_fill(ring.payload_for_write(), rank, epoch, specials)
            ring.combine(RING_W, out=out)
            for r0, r1 in spans:
                s, e = r0 * 128, r1 * 128
                want = ref.ring_peer_ref(*(
                    _peer_payload_at(s, e, r, epoch, dev,
                                     specials).view(1, -1, 128)
                    for r in (rank, left, right)), RING_W, world)
                got = out[:, r0:r1]
                same = bool(((got.view(torch.int32) == want.view(torch.int32))
                             | (torch.isnan(got) & torch.isnan(want))).all())
                rec["ok"] &= same
        rec["epochs"] = ring.epoch
        rec["launches"] = ops.launch_counts()["ring_peer"]
    torch.cuda.synchronize()
    dist.barrier()
    ring.close()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _ring_peer_check(tmp_path, ranks, rows=2048, epochs=3, timeout=60.0,
                     timeout_case=False):
    """``ranks`` spawned processes on the card, one peer ring: each rank's
    record (:func:`_peer_rank`)."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_peer_rank, args=(ranks, rows, epochs, timeout, timeout_case,
                               str(tmp_path)), nprocs=ranks, join=True)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(ranks)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_ring_peer_bit_equal_to_plain(cuda, tmp_path, ranks):
    """The flags and the combine over 3 epochs, each rank's output against
    the plain version on its own and its neighbours' payloads (NaN, ±Inf
    among them), bit for bit; one launch a rank an epoch."""
    recs = _ring_peer_check(tmp_path, ranks, epochs=3)
    assert len(recs) == ranks
    for r in recs:
        assert r["ok"], r
        assert r["epochs"] == r["launches"] == 3, r


@pytest.mark.requires_cuda
def test_cuda_ring_peer_past_element_2_31(cuda, tmp_path):
    """A payload of 2³¹ + 2¹⁸ elements a rank: the first and last 4096
    rows bit-equal to the plain version."""
    for r in _ring_peer_check(tmp_path, 2, rows=16779264, epochs=2):
        assert r["ok"], r
        assert r["epochs"] == r["launches"] == 2, r


@pytest.mark.requires_cuda
def test_cuda_ring_peer_flag_timeout_raises(cuda, tmp_path):
    """A rank that never publishes its payload: its neighbour's bounded
    wait times out and the combine raises instead of hanging."""
    recs = _ring_peer_check(tmp_path, 2, timeout=2.0, timeout_case=True)
    assert recs[0]["ok"], recs[0]
    assert "waited more than 2 s" in recs[0]["raised"]


# ---------------------------------------------------------------------------
# the peer-pointer source table (kernel 2's multi-rank table form)
# ---------------------------------------------------------------------------

TABLE_CASES = ("ring", "exp", "late", "masked")


def _table_round(case, rank, world):
    """Rank ``rank``'s ``(src, weights)`` column of a round, and the ring
    kernel's terms when it runs that round: a ±1 ring (the ring kernel), an
    exponential hop, the ring with every term that reads rank 0 late (its
    source set to the rank itself; rank 0's payload is NaN that epoch), the
    ring with rank ``world − 1`` down (masked: its terms and its
    neighbours' terms that read it point at the reader)."""
    left, right = (rank - 1) % world, (rank + 1) % world
    w = [1 / 3, 1 / 3, 1 / 3]
    if case == "ring":
        return [rank, left, right], w, list(RING_W)
    if case == "exp":
        return [rank, (rank - 2) % world, rank], [0.5, 0.5, 0.0], None
    if case == "late":
        src = [rank if s == 0 and rank != 0 else s
               for s in (rank, left, right)]
        return src, w, None
    dead = world - 1
    if rank == dead:
        return [rank], [1.0], None
    return [rank if s == dead else s for s in (rank, left, right)], w, None


def _table_rank(rank, world, rows, timeout, timeout_case, d):
    """One rank of :func:`_table_peer_check` (a spawned process): a
    ``PeerTable`` on the card, handles exchanged over gloo, one epoch of
    each of ``TABLE_CASES`` (publish, then combine), its output against the
    plain version on the payloads it names, bit for bit (a NaN matching a
    NaN; past element 2³¹ the first and last 4096 rows); in the ``late``
    epoch rank 0's payload is all NaN and no other rank may read it (their
    outputs finite).  ``timeout_case``: rank 1 never publishes, rank 0's
    wait must time out and raise."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.kernels.table_peer import PeerTable
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    shape = (1, rows, 128)
    table = PeerTable(shape, dev, rank, world, timeout_s=timeout)
    handles = [None] * world
    dist.all_gather_object(handles, table.handle)
    table.open(handles)
    rec = {"rank": rank, "ok": True, "finite": True}
    specials = rows * 128 < (1 << 31)
    if timeout_case:
        if rank == 0:
            src, w, _ = _table_round("ring", rank, world)
            _peer_fill(table.slot_for_write(range(world)), rank, 0, specials)
            table.publish(None, range(world))
            try:
                table.combine(src, w)
                rec.update(ok=False, error="no timeout")
            except RuntimeError as err:
                rec["raised"] = str(err)
                rec["ok"] = "waited more than" in str(err)
    else:
        out = torch.empty(shape, device=dev)
        spans = ([(0, rows)] if specials else
                 [(0, PEER_EDGE_ROWS), (rows - PEER_EDGE_ROWS, rows)])
        for epoch, case in enumerate(TABLE_CASES):
            poisoned = case == "late"
            slot = table.slot_for_write(range(world))
            if poisoned and rank == 0:
                slot.fill_(float("nan"))
            else:
                _peer_fill(slot, rank, epoch, specials)
            table.publish(None, range(world))
            src, w, ring_terms = _table_round(case, rank, world)
            table.combine(src, w, out=out, ring_terms=ring_terms)
            for r0, r1 in spans:
                s, e = r0 * 128, r1 * 128
                pays = [torch.full((1, (e - s) // 128, 128), float("nan"),
                                   device=dev) if poisoned and r == 0
                        else _peer_payload_at(s, e, r, epoch, dev,
                                              specials).view(1, -1, 128)
                        for r in range(world)]
                want = ref.table_peer_ref(pays, src, w)
                got = out[:, r0:r1]
                same = bool(((got.view(torch.int32) == want.view(torch.int32))
                             | (torch.isnan(got) & torch.isnan(want))).all())
                rec["ok"] &= same
                if poisoned and rank != 0:
                    rec["finite"] &= not bool(torch.isnan(got).all(-1).any())
        rec["epochs"] = table.epoch
        counts = ops.launch_counts()
        rec["launches"] = [counts["table_peer"], counts["ring_peer"]]
    torch.cuda.synchronize()
    dist.barrier()
    table.close()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _table_peer_check(tmp_path, ranks, rows=2048, timeout=60.0,
                      timeout_case=False):
    """``ranks`` spawned processes on the card, one peer table: each rank's
    record (:func:`_table_rank`)."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_table_rank, args=(ranks, rows, timeout, timeout_case,
                                str(tmp_path)), nprocs=ranks, join=True)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(ranks)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_table_peer_bit_equal_to_plain(cuda, tmp_path, ranks):
    """A ring round (the ring kernel on the table's slots), an exponential
    hop, a late round and a masked round, each rank's output against the
    plain version on the payloads it names (NaN, ±Inf among them), bit for
    bit; a late source's NaN payload is never read; one launch a rank an
    epoch."""
    recs = _table_peer_check(tmp_path, ranks)
    assert len(recs) == ranks
    for r in recs:
        assert r["ok"] and r["finite"], r
        assert r["epochs"] == len(TABLE_CASES), r
        assert r["launches"] == [len(TABLE_CASES) - 1, 1], r


@pytest.mark.requires_cuda
def test_cuda_table_peer_past_element_2_31(cuda, tmp_path):
    """A payload of 2³¹ + 2¹⁸ elements a rank: the first and last 4096
    rows of every round bit-equal to the plain version."""
    for r in _table_peer_check(tmp_path, 2, rows=16779264):
        assert r["ok"] and r["finite"], r


@pytest.mark.requires_cuda
def test_cuda_table_peer_flag_timeout_raises(cuda, tmp_path):
    """A rank that never publishes its payload: a reader's bounded wait
    times out and the combine raises instead of hanging."""
    recs = _table_peer_check(tmp_path, 2, timeout=2.0, timeout_case=True)
    assert recs[0]["ok"], recs[0]
    assert "waited more than 2 s" in recs[0]["raised"]


# ---------------------------------------------------------------------------
# a rank's tree through the peer transports (the tree path across ranks)
# ---------------------------------------------------------------------------

# a ragged bf16 tree: no leaf fills whole 128-wide rows
TREE_SHAPES = {"a|w": (7, 33), "b|bias": (5,), "c|emb": (129, 3),
               "d|norm": (1,)}


def _agents_tree(device, seed, n=2):
    """An n-agent bf16 tree of :data:`TREE_SHAPES` with NaN and ±Inf in it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree = {}
    for p, shape in TREE_SHAPES.items():
        v = torch.randn((n,) + shape, generator=gen, device=device)
        flat = v.view(-1)
        flat[0] = float("nan")
        flat[-1] = float("inf") if len(tree) % 2 else float("-inf")
        tree[p] = v.to(torch.bfloat16)
    return tree


def _same_tree(got, want):
    return all(bool(((g.view(torch.int16) == w.view(torch.int16))
                     | (torch.isnan(g) & torch.isnan(w))).all())
               and g.dtype == w.dtype and g.shape == w.shape
               for g, w in ((got[p], want[p]) for p in want))


def _tree_peer_rank(rank, world, d):
    """One rank of :func:`test_cuda_tree_peer_bit_equal_to_one_process`: its
    agent's block of a bf16 tree mixed across the two ranks on the ring
    (the peer ring) and on a masked round (the peer table), each over two
    epochs, against the one-process per-leaf fused combine of the whole
    tree (``gossip_axpy`` / ``table_combine`` a leaf)."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.core import ring
    from repro_torch.core.elastic import DropPlan, ElasticSchedule
    from repro_torch.core.mixing import (make_mixer, make_schedule_mixer,
                                         mix_ppermute)
    from repro_torch.core.schedule import StaticSchedule
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    mesh = make_gossip_mesh(world, agents_per_device=1, device=dev)
    masked = ElasticSchedule(StaticSchedule(ring(world)), DropPlan.from_json(
        {"n_agents": world, "epochs": [{"start": 0, "down": [1]}]}))
    rec = {"rank": rank, "shared": mesh.shared, "ok": True, "launches": []}
    for sched, one in ((StaticSchedule(ring(world)),
                        lambda t: mix_ppermute(ring(world), t,
                                               agents_per_device=world,
                                               use_fused_kernel=True)),
                       (masked, make_mixer(masked.round(0), "ppermute",
                                           agents_per_device=world,
                                           use_fused_kernel=True))):
        mix = make_schedule_mixer(sched, "ppermute", use_fused_kernel=True,
                                  mesh=mesh)
        for epoch in range(2):
            full = _agents_tree(dev, seed=11 + epoch)
            mine = {p: v[rank:rank + 1].contiguous() for p, v in full.items()}
            ops.reset_launch_counts()
            got = mix(mine, step=0)
            torch.cuda.synchronize()
            rec["launches"].append({k: v for k, v in
                                    ops.launch_counts().items() if v})
            want = {p: v[rank:rank + 1] for p, v in one(full).items()}
            rec["ok"] &= _same_tree(got, want)
        torch.cuda.synchronize()
        dist.barrier()
        mix.close()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


@pytest.mark.requires_cuda
def test_cuda_tree_peer_bit_equal_to_one_process(cuda, tmp_path):
    """Two ranks on the card, one agent each: a ragged bf16 tree (NaN and
    ±Inf in it) packed into one f32 payload goes through the peer ring on
    the ring round and through the peer table on a masked round, one
    launch a mix, and each rank's leaves come back bit-equal to its rows of
    the one-process per-leaf fused combine."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_tree_peer_rank, args=(2, str(tmp_path)), nprocs=2, join=True)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    for r in recs:
        assert r["ok"] and r["shared"], r
        assert r["launches"] == [{"ring_peer": 1}] * 2 + \
            [{"table_peer": 1}] * 2, r


def _tree_block_peer_rank(rank, world, d):
    """One rank of :func:`test_cuda_tree_block_peer_bit_equal_to_one_process`:
    its block of two agents of a bf16 tree mixed across the two ranks on
    ring(4), on ``exp_graph(4)`` and on a masked round (agent 3 down), each
    over two epochs through the peer table, against the one-process
    per-leaf fused combine of the whole tree (``gossip_axpy`` /
    ``table_combine`` a leaf)."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.core import exp_graph, ring
    from repro_torch.core.elastic import DropPlan, ElasticSchedule
    from repro_torch.core.mixing import (make_mixer, make_schedule_mixer,
                                         mix_ppermute)
    from repro_torch.core.schedule import StaticSchedule
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    B, A = 2, 2 * world
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    mesh = make_gossip_mesh(A, agents_per_device=B, device=dev)
    masked = ElasticSchedule(StaticSchedule(ring(A)), DropPlan.from_json(
        {"n_agents": A, "epochs": [{"start": 0, "down": [A - 1]}]}))

    def one_of(topo):
        return lambda t: mix_ppermute(topo, t, agents_per_device=A,
                                      use_fused_kernel=True)

    rec = {"rank": rank, "shared": mesh.shared, "ok": True, "launches": []}
    for sched, one in ((StaticSchedule(ring(A)), one_of(ring(A))),
                       (StaticSchedule(exp_graph(A)), one_of(exp_graph(A))),
                       (masked, make_mixer(masked.round(0), "ppermute",
                                           agents_per_device=A,
                                           use_fused_kernel=True))):
        mix = make_schedule_mixer(sched, "ppermute", use_fused_kernel=True,
                                  mesh=mesh)
        for epoch in range(2):
            full = _agents_tree(dev, seed=21 + epoch, n=A)
            mine = {p: v[rank * B:(rank + 1) * B].contiguous()
                    for p, v in full.items()}
            ops.reset_launch_counts()
            got = mix(mine, step=0)
            torch.cuda.synchronize()
            rec["launches"].append({k: v for k, v in
                                    ops.launch_counts().items() if v})
            want = {p: v[rank * B:(rank + 1) * B]
                    for p, v in one(full).items()}
            rec["ok"] &= _same_tree(got, want)
        torch.cuda.synchronize()
        dist.barrier()
        mix.close()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


@pytest.mark.requires_cuda
def test_cuda_tree_block_peer_bit_equal_to_one_process(cuda, tmp_path):
    """Two ranks on the card, two agents each: a ragged bf16 tree (NaN and
    ±Inf in it) packed into one ``(2, rows, 128)`` f32 payload a rank goes
    through the peer table on the ring, an exponential and a masked round,
    one ``table_peer`` launch a mix, and each rank's leaves come back
    bit-equal to its rows of the one-process per-leaf fused combine."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_tree_block_peer_rank, args=(2, str(tmp_path)), nprocs=2,
             join=True)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    for r in recs:
        assert r["ok"] and r["shared"], r
        assert r["launches"] == [{"table_peer": 1}] * 6, r


# ---------------------------------------------------------------------------
# the peer table's wire and block forms: bf16 and int8 payloads, B agents
# a rank (kernel 4's multi-rank form, csrc/table_peer_q8.cu; kernel 2's
# table form on bf16 and on (B, rows, 128) blocks)
# ---------------------------------------------------------------------------

WIRE_BR = 64            # the int8 scale tiles' rows
WIRE_FORMS = (("f32", 2), ("bf16", 1), ("bf16", 2), ("int8", 1),
              ("int8", 2))
WIRE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}


def _wire_at(start, stop, agent, epoch, device, fmt, specials):
    """Elements [start, stop) of global agent ``agent``'s payload data at
    ``epoch``, a hash of (element, agent, epoch) as :func:`_peer_payload_at`
    (NaN and ±Inf among the f32 and bf16 values when ``specials``; int8
    values over [−127, 127])."""
    if fmt != "int8":
        return _peer_payload_at(start, stop, agent, epoch, device,
                                specials).to(WIRE_DTYPES[fmt])
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return ((idx * 2654435761 + agent * 97 + epoch * 7919) % 255
            - 127).to(torch.int8)


def _scales_at(agent, epoch, n_tiles, device, specials):
    """Global agent ``agent``'s int8 scales at ``epoch``: a hash in (0, 1];
    NaN, +Inf and −Inf in the first tiles of agents 0, 1 and 2."""
    t = torch.arange(n_tiles, dtype=torch.int64, device=device)
    s = ((t * 40503 + agent * 131 + epoch * 17) % 997 + 1).to(
        torch.float32) / 997.0
    if specials and agent < 3:
        s[min(agent, n_tiles - 1)] = (float("nan"), float("inf"),
                                      float("-inf"))[agent]
    return s


def _wire_fill(pay, fmt, first, epoch, specials, poison=False,
               chunk=1 << 28):
    """Write agents ``first, first + 1, …``'s payloads at ``epoch`` into a
    rank's slot (``(q, scale)`` for int8); ``poison``: NaN in every value
    (the int8 wire: in every scale)."""
    data = pay[0] if fmt == "int8" else pay
    for b in range(data.shape[0]):
        if poison and fmt != "int8":
            data[b].fill_(float("nan"))
            continue
        flat = data[b].view(-1)
        for s in range(0, flat.numel(), chunk):
            e = min(s + chunk, flat.numel())
            flat[s:e] = _wire_at(s, e, first + b, epoch, flat.device, fmt,
                                 specials)
    if fmt == "int8":
        for b in range(data.shape[0]):
            pay[1][b] = (torch.full_like(pay[1][b], float("nan")) if poison
                         else _scales_at(first + b, epoch, pay[1].shape[1],
                                         data.device, specials))


def _wire_round(case, A, B):
    """``(src, w)`` ``(K, A)`` tables of the rounds over A agents, B a rank:
    the ±1 ring, an exponential graph, the ring with every term that reads
    rank 0's agents from another rank late (it reads the agent itself:
    rank 0's payload is poisoned that epoch) and the ring with agent A − 1
    down."""
    import numpy as np
    from repro_torch.core import exp_graph, ring
    from repro_torch.core.elastic import degrade_round
    from repro_torch.core.mixing import round_tables
    if case == "exp":
        return round_tables(exp_graph(A))
    if case == "masked":
        return round_tables(degrade_round(ring(A), [True] * (A - 1)
                                          + [False]))
    src, w = round_tables(ring(A))
    if case == "late":
        own = np.tile(np.arange(A, dtype=src.dtype), (src.shape[0], 1))
        src = np.where((src // B == 0) & (own // B != 0), own, src)
    return src, w


def _wire_rank(rank, world, forms, rows, cases, timeout, timeout_case, d):
    """One rank of :func:`_wire_peer_check` (a spawned process): for each
    ``(fmt, B)`` of ``forms`` a ``PeerTable`` of B agents' ``(B, rows,
    128)`` payload in ``fmt``, handles exchanged over gloo, one epoch of
    each of ``cases`` (publish, then combine), its output held bit for bit
    (a NaN matching a NaN; past element 2³¹ the first and last 4096 rows)
    against the one-device kernels on the whole round's payloads
    (``table_combine_flat``, f32 out, and on bf16 ``gossip_axpy_flat`` over
    the gathered terms of an unmasked round; the q8 kernel fed by
    ``table_combine_wire``); in the ``late`` epoch rank 0's payload is
    NaN and no other rank may read it.  ``timeout_case``: rank 1 never
    publishes, rank 0's wait must time out and raise."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.kernels.table_peer import PeerTable
    from repro_torch.launch.mesh import init_distributed
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    rec = {"rank": rank, "forms": {}}
    for fmt, B in forms:
        dtype = WIRE_DTYPES[fmt]
        br = WIRE_BR if fmt == "int8" else None
        table = PeerTable((B, rows, 128), dev, rank, world,
                          timeout_s=timeout, dtype=dtype, block_rows=br)
        handles = [None] * world
        dist.all_gather_object(handles, table.handle)
        table.open(handles)
        r = {"ok": True, "finite": True}
        specials = B * rows * 128 < (1 << 31)
        A = world * B
        if timeout_case:
            if rank == 0:
                src, w = _wire_round("ring", A, B)
                _wire_fill(table.slot_for_write(range(world)), fmt, 0, 0,
                           specials)
                table.publish(None, range(world))
                try:
                    table.combine(src[:, :B], w[:, :B])
                    r.update(ok=False, error="no timeout")
                except RuntimeError as err:
                    r["raised"] = str(err)
                    r["ok"] = "waited more than" in str(err)
        else:
            out = torch.empty((B, rows, 128), device=dev)
            spans = ([(0, rows)] if specials else
                     [(0, PEER_EDGE_ROWS), (rows - PEER_EDGE_ROWS, rows)])
            before = ops.launch_counts()
            for epoch, case in enumerate(cases):
                poisoned = case == "late" and rank == 0
                _wire_fill(table.slot_for_write(range(world)), fmt,
                           rank * B, epoch, specials, poison=poisoned)
                table.publish(None, range(world))
                src, w = _wire_round(case, A, B)
                cols = slice(rank * B, (rank + 1) * B)
                table.combine(src[:, cols], w[:, cols], out=out)
                for r0, r1 in spans:
                    s, e = r0 * 128, r1 * 128
                    bad = case == "late"
                    whole = torch.stack([
                        torch.full((e - s,), float("nan"), device=dev
                                   ).to(dtype) if bad and a < B
                        and fmt != "int8"
                        else _wire_at(s, e, a, epoch, dev, fmt, specials)
                        for a in range(A)]).view(A, -1, 128)
                    st = torch.from_numpy(src).to(dev)
                    wt = torch.from_numpy(w).to(dev)
                    if fmt == "int8":
                        n_tiles = rows // br
                        sc = torch.stack([
                            torch.full((n_tiles,), float("nan"), device=dev)
                            if bad and a < B else
                            _scales_at(a, epoch, n_tiles, dev, specials)
                            for a in range(A)])[:, r0 // br:r1 // br]
                        want = ops.table_combine_wire(
                            (whole, sc.contiguous()), st, wt, fmt="int8",
                            block_rows=br)
                    else:
                        want = ops.table_combine(whole, st, wt,
                                                 out_dtype=torch.float32)
                        if fmt == "bf16" and case != "masked":
                            alt = ops.gossip_axpy(
                                [whole.index_select(0, st[k].long())
                                 for k in range(st.shape[0])],
                                [float(v) for v in w[:, 0]],
                                out_dtype=torch.float32)
                            r["ok"] &= _bits_equal(alt, want)
                    got = out[:, r0:r1]
                    r["ok"] &= _bits_equal(got, want[cols])
                    if case == "late" and rank != 0:
                        r["finite"] &= not bool(
                            torch.isnan(got).all(-1).any())
            name = "table_peer_q8" if fmt == "int8" else "table_peer"
            after = ops.launch_counts()
            r["launches"] = after[name] - before[name]
            r["epochs"] = table.epoch
        torch.cuda.synchronize()
        dist.barrier()
        table.close()
        rec["forms"][f"{fmt}-B{B}"] = r
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _bits_equal(got, want):
    return bool(got.shape == want.shape and (
        (got.view(torch.int32) == want.view(torch.int32))
        | (torch.isnan(got) & torch.isnan(want))).all())


def _wire_peer_check(tmp_path, ranks, forms=WIRE_FORMS, rows=2048,
                     cases=TABLE_CASES, timeout=60.0, timeout_case=False):
    """``ranks`` spawned processes on the card, one peer table a form: each
    rank's record (:func:`_wire_rank`)."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_wire_rank, args=(ranks, forms, rows, cases, timeout,
                               timeout_case, str(tmp_path)),
             nprocs=ranks, join=True)
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(ranks)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_peer_wire_and_blocks_bit_equal_to_one_device(cuda, tmp_path,
                                                           ranks):
    """f32 blocks of 2 agents a rank, bf16 payloads of 1 and 2, int8
    payloads of 1 and 2 (the q8 kernel): a ring, an exponential graph, a
    late and a masked round, each rank's output bit-equal to the
    one-device kernels' rows of its agents (NaN, ±Inf among the values
    and the int8 scales); a late source's NaN payload is never read; one
    launch a rank an epoch."""
    recs = _wire_peer_check(tmp_path, ranks)
    assert len(recs) == ranks
    for rec in recs:
        for form, r in rec["forms"].items():
            assert r["ok"] and r["finite"], (rec["rank"], form, r)
            assert r["epochs"] == r["launches"] == len(TABLE_CASES), r


@pytest.mark.requires_cuda
def test_cuda_peer_wire_and_blocks_past_element_2_31(cuda, tmp_path):
    """Past element 2³¹ of a rank's payload: int8 at one agent of 2³¹ + 2¹⁸
    elements, bf16 at two agents of 2³⁰ + 2¹⁷ each; the first and last
    4096 rows of a ring and a masked round bit-equal to the one-device
    kernels."""
    for form, rows in ((("int8", 1),), 16779264), ((("bf16", 2),), 8390656):
        recs = _wire_peer_check(tmp_path, 2, forms=form, rows=rows,
                                cases=("ring", "masked"))
        for rec in recs:
            for name, r in rec["forms"].items():
                assert r["ok"] and r["finite"], (name, r)
                assert r["epochs"] == r["launches"] == 2, r


@pytest.mark.requires_cuda
def test_cuda_peer_wire_flag_timeout_raises(cuda, tmp_path):
    """A rank that never publishes its int8 payload: a reader's bounded
    wait times out and the q8 combine raises instead of hanging."""
    recs = _wire_peer_check(tmp_path, 2, forms=(("int8", 1),), timeout=2.0,
                            timeout_case=True)
    assert recs[0]["forms"]["int8-B1"]["ok"], recs[0]
    assert "waited more than 2 s" in recs[0]["forms"]["int8-B1"]["raised"]


# ---------------------------------------------------------------------------
# the expert-parallel MoE layer across ranks sharing the card
# (models/moe.py::apply_moe_shard_map; its sum over the model axis is
# staged through the host over gloo)
# ---------------------------------------------------------------------------

# deepseek_moe_16b's layer at full width: d 2048, E 64, k 6, ff 1408, 2
# shared experts; T = 2 × 256 rows
EP_X = (2, 256, 2048)
EP_BF16 = dict(rtol=2e-2, atol=2e-2)


def _ep_layer(dtype, device, seed=5):
    """deepseek_moe_16b's MoE layer in ``dtype`` (the router f32), x and
    the cotangent, drawn on the card from one seed (the same bits on every
    rank)."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek_moe_16b")
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    sff = cfg.n_shared_experts * ff
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, fan):
        return (torch.randn(shape, generator=gen, device=device)
                / fan ** 0.5).to(dtype)

    p = {"ln": (0.1 * torch.randn(d, generator=gen, device=device)).to(dtype),
         "router": torch.randn((d, E), generator=gen, device=device) / d ** 0.5,
         "w_gate": w(E, d, ff, fan=d), "w_up": w(E, d, ff, fan=d),
         "w_down": w(E, ff, d, fan=ff),
         "shared": {"w_gate": w(d, sff, fan=d), "w_up": w(d, sff, fan=d),
                    "w_down": w(sff, d, fan=sff)}}
    x = torch.randn(EP_X, generator=gen, device=device).to(dtype)
    ct = torch.randn(EP_X, generator=gen, device=device)
    return cfg, p, x, ct


def _ep_grads(p, x):
    out = {"x": x.grad}
    out.update({k: v.grad for k, v in p.items() if k != "shared"})
    out.update({f"shared|{k}": v.grad for k, v in p["shared"].items()})
    return out


def _ep_rank(rank, world, d, device="cuda"):
    """One rank of :func:`test_cuda_moe_shard_map_ranks`: its block of
    experts; in f32 the layer's forward and gradient against the
    one-process ``apply_moe`` (relative norms), in bf16 its output (bits
    saved for the cross-rank check) against it."""
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(device, init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    mesh = make_moe_mesh(1, world)
    rec = {"rank": rank, "shared": mesh.shared}
    n = 64 // world

    def rel(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float((a - b).norm() / b.norm())

    for dtype in (torch.float32, torch.bfloat16):
        cfg, full, x, ct = _ep_layer(dtype, dev)
        grad = dtype == torch.float32
        block = {k: (v[rank * n:(rank + 1) * n].clone()
                     if k in ("w_gate", "w_up", "w_down") else v)
                 for k, v in full.items()}
        leaves = [x, *full["shared"].values(), *(
            v for k, v in full.items() if k != "shared"), *(
            block[k] for k in ("w_gate", "w_up", "w_down"))]
        for t in leaves:
            t.requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            want, aux_want = moe.apply_moe(full, cfg, x, cfg.norm_eps)
            if grad:
                ((want.float() * ct).sum() + aux_want).backward()
                g_want = _ep_grads(full, x)
                for t in leaves:
                    t.grad = None
            with comm.recording() as log:
                got, aux = moe.apply_moe_shard_map(block, cfg, x,
                                                   cfg.norm_eps, mesh)
            if grad:
                ((got.float() * ct).sum() + aux).backward()
                g_got = _ep_grads(block, x)
        tag = "f32" if grad else "bf16"
        rec[f"{tag}_y_rel"] = rel(got, want)
        rec[f"{tag}_aux_rel"] = abs(float(aux) - float(aux_want)) / abs(
            float(aux_want))
        rec[f"{tag}_sums"] = [[c.kind, list(c.shape), c.group_size]
                              for c in log]
        if grad:
            rec["grad_rel"] = {
                k: rel(g, g_want[k][rank * n:(rank + 1) * n]
                       if k in ("w_gate", "w_up", "w_down") else g_want[k])
                for k, g in g_got.items()}
        else:
            w32, g32 = want.float(), got.float()
            rec["bf16_within"] = bool(
                ((g32 - w32).abs() <= EP_BF16["atol"]
                 + EP_BF16["rtol"] * w32.abs()).all())
            torch.save(got.cpu(), f"{d}/bf16_rank{rank}.pt")
        del full, block, x, ct, got, want
        torch.cuda.empty_cache()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_moe_shard_map_ranks(cuda, tmp_path, ranks):
    """deepseek_moe_16b's MoE layer at full width (d 2048, E 64, k 6, ff
    1408, 2 shared experts; T 512) over 2 and 4 ranks sharing the card,
    each holding E / ranks experts: one all-reduce of (512, 2048) over the
    model axis a call; in f32 the output, aux and every gradient leaf
    within 1e-5 relative norm of the one-process ``apply_moe`` (the expert
    block's against its slice); in bf16 every rank's output bit-equal to
    rank 0's and within 2e-2 + 2e-2·|want| of the one-process layer."""
    import json
    import torch.multiprocessing as mp
    mp.spawn(_ep_rank, args=(ranks, str(tmp_path)), nprocs=ranks, join=True)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(ranks)]
    y0 = torch.load(tmp_path / "bf16_rank0.pt")
    for r in recs:
        assert r["shared"], r
        assert r["f32_y_rel"] <= 1e-5 and r["f32_aux_rel"] <= 1e-5, r
        assert all(v <= 1e-5 for v in r["grad_rel"].values()), r
        assert r["bf16_within"] and r["bf16_aux_rel"] <= 1e-5, r
        for tag in ("f32", "bf16"):
            assert r[f"{tag}_sums"] == [["all-reduce", [512, 2048], ranks]]
        y = torch.load(tmp_path / f"bf16_rank{r['rank']}.pt")
        assert torch.equal(y.view(torch.int16), y0.view(torch.int16))


# ---------------------------------------------------------------------------
# tensor-parallel serving across ranks sharing the card
# (build_model(cfg, mesh=grid): the reference's serve_param_specs layout;
# the sums over the model axis staged through the host over gloo)
# ---------------------------------------------------------------------------

# a small qwen3_14b variant whose rank, at 2 ranks, holds qwen3_14b's
# per-rank heads at 4: K 2, G 5, hd 128
TP_CFG = dict(n_layers=2, d_model=512, n_heads=20, n_kv_heads=4,
              head_dim=128, d_ff=1024, vocab_size=1024)
TP_RANKS = 2


def _tp_serve(dtype, rank=None, world=1, mesh=None):
    """The paged engine (the kernels) on a closed trace of 4 requests:
    tokens and launch counts, whole in one process or the rank's block
    of ``init_lm_rank`` on ``mesh``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, poisson_load)
    cfg = dataclasses.replace(get_config("qwen3_14b"), **TP_CFG,
                              dtype=dtype)
    model = build_model(cfg, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = (model.init(gen) if mesh is None
              else init_lm_rank(cfg, gen, rank, world))
    pcfg = PagedCacheConfig(page_size=16, num_pages=1 + 4 * 256 // 16,
                            max_slots=4, max_context=256)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                   prefill_chunk=64, max_step_tokens=128,
                                   device="cuda")
    reqs = poisson_load(4, rate=1000.0, vocab=cfg.vocab_size,
                        prompt_buckets=(40, 150), new_token_buckets=(8, 16),
                        prompt_dist="exact", seed=5)
    ops.reset_launch_counts()
    metrics = eng.run([dataclasses.replace(r, arrival=0.0) for r in reqs])
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    toks = {str(r): t.tolist() for r, t in sorted(eng.completed.items())}
    return {"tokens": toks, "counts": counts, "steps": metrics["steps"],
            "mixed_steps": metrics["mixed_steps"],
            "local_heads": params["blocks|0|attn|wk"].shape[-1] // 128}


def _tp_rank(rank, world, d):
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=300)
    mesh = make_moe_mesh(1, world)
    rec = {"shared": mesh.shared}
    for dtype in ("float32", "bfloat16"):
        rec[dtype] = _tp_serve(dtype, rank, world, mesh)
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


# 4-rank cases at full width, each (dtype, depth cut): pixtral_12b at 2
# layers (K 2, G 4 a rank), a frontend batch and the paged engine;
# jamba_1_5_large_398b with every kind of layer — f32 at 3 layers (its
# attention layer moved to position 2, so that the f32 model fits the
# card twice over: 51.7 GB) and bf16 at phase 21's 5 (48.1 GB)
TP_FULL = {"pixtral_12b": [("float32", dict(n_layers=2))],
           "jamba_1_5_large_398b": [
               ("float32", dict(n_layers=3, attn_every=3, attn_offset=2)),
               ("bfloat16", dict(n_layers=5))]}
TP_FULL_BATCH = (2, 64, 8)      # prompts, prompt length, new tokens


def _tp_full_config(arch, dtype, cut):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), dtype=dtype, **cut)


def _tp_full_run(model, params):
    """The fixed batch through ``greedy_generate`` (a VLM: with seeded
    frontend embeddings) and, for a model of attention mixers only, the
    paged engine (the kernels) on a closed trace of 4 requests: tokens
    and launch counts."""
    import dataclasses
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, greedy_generate,
                                   poisson_load)
    cfg = model.cfg
    n, S, n_new = TP_FULL_BATCH
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)).cuda()}
    if cfg.n_frontend_tokens:
        gen = torch.Generator(device="cuda").manual_seed(2)
        batch["frontend"] = torch.randn(
            (n, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device="cuda").to(getattr(torch, cfg.dtype))
    ops.reset_launch_counts()
    out = {"greedy": greedy_generate(model, params, batch,
                                     n_new).cpu().tolist(),
           "greedy_counts": {k: v for k, v in ops.launch_counts().items()
                             if v}}
    if cfg.family != "vlm":
        return out
    pcfg = PagedCacheConfig(page_size=16, num_pages=1 + 4 * 256 // 16,
                            max_slots=4, max_context=256)
    eng = ContinuousBatchingEngine(model, params, pcfg, attn_impl="kernel",
                                   prefill_chunk=64, max_step_tokens=128,
                                   device="cuda")
    reqs = poisson_load(4, rate=1000.0, vocab=cfg.vocab_size,
                        prompt_buckets=(40, 150), new_token_buckets=(8, 16),
                        prompt_dist="exact", seed=5)
    ops.reset_launch_counts()
    metrics = eng.run([dataclasses.replace(r, arrival=0.0) for r in reqs])
    out.update(counts={k: v for k, v in ops.launch_counts().items() if v},
               tokens={str(r): t.tolist()
                       for r, t in sorted(eng.completed.items())},
               steps=metrics["steps"], mixed_steps=metrics["mixed_steps"])
    return out


def _tp_full_rank(rank, world, arch, d):
    """One rank of a full-width case: per (dtype, cut) the model on the
    grid, the rank-local init one rank at a time (a Jamba MoE layer's
    draw is a 12.9 GB f32 slice; expandable segments, so that the freed
    draws leave no holes), then :func:`_tp_full_run`."""
    import json
    import os
    from pathlib import Path
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_moe_mesh
    from repro_torch.models import build_model
    from repro_torch.models.transformer import init_lm_rank
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{d}/store", rank=rank,
                     world_size=world, timeout_s=900)
    mesh = make_moe_mesh(1, world)
    rec = {"shared": mesh.shared}
    for dtype, cut in TP_FULL[arch]:
        cfg = _tp_full_config(arch, dtype, cut)
        model = build_model(cfg, mesh=mesh)
        for r in range(world):
            if r == rank:
                params = init_lm_rank(cfg, torch.Generator(
                    device="cuda").manual_seed(0), rank, world)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        run = _tp_full_run(model, params)
        run["local"] = {k.split("|", 2)[-1]: list(v.shape)
                        for k, v in params.items()
                        if k.startswith("blocks|") and k.split("|")[1]
                        in ("0", "1", "2")}
        rec[dtype] = run
        del params, model
        torch.cuda.empty_cache()
        dist.barrier()
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.barrier()
    dist.destroy_process_group()


def _tp_full_one_process(arch):
    """The one-process runs of each (dtype, cut) of ``arch`` (the whole
    model from ``model.init``, seed 0), one at a time."""
    from repro_torch.models import build_model
    out = {}
    for dtype, cut in TP_FULL[arch]:
        model = build_model(_tp_full_config(arch, dtype, cut))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        out[dtype] = _tp_full_run(model, params)
        del params, model
        torch.cuda.empty_cache()
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["qwen3_14b", "pixtral_12b",
                                  "jamba_1_5_large_398b"])
def test_cuda_tp_serve_ranks(cuda, tmp_path, case):
    """``qwen3_14b``: a small variant served by the paged engine on 2
    ranks sharing the card, each holding K 2, G 5 heads of hd 128
    (qwen3_14b's rank at 4): in f32 every rank's tokens equal the
    one-process engine's; in bf16 every rank's tokens equal rank 0's; in
    both the kernels' launches equal the one-process engine's (L a
    dispatch, L a mixed one) and no plain twin runs.  ``pixtral_12b`` and
    ``jamba_1_5_large_398b`` at full width on 4 ranks (:data:`TP_FULL`):
    in f32 every rank's ``greedy_generate`` tokens (Pixtral: with a
    frontend batch) and Pixtral's paged-engine tokens (K 2, G 4 a rank)
    equal one process's, the engine's launches the one-process engine's;
    Jamba's bf16 tokens at 5 layers equal on every rank (the share equal
    to one process's printed); each rank holds its share of the heads,
    the FFN columns, the experts and the SSM channels."""
    import json
    import torch.multiprocessing as mp
    torch.backends.cuda.matmul.allow_tf32 = False
    if case != "qwen3_14b":
        from repro_torch.configs import get_config
        one = _tp_full_one_process(case)
        mp.spawn(_tp_full_rank, args=(4, case, str(tmp_path)), nprocs=4,
                 join=True)
        recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
                for r in range(4)]
        cfg = get_config(case)
        for r in recs:
            assert r["shared"]
            for dtype, cut in TP_FULL[case]:
                got, want = r[dtype], one[dtype]
                if dtype == "float32":
                    assert got["greedy"] == want["greedy"], (case, dtype)
                else:
                    assert got["greedy"] == recs[0][dtype]["greedy"]
                    same = np.mean(np.array(got["greedy"])
                                   == np.array(want["greedy"]))
                    print(f"{case} {dtype}: {same:.1%} of the tokens equal "
                          "to one process's")
                assert got["greedy_counts"] == want["greedy_counts"] == {}
                if "tokens" in want:
                    L = cut["n_layers"]
                    assert got["tokens"] == want["tokens"]
                    assert got["counts"] == want["counts"] == {
                        "paged_attention": L * got["steps"],
                        "paged_prefill": L * got["mixed_steps"]}
                loc = got["local"]
                for key, shape in loc.items():
                    if key.endswith("attn|wk"):
                        assert shape[-1] == cfg.n_kv_heads // 4 * cfg.hd
                    if key.endswith("ssm|in_proj"):
                        assert shape[-1] == 2 * cfg.d_inner // 4
                    if key.endswith("moe|w_gate"):
                        assert shape[1] == cfg.n_experts // 4
                    if key.endswith("ffn|w_up"):
                        assert shape[-1] == (cfg.dense_d_ff or cfg.d_ff) // 4
        return
    one = {dt: _tp_serve(dt) for dt in ("float32", "bfloat16")}
    mp.spawn(_tp_rank, args=(TP_RANKS, str(tmp_path)), nprocs=TP_RANKS,
             join=True)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(TP_RANKS)]
    L = TP_CFG["n_layers"]
    for r in recs:
        assert r["shared"]
        assert r["float32"]["tokens"] == one["float32"]["tokens"]
        assert r["bfloat16"]["tokens"] == recs[0]["bfloat16"]["tokens"]
        for dt in ("float32", "bfloat16"):
            got = r[dt]
            assert got["counts"] == one[dt]["counts"]
            assert got["counts"] == {
                "paged_attention": L * got["steps"],
                "paged_prefill": L * got["mixed_steps"]}
            assert got["local_heads"] == 2


def _cli_metrics(stdout):
    import json
    line = next(ln for ln in stdout.splitlines()
                if ln.startswith("serve metrics: "))
    return json.loads(line[len("serve metrics: "):])


@pytest.mark.requires_cuda
def test_cuda_serve_cli_tp_under_torchrun(cuda, tmp_path):
    """The serve CLI's tensor-parallel path on the card, as a user runs it:
    ``torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.serve
    --continuous-batching --attn-impl kernel --ckpt ...`` on the smoke
    ``qwen3_14b`` serves on the ``(1, 2)`` grid, each rank cutting its
    block of the consensus file on load; rank 0 alone prints the summary,
    with the file's digest and every rank's token digest equal to the
    one-process CLI's on the card."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.weights import tensor_to_array
    root = Path(__file__).resolve().parent.parent
    params = build_model(get_smoke_config("qwen3_14b")).init(
        torch.Generator().manual_seed(3))
    np.savez(tmp_path / "consensus.npz",
             **{k: tensor_to_array(v) for k, v in params.items()})
    cli = ["--arch", "qwen3_14b", "--smoke", "--continuous-batching",
           "--attn-impl", "kernel", "--prefill-chunk", "8",
           "--max-step-tokens", "16", "--prompt-dist", "exact",
           "--requests", "4", "--ckpt", str(tmp_path / "consensus.npz")]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *cli], env=env, cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert one.returncode == 0, one.stderr[-3000:]
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *cli],
        env=env, cwd=root, capture_output=True, text=True, timeout=600)
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert "tp grid=(1, 2) heads/rank=2/2" in ranks.stdout
    assert ranks.stdout.count("serve metrics: ") == 1
    want, got = _cli_metrics(one.stdout), _cli_metrics(ranks.stdout)
    assert got["rank_token_digests"] == [want["token_digest"]] * 2
    assert got["params_sha256"] == want["params_sha256"]
    assert got["requests"] == want["requests"] == 4


# ---------------------------------------------------------------------------
# the tree train path under tensor parallelism: a (2, 2) ("data", "model")
# grid of four ranks on the card, two peer transports side by side (one a
# model column, each over its 2-rank data slice)
# ---------------------------------------------------------------------------

TP_TRAIN_SHAPE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab_size=256)


def _tp_train_rank(rank, world, d):
    """One rank of :func:`test_cuda_tp_train_ranks`: for B = 1 (A = 2,
    ring(2): the peer ring) and B = 2 (A = 4, ring(4): the peer table),
    2 steps of the fused TP tree step on the card, every ``edm_update``
    launch on the rank's blocks held to the plain twin on copies of its
    inputs; then the step's mixer on the card (the peer transport of the
    rank's column) against the same mixer on the CPU over gloo (the
    permutes and the combine kernels' plain twins, which CPU tensors
    take) on the rank's final x."""
    import dataclasses
    import json
    from pathlib import Path
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.mixing import build_mixer
    from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    dev = init_distributed("cuda", init_method=f"file://{d}/store",
                           rank=rank, world_size=world, timeout_s=300)
    model = build_model(dataclasses.replace(get_config("qwen3_14b"),
                                            **TP_TRAIN_SHAPE))
    inner = ops.edm_update_flat
    rec = {"rank": rank, "ok": True, "runs": {}}

    def spy(x, g, m, psi, *, alpha, beta, out=None):
        want = ref.edm_update_ref(x.clone(), g, m.clone(), psi.clone(),
                                  alpha=alpha, beta=beta)
        got = inner(x, g, m, psi, alpha=alpha, beta=beta, out=out)
        rec["ok"] &= all(torch.equal(a.view(torch.int32), b.view(
            torch.int32)) for a, b in zip(got, want))
        return got

    for B in (1, 2):
        A = 2 * B
        grid = make_gossip_mesh(A, agents_per_device=B, model=2, device=dev)
        host = make_gossip_mesh(A, agents_per_device=B, model=2,
                                device="cpu")
        run = RunConfig(global_batch=A, seq_len=16, algorithm="edm",
                        alpha=0.2, beta=0.9, gossip_engine="ppermute",
                        packed_bus=False, agents_per_device=B, remat=False)
        sched = make_gossip_schedule(run, A)
        step = build_train_step(model, run, sched, use_fused_kernel=True,
                                mesh=grid)
        state = init_state(model, run, A, seed=0, mesh=grid)
        gen = torch.Generator().manual_seed(9)
        ops.reset_launch_counts()
        ops.edm_update_flat = spy
        try:
            for _ in range(2):
                tokens = torch.randint(0, 256, (A, 1, 16), generator=gen)
                state, m = step(state, {"tokens": tokens.to(dev)})
            torch.cuda.synchronize()
        finally:
            ops.edm_update_flat = inner
        r = {"launches": {k: v for k, v in ops.launch_counts().items()
                          if v},
             "leaves": len(state["params"]),
             "losses": m["agent_losses"].tolist()}
        card = build_mixer(sched, mode="schedule", engine="ppermute",
                           use_fused_kernel=True, mesh=grid)
        plain = build_mixer(sched, mode="schedule", engine="ppermute",
                            use_fused_kernel=True, mesh=host)
        x = state["params"]
        got = card(x, step=0)
        want = plain({p: v.cpu() for p, v in x.items()}, step=0)
        r["mix_equal"] = all(torch.equal(got[p].cpu().view(torch.int16),
                                         want[p].view(torch.int16))
                             for p in x)
        torch.cuda.synchronize()
        dist.barrier()
        card.close()
        step.close()
        rec["runs"][B] = r
    Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


@pytest.mark.requires_cuda
def test_cuda_tp_train_ranks(cuda, tmp_path):
    """Four ranks on the card as a ``(2, 2)`` grid train a small bf16
    dense model on the tree path tensor-parallel: one ``edm_update``
    launch a leaf a step on each rank's blocks, each bit-equal to the
    plain twin; one ``ring_peer`` launch a step (B = 1) or one
    ``table_peer`` (B = 2) in each model column; every rank the same
    per-agent losses; and each column's peer transport on the card gives
    the bits of the same mix over gloo on the CPU."""
    import json
    import torch.multiprocessing as mp
    from repro_torch.kernels import build
    build.build_all()
    mp.spawn(_tp_train_rank, args=(4, str(tmp_path)), nprocs=4, join=True)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    for r in recs:
        assert r["ok"], r
        for B, run in r["runs"].items():
            combine = "ring_peer" if B == "1" else "table_peer"
            assert run["launches"] == {"edm_update": 2 * run["leaves"],
                                       combine: 2}, (B, run)
            assert run["mix_equal"], (B, run)
            assert run["losses"] == recs[0]["runs"][B]["losses"]
