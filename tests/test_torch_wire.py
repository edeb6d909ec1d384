"""The port's gossip wire: the codec against ``repro.core.wire``, and the
plain versions of the EF update and the int8 combine kernels against the
JAX package's Pallas kernels (interpret mode on the CPU).  The CUDA
kernels against their plain versions, on the card, are in
``test_torch_cuda.py``.

Inputs are buses of ``(block_rows, 128)`` tiles made with numpy: random
tiles and edge tiles — all zero (the bus pad), NaN, ±Inf beside finite
values, ±Inf in an otherwise all-zero tile, tiny magnitudes and exact
rounding ties.  Tiny means ~1e-30, not subnormal: XLA on the CPU flushes
subnormals to zero, PyTorch keeps them.

Tolerances, with the reason:
* codec: exact (the same operations in the same order);
* EF update: m′ and ψ′ within 8 f32 ulps of the element's largest operand
  (XLA contracts ``a*b + c`` into FMAs where the plain version rounds the
  product and the sum apart, as in ``test_torch_kernels.py``); scales
  within 1 ulp; ``q`` equal except where ``c·inv`` (int8) or ``c`` (bf16)
  lies within a few ulps of a rounding tie, and there one quantum off, on
  a share ≤ 1e-4; ``decode(q) + e′`` within 8 ulps of the same scale, and
  non-finite values equal.  Where x, g, m and ψ are zero, ``c = e`` on
  both sides and only ``e′ = c − q·scale`` can differ (an FMA in XLA);
* int8 combine: within 1e-6 of ``Σₖ|coefₖ·qₖ|`` (n rounding differences
  of the n-term sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro.kernels.edm_update import edm_update_ef_flat as j_ef_flat
from repro.kernels.edm_update import gossip_axpy_q8_flat as j_q8_flat

from repro_torch.core import wire as twire
from repro_torch.kernels import ops, ref
from repro_torch.kernels.edm_update import (edm_update_ef_flat,
                                            gossip_axpy_q8_flat)

torch.set_num_threads(1)  # xdist workers share the cores

BR = 8                              # block_rows: 8 × 128 = 1024-element tiles
FMTS = ("f32", "bf16", "int8")
Q_FLIP_SHARE = 1e-4


def edge_tiles(rng) -> np.ndarray:
    """One agent's rows: 8 tiles — random, all zero, NaN, ±Inf beside
    finite values, ±Inf in an all-zero tile, tiny, exact ties, random."""
    def normal(scale=1.0):
        return (rng.normal(size=(BR, 128)) * scale).astype(np.float32)

    nan = normal()
    nan.flat[rng.choice(nan.size, 20, replace=False)] = np.nan
    inf = normal()
    inf.flat[[3, 700]], inf.flat[[7, 900]] = np.inf, -np.inf
    zinf = np.zeros((BR, 128), np.float32)
    zinf.flat[5], zinf.flat[9] = np.inf, -np.inf
    ties = (rng.integers(-127, 127, size=(BR, 128)) + 0.5).astype(np.float32)
    ties.flat[0] = 127.0              # absmax 127: inv = 1, c·inv = c
    return np.concatenate([normal(), np.zeros((BR, 128), np.float32), nan,
                           inf, zinf, normal(1e-30), ties, normal(50.0)])


def edge_bus(seed=0, A=2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([edge_tiles(rng) for _ in range(A)])


def _np(t) -> np.ndarray:
    """Tensor (or JAX array) → numpy, bf16 widened to f32."""
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "V" or str(
        a.dtype) == "bfloat16" else a


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))   # NaN == NaN here


# ---------------------------------------------------------------------------
# the codec: exact against repro.core.wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("bus", ["random", "edge"])
def test_codec_matches_reference_exactly(fmt, bus):
    x = (np.random.default_rng(1).normal(size=(3, 4 * BR, 128)).astype(
        np.float32) if bus == "random" else edge_bus())
    jc, tc = jwire.make_codec(fmt, BR), twire.make_codec(fmt, BR)
    jx, tx = jnp.asarray(x), _t(x)
    jp, tp = jc.encode(jx), tc.encode(tx)
    jl, tl = jc.payload_leaves(jp), tc.payload_leaves(tp)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert str(t.dtype).split(".")[1] == jnp.dtype(j.dtype).name
        assert tuple(t.shape) == tuple(j.shape)
        _equal(t, j)
    _equal(tc.decode(tp), jc.decode(jp))
    _equal(tc.quantize(tx), jc.quantize(jx))
    jpay, je = jwire.encode_ef(jc, jx)
    tpay, te = twire.encode_ef(tc, tx)
    _equal(te, je)
    for j, t in zip(jc.payload_leaves(jpay), tc.payload_leaves(tpay)):
        _equal(t, j)
    for n in (1, 1000, 128 * BR, 128 * BR + 1, x.size):
        assert tc.payload_bytes(n) == jc.payload_bytes(n)
        assert tc.compression_ratio(n) == jc.compression_ratio(n)


def test_codec_edge_rules():
    """Pad tiles decode to exact zero, NaN encodes to 0, ±Inf saturates,
    and the all-zero-plus-Inf tile encodes q = 0 with scale 0; its EF
    residual is ±Inf (the codec's value)."""
    x = edge_bus()
    q, scale = twire.make_codec("int8", BR).encode(_t(x))
    q, scale = q.numpy().reshape(2, 8, -1), scale.numpy()
    assert np.all(q[:, 1] == 0) and np.all(scale[:, 1] == 0)
    nan = np.isnan(x.reshape(2, 8, -1))
    assert np.all(q[nan] == 0)
    inf = x.reshape(2, 8, -1)[:, 3]
    assert np.all(q[:, 3][np.isposinf(inf)] == 127)
    assert np.all(q[:, 3][np.isneginf(inf)] == -127)
    assert np.all(q[:, 4] == 0) and np.all(scale[:, 4] == 0)
    _, e = twire.encode_ef(twire.make_codec("int8", BR), _t(x))
    zinf = x.reshape(2, 8, -1)[:, 4]
    np.testing.assert_array_equal(e.numpy().reshape(2, 8, -1)[:, 4], zinf)
    with pytest.raises(ValueError):
        twire.make_codec("fp8", BR)


def test_codec_payload_helpers():
    tc = twire.make_codec("int8", BR)
    pay = tc.encode(_t(edge_bus()))
    assert tc.payload_from_leaves(tc.payload_leaves(pay)) == pay
    rolled = tc.map_payload(lambda l: torch.roll(l, 1, 0), pay)
    assert torch.equal(rolled[0], torch.roll(pay[0], 1, 0))
    assert torch.equal(rolled[1], torch.roll(pay[1], 1, 0))
    bc = twire.make_codec("bf16", BR)
    assert bc.wire_dtype == torch.bfloat16
    assert bc.payload_leaves(bc.encode(torch.zeros(1, BR, 128)))[0].dtype \
        == torch.bfloat16


# ---------------------------------------------------------------------------
# the EF update: plain version against the Pallas kernels
# ---------------------------------------------------------------------------

def _ef_inputs(seed, zero_state=False):
    """x, g, m, ψ random (or zero) and e the edge bus, all (rows, 128)."""
    rng = np.random.default_rng(seed)
    e = edge_bus(seed, A=1)[0]
    if zero_state:
        return [np.zeros_like(e)] * 4 + [e]
    shape = e.shape
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)] + [
        np.nan_to_num(e, nan=0.5, posinf=3.0, neginf=-3.0)]


def _ulps(scale, n):
    return n * np.spacing(np.abs(scale).astype(np.float32))


def _check_ef(got, want, inputs, fmt):
    scale_in = np.maximum.reduce([np.abs(np.nan_to_num(a, nan=0, posinf=0,
                                                       neginf=0))
                                  for a in inputs]).ravel()
    for g, w in zip(got[:2], want[:2]):                    # m', ψ'
        assert np.all(np.abs(_np(g).ravel() - _np(w).ravel())
                      <= _ulps(scale_in, 8))
    qg = _np(got[2]).astype(np.float64).ravel()
    qw = _np(want[2]).astype(np.float64).ravel()
    if fmt == "int8":
        sg, sw = _np(got[3]).ravel(), _np(want[3]).ravel()
        assert np.all(np.abs(sg - sw) <= np.spacing(np.abs(sw)))
        deq_g = (qg.reshape(len(sg), -1) * sg[:, None]).reshape(qg.shape)
        deq_w = (qw.reshape(len(sw), -1) * sw[:, None]).reshape(qw.shape)
    else:
        deq_g, deq_w = qg, qw
    finite = np.isfinite(qw)
    flips = (qg != qw) & finite
    assert flips.mean() <= Q_FLIP_SHARE, flips.mean()
    if fmt == "int8":
        assert np.all(np.abs(qg - qw)[flips] == 1)
    np.testing.assert_array_equal(qg[~finite], qw[~finite])
    eg = _np(got[-1]).astype(np.float64).ravel()
    ew = _np(want[-1]).astype(np.float64).ravel()
    cg, cw = deq_g + eg, deq_w + ew
    fin = np.isfinite(cw)
    bound = _ulps(np.maximum(scale_in[fin], np.abs(cw[fin])), 8)
    assert np.all(np.abs(cg[fin] - cw[fin]) <= bound)
    np.testing.assert_array_equal(cg[~fin], cw[~fin])


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("alpha,beta", [(0.2, 0.9), (1e-3, 0.0),
                                        (0.05, 0.99)])
@pytest.mark.parametrize("zero_state", [False, True])
def test_ef_plain_matches_pallas_kernel(fmt, alpha, beta, zero_state):
    inputs = _ef_inputs(seed=int(alpha * 1000) + int(beta * 100),
                        zero_state=zero_state)
    want = j_ef_flat(*map(jnp.asarray, inputs), alpha=alpha, beta=beta,
                     fmt=fmt, block_rows=BR, interpret=True)
    got = ref.edm_update_ef_ref(*map(_t, inputs), alpha=alpha, beta=beta,
                                fmt=fmt, block_rows=BR)
    assert len(got) == len(want)
    assert got[2].dtype == (torch.bfloat16 if fmt == "bf16" else torch.int8)
    _check_ef(got, want, inputs, fmt)
    if zero_state:        # c = e on both sides: m′, ψ′ and q exact
        for g, w in zip(got[:3], want[:3]):
            _equal(g.reshape(np.shape(w)), w)
    if fmt == "int8":     # the kernel's edge: all-zero + Inf tile → NaN e′
        e_tile = _np(got[-1]).reshape(8, -1)[4]
        zinf = inputs[4].reshape(8, -1)[4]
        if zero_state:
            assert np.all(np.isnan(e_tile[np.isinf(zinf)]))
            np.testing.assert_array_equal(
                _np(got[2]).reshape(8, -1)[4], 0)


def test_ef_plain_in_place_equals_out_of_place():
    for fmt in ("bf16", "int8"):
        x, g, m, psi, e = map(_t, _ef_inputs(seed=3))
        want = ref.edm_update_ef_ref(x, g, m, psi, e, alpha=0.2, beta=0.9,
                                     fmt=fmt, block_rows=BR)
        out = (m, psi, None) + ((None,) if fmt == "int8" else ()) + (e,)
        got = ref.edm_update_ef_ref(x, g, m, psi, e, alpha=0.2, beta=0.9,
                                    fmt=fmt, block_rows=BR, out=out)
        assert got[0] is m and got[1] is psi and got[-1] is e
        for w, o in zip(want, got):
            _equal(o, w)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_ef_bus_dispatch_matches_reference_bus_op(fmt):
    """ops.edm_update_bus_ef on CPU tensors against the JAX package's
    ops.edm_update_bus_ef over an (A, rows, 128) bus: the payload pytree
    (int8 scales shaped (A, n_tiles)) and the state outputs."""
    rng = np.random.default_rng(7)
    x, g, m, psi, e = (rng.normal(size=(2, 4 * BR, 128)).astype(np.float32)
                       for _ in range(5))
    jm, jpsi, jpay, je = jops.edm_update_bus_ef(
        *map(jnp.asarray, (x, g, m, psi, e)), alpha=0.2, beta=0.9, fmt=fmt,
        block_rows=BR)
    tm, tpsi, tpay, te = ops.edm_update_bus_ef(
        *map(_t, (x, g, m, psi, e)), alpha=0.2, beta=0.9, fmt=fmt,
        block_rows=BR)
    codec = twire.make_codec(fmt, BR)
    jl, tl = jwire.make_codec(fmt, BR).payload_leaves(jpay), \
        codec.payload_leaves(tpay)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == tuple(j.shape)
    flat = [tm, tpsi, *tl, te]
    _check_ef([t.reshape(-1, 128) if t.dim() == 3 else t for t in flat],
              [np.asarray(a).reshape(-1, 128) if np.ndim(a) == 3
               else np.asarray(a) for a in (jm, jpsi, *jl, je)],
              [a.reshape(-1, 128) for a in (x, g, m, psi, e)], fmt)
    with pytest.raises(ValueError):
        ops.edm_update_bus_ef(*map(_t, (x, g, m, psi, e)), alpha=0.2,
                              beta=0.9, fmt="f32", block_rows=BR)


# ---------------------------------------------------------------------------
# the int8 combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_q8_plain_matches_pallas_kernel(n):
    rng = np.random.default_rng(n)
    qs = [rng.integers(-127, 128, size=(4 * BR, 128)).astype(np.int8)
          for _ in range(n)]
    coefs = (rng.uniform(0.05, 1.0, size=(n, 1))
             * rng.uniform(1e-3, 1.0, size=(n, 4))).astype(np.float32)
    want = np.asarray(j_q8_flat([jnp.asarray(q) for q in qs],
                                jnp.asarray(coefs), block_rows=BR,
                                interpret=True))
    got = ref.gossip_axpy_q8_ref([_t(q) for q in qs], _t(coefs),
                                 block_rows=BR)
    assert got.dtype == torch.float32 and got.shape == (4 * BR, 128)
    tiles = np.repeat(np.arange(4), BR)[:, None]
    mag = sum(np.abs(coefs[k][tiles] * qs[k].astype(np.float32))
              for k in range(n))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag)


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
def test_wire_combine_dispatch_matches_reference_op(fmt):
    """ops.gossip_axpy_wire (CPU: plain versions) against the JAX
    package's ops.gossip_axpy_wire on the same encoded payloads."""
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(2, 4 * BR, 128)).astype(np.float32)
          for _ in range(3)]
    weights = [0.5, 0.25, 0.25]
    jc, tc = jwire.make_codec(fmt, BR), twire.make_codec(fmt, BR)
    want = np.asarray(jops.gossip_axpy_wire(
        [jc.encode(jnp.asarray(x)) for x in xs], weights, fmt=fmt,
        block_rows=BR))
    got = ops.gossip_axpy_wire([tc.encode(_t(x)) for x in xs], weights,
                               fmt=fmt, block_rows=BR)
    assert got.dtype == torch.float32 and got.shape == (2, 4 * BR, 128)
    mag = sum(w * np.abs(_np(tc.quantize(_t(x))))
              for w, x in zip(weights, xs))
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mag + 1e-30)


# ---------------------------------------------------------------------------
# dispatch: the CPU runs the plain versions; the CUDA wrappers never do
# ---------------------------------------------------------------------------

def test_cpu_dispatch_runs_plain_and_launches_nothing():
    before = ops.launch_counts()
    assert {"edm_update_ef", "gossip_axpy_q8"} <= set(before)
    x = _t(edge_bus())
    for fmt in ("bf16", "int8"):
        _, _, pay, _ = ops.edm_update_bus_ef(x, x, x.clone(), x.clone(),
                                             x.clone(), alpha=0.2, beta=0.9,
                                             fmt=fmt, block_rows=BR)
        ops.gossip_axpy_wire([pay, pay], [0.5, 0.5], fmt=fmt, block_rows=BR)
    assert ops.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    x, g, m, psi, e = map(_t, _ef_inputs(seed=0))
    for fmt in ("bf16", "int8"):
        with pytest.raises(ValueError, match="CUDA"):
            edm_update_ef_flat(x, g, m, psi, e, alpha=0.2, beta=0.9,
                               fmt=fmt, block_rows=BR)
    q = torch.zeros(x.shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_axpy_q8_flat([q, q], torch.ones(2, x.shape[0] // BR),
                            block_rows=BR)
    with pytest.raises(ValueError, match="block_rows"):
        edm_update_ef_flat(x[:BR + 4], g, m, psi, e, alpha=0.2, beta=0.9,
                           fmt="int8", block_rows=BR)
