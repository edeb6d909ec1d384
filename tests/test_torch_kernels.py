"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode on the CPU).  The CUDA kernels against their plain
versions, on the card, are in ``test_torch_cuda.py``.

Tolerances, as ulp bounds: XLA contracts ``a*b + c`` into one FMA where
the plain version rounds the product and the sum apart, so the two differ
in the last bits, and by more than rtol=1e-6 where φ = ψ' + x − ψ cancels.
* EDM update, f32: 8 f32 ulps of the element's largest operand magnitude
  (each of the three chained results carries a rounding difference,
  propagated through coefficients ≤ 1, and ψ' + x reaches twice that
  magnitude, one binade up);
* combine, f32 out: n f32 ulps of Σₖ|wₖ·oₖ| (one rounding difference per
  term of the n-term sum);
* combine, bf16 out: one bf16 ulp (the f32 sums may differ in their last
  bit before the single rounding to bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.edm_update import edm_update_flat as j_edm_update_flat
from repro.kernels.edm_update import gossip_axpy_flat as j_gossip_axpy_flat

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.edm_update import edm_update_flat, gossip_axpy_flat

torch.set_num_threads(1)  # xdist workers share the cores

ALPHA, BETA = 0.2, 0.9


def _edm_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _assert_within_ulps(got, want, scale, n_ulps):
    bound = n_ulps * np.spacing(np.abs(scale).astype(np.float32))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= bound), (err.max(), (err / bound).max())


def _edm_scale(x, g, m, psi):
    return np.maximum.reduce([np.abs(a) for a in (x, g, m, psi)])


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("alpha,beta", [(ALPHA, BETA), (1e-3, 0.0),
                                        (0.05, 0.99)])
def test_edm_plain_matches_pallas_kernel(alpha, beta):
    x, g, m, psi = _edm_inputs((64, 128))
    want = j_edm_update_flat(*map(jnp.asarray, (x, g, m, psi)), alpha=alpha,
                             beta=beta, block_rows=16, interpret=True)
    got = ref.edm_update_ref(*_t((x, g, m, psi)), alpha=alpha, beta=beta)
    for w, o in zip(want, got):
        _assert_within_ulps(o.numpy(), np.asarray(w),
                            _edm_scale(x, g, m, psi), 8)


def test_edm_bus_dispatch_matches_reference_bus_op():
    """ops.edm_update_bus on CPU tensors (plain version) against the JAX
    package's ops.edm_update_bus over an (A, rows, 128) bus."""
    x, g, m, psi = _edm_inputs((2, 512, 128), seed=1)
    want = jops.edm_update_bus(*map(jnp.asarray, (x, g, m, psi)), alpha=ALPHA,
                               beta=BETA)
    got = ops.edm_update_bus(*_t((x, g, m, psi)), alpha=ALPHA, beta=BETA)
    for w, o in zip(want, got):
        assert o.shape == (2, 512, 128)
        _assert_within_ulps(o.numpy(), np.asarray(w),
                            _edm_scale(x, g, m, psi), 8)


def test_edm_plain_in_place_equals_out_of_place():
    x, g, m, psi = _t(_edm_inputs((3, 24, 128), seed=2))
    want = ref.edm_update_ref(x, g, m, psi, alpha=ALPHA, beta=BETA)
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA,
                             out=(m, psi, None))
    assert got[0] is m and got[1] is psi
    for w, o in zip(want, got):
        assert torch.equal(w, o)


def _axpy_operands(n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    ops_ = [rng.normal(size=(32, 128)).astype(np.float32) for _ in range(n)]
    weights = list(rng.uniform(0.05, 1.0, size=n))
    if dtype == "bf16":
        ops_ = [np.asarray(jnp.asarray(o, jnp.bfloat16)) for o in ops_]
    return ops_, weights


def _to_torch(a):
    if a.dtype.kind == "V":           # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype,out_dtype", [("f32", None), ("bf16", None),
                                             ("bf16", "f32")])
def test_axpy_plain_matches_pallas_kernel(n, dtype, out_dtype):
    arrs, weights = _axpy_operands(n, dtype, seed=n)
    jout = jnp.float32 if out_dtype == "f32" else None
    want = np.asarray(j_gossip_axpy_flat([jnp.asarray(a) for a in arrs],
                                         weights, block_rows=8,
                                         interpret=True, out_dtype=jout),
                      np.float32)
    got = ref.gossip_axpy_ref([_to_torch(a) for a in arrs], weights,
                              out_dtype=torch.float32 if out_dtype else None)
    if dtype == "bf16" and out_dtype is None:
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        # one bf16 ulp at the value's binade: 2^(e - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
    else:
        assert got.dtype == torch.float32
        scale = sum(abs(w) * np.abs(np.asarray(a, np.float32))
                    for w, a in zip(weights, arrs))
        _assert_within_ulps(got.numpy(), want, scale, n)


def test_cpu_dispatch_runs_plain_and_launches_nothing():
    before = ops.launch_counts()
    x, g, m, psi = _t(_edm_inputs((2, 16, 128)))
    ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA)
    ops.gossip_axpy([x, g], [0.5, 0.5])
    assert ops.launch_counts() == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: a CPU tensor is an error."""
    x, g, m, psi = _t(_edm_inputs((8, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        edm_update_flat(x, g, m, psi, alpha=ALPHA, beta=BETA)
    with pytest.raises(ValueError, match="CUDA"):
        gossip_axpy_flat([x, g], [0.5, 0.5])


def test_padded_size_matches_reference():
    for n in (1, 127, 128 * 512, 128 * 512 + 1, 10**6):
        for br in (8, 512):
            assert ops.padded_size(n, br) == jops.padded_size(n, br)


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build._target(src, b"")
    src.write_text("// two\n")
    assert build._target(src, b"") != first
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert {p.stem for p in build.CSRC.glob("*.cu")} == {
        "edm_update", "edm_update_ef", "flash_attention", "gossip_axpy",
        "gossip_axpy_q8", "paged_attention", "paged_prefill",
        "ring_combine", "ring_peer", "table_combine", "table_peer"}
