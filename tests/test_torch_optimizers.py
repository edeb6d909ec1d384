"""Every algorithm of ``ALGORITHMS`` on trees: the port against the JAX
package, and the paper's claims on the port alone.

* Mixers on trees: the dense, shifts and one-device ppermute engines
  take a ``{path: tensor}`` dict leaf by leaf and equal the JAX engines on
  the same tree (f32 at rtol 1e-6; bf16 exact for the ppermute combine,
  whose plain sum rounds per operation on both sides, and within one bf16
  ulp for dense, which accumulates in f32).
* Trajectories: 20 steps of each algorithm from one numpy-made x(0) and
  20 numpy-made gradient trees, through ``repro.core.make_optimizer`` and
  the port's, with the dense, shifts and one-device ppermute engines (the
  plain combine); f32 leaves at rtol 1e-5 / atol 1e-6 (the same
  operations in the same order; XLA may contract a multiply-add).  The
  fused tree EDM (``use_fused_kernel=True``: per-leaf pack, the kernel's
  plain version, unpack) equals the unfused chain bit for bit in f32 and
  the JAX fused path (Pallas in interpret mode) at the same tolerance.
* The paper's claims, mirroring ``tests/test_core.py``, on the port alone:
  every algorithm converges on homogeneous data; EDM removes the
  heterogeneity bias DmSGD keeps; β = 0 is ED; the mean iterate is
  momentum SGD; the primal recursion (3.4).
* ``warmup_cosine`` equals ``repro.optim.warmup_cosine`` on steps 0…N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ALGORITHMS as JALGORITHMS
from repro.core import make_mixer as jmake_mixer
from repro.core import make_optimizer as jmake_optimizer
from repro.core import ring as jring
from repro.core import topology as jtopo
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.optim import warmup_cosine as jwarmup_cosine

from repro_torch.core import (ALGORITHMS, consensus_distance, make_mixer,
                              make_optimizer, mix_shifts, ring, topology,
                              tree_sqnorm)
from repro_torch.kernels import ops
from repro_torch.optim import scale_grads, warmup_cosine

torch.set_num_threads(1)  # xdist workers share the cores

A, STEPS = 4, 20
SHAPES = {"a": (5,), "b": (2, 3), "c": (7, 1, 3)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal((A,) + s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v)).to(dtype)
            for k, v in tree.items()}


def _np(tree):
    return {k: np.asarray(jnp.asarray(v).astype(jnp.float32))
            if not isinstance(v, torch.Tensor) else v.float().numpy()
            for k, v in tree.items()}


def _mixers(engine, topo_name="ring"):
    jt = jring(A) if topo_name == "ring" else jtopo.exp_graph(A)
    tt = ring(A) if topo_name == "ring" else topology.exp_graph(A)
    if engine == "ppermute":
        mesh = make_gossip_mesh(A, agents_per_device=A)
        jmix = jmake_mixer(jt, "ppermute", mesh=mesh,
                           agent_axes=gossip_agent_axes(mesh))
        tmix = make_mixer(tt, "ppermute", agents_per_device=A)
    else:
        jmix, tmix = jmake_mixer(jt, engine), make_mixer(tt, engine)
    return jmix, tmix


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["dense", "shifts", "ppermute"])
def test_mixers_on_trees_match_reference(engine, dtype):
    x = _tree(np.random.default_rng(0))
    jmix, tmix = _mixers(engine, "exp")
    want = _np(jmix(_to_jax(x, getattr(jnp, dtype))))
    got = tmix(_to_torch(x, getattr(torch, dtype)))
    assert set(got) == set(x)
    for k in x:
        assert got[k].dtype == getattr(torch, dtype)
        g = got[k].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, want[k], rtol=1e-6, atol=1e-6)
        elif engine == "dense":
            np.testing.assert_allclose(g, want[k], rtol=2 ** -8, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, want[k])


def _trajectory_inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(STEPS)]
    return x0, grads


def _run_jax(alg, jmix, x0, grads, **kw):
    opt = jmake_optimizer(alg, alpha=0.1, beta=0.8, mix=jmix, **kw)
    x = _to_jax(x0)
    state = opt.init(x)
    step = jax.jit(opt.step)
    for g in grads:
        x, state = step(x, _to_jax(g), state)
    return _np(x), {k: _np(v) for k, v in state.items()}


def _run_port(alg, tmix, x0, grads, **kw):
    opt = make_optimizer(alg, alpha=0.1, beta=0.8, mix=tmix, **kw)
    x = _to_torch(x0)
    state = opt.init(x)
    for g in grads:
        x, state = opt.step(x, _to_torch(g), state)
    return _np(x), {k: _np(v) for k, v in state.items()}


def _assert_close(got, want, rtol=1e-5, atol=1e-6):
    gx, gs = got
    wx, ws = want
    assert set(gs) == set(ws)
    for k in wx:
        np.testing.assert_allclose(gx[k], wx[k], rtol=rtol, atol=atol,
                                   err_msg=f"x[{k}]")
    for slot in ws:
        for k in ws[slot]:
            np.testing.assert_allclose(gs[slot][k], ws[slot][k], rtol=rtol,
                                       atol=atol, err_msg=f"{slot}[{k}]")


def test_registry_matches_reference():
    assert sorted(ALGORITHMS) == sorted(JALGORITHMS)


@pytest.mark.parametrize("engine", ["dense", "shifts", "ppermute"])
@pytest.mark.parametrize("alg", sorted(JALGORITHMS))
def test_trajectory_matches_reference(alg, engine):
    x0, grads = _trajectory_inputs(1)
    jmix, tmix = _mixers(engine)
    _assert_close(_run_port(alg, tmix, x0, grads),
                  _run_jax(alg, jmix, x0, grads))


def test_fused_tree_edm_matches_plain_and_reference():
    x0, grads = _trajectory_inputs(2)
    jmix, tmix = _mixers("ppermute")
    before = ops.launch_counts()
    fused = _run_port("edm", tmix, x0, grads, use_fused_kernel=True)
    assert ops.launch_counts() == before      # CPU tensors: plain version
    plain = _run_port("edm", tmix, x0, grads)
    for k in x0:
        np.testing.assert_array_equal(fused[0][k], plain[0][k])
        for slot in ("m", "psi"):
            np.testing.assert_array_equal(fused[1][slot][k],
                                          plain[1][slot][k])
    _assert_close(fused, _run_jax("edm", jmix, x0, grads,
                                  use_fused_kernel=True))


def test_fused_tree_update_keeps_leaf_dtypes_and_order():
    rng = np.random.default_rng(3)
    x, g, m, psi = (_to_torch(_tree(rng), torch.bfloat16) for _ in range(4))
    m2, phi, psi2 = ops.edm_update_tree(x, g, m, psi, alpha=0.1, beta=0.8)
    for k in x:
        want = ops.edm_update(x[k], g[k], m[k], psi[k], alpha=0.1, beta=0.8)
        for got, w in zip((m2[k], psi2[k], phi[k]), want):
            assert got.dtype == torch.bfloat16 and got.shape == x[k].shape
            assert torch.equal(got, w)
    # one tensor is a one-leaf tree
    m3, phi3, _ = ops.edm_update_tree(x["b"], g["b"], m["b"], psi["b"],
                                      alpha=0.1, beta=0.8)
    assert torch.equal(m3, m2["b"]) and torch.equal(phi3, phi["b"])


def test_keyword_rules_match_reference():
    """``repro/core/optimizers.py``'s rules: dsgd, dsgt and ed take no β;
    the baselines swallow extra keywords; edm takes ``use_fused_kernel``
    and nothing else."""
    mix = lambda t: t  # noqa: E731
    for name in ("dsgd", "dsgt", "ed"):
        assert make_optimizer(name, alpha=0.1, mix=mix, beta=0.5).name == name
    for name in ("dmsgd", "dsgt_hb", "decentlam", "qg", "edm_ef", "dsgd"):
        make_optimizer(name, alpha=0.1, mix=mix, use_fused_kernel=True)
    with pytest.raises(TypeError):
        make_optimizer("edm", alpha=0.1, mix=mix, bogus=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_optimizer("adam", alpha=0.1, mix=mix)


# ---------------------------------------------------------------------------
# the paper's claims, on the port alone (tests/test_core.py)
# ---------------------------------------------------------------------------

def _quadratic(n=16, d=6, zeta=0.0, seed=0):
    """f_i(x) = ½‖A_i x − b_i‖²; heterogeneity via per-agent optima."""
    rng = np.random.default_rng(seed)
    Am = rng.normal(size=(n, 2 * d, d)).astype(np.float32)
    x_star = rng.normal(size=(d,)).astype(np.float32)
    offsets = rng.normal(size=(n, d)).astype(np.float32)
    x_i = x_star[None] + zeta * offsets
    b = np.einsum("npd,nd->np", Am, x_i).astype(np.float32)
    AtA = np.einsum("npd,npe->de", Am, Am)
    Atb = np.einsum("npd,np->d", Am, b)
    x_opt = torch.from_numpy(np.linalg.solve(AtA, Atb))
    At, bt = torch.from_numpy(Am), torch.from_numpy(b)

    def grad(x):
        r = torch.einsum("npd,nd->np", At, x) - bt
        return torch.einsum("npd,np->nd", At, r) / At.shape[1]

    return grad, x_opt


def _run(alg, grad, x0, topo, alpha, beta, steps):
    opt = make_optimizer(alg, alpha=alpha, beta=beta, mix=make_mixer(topo))
    x, state = x0, opt.init(x0)
    for _ in range(steps):
        x, state = opt.step(x, grad(x), state)
    return x


@pytest.mark.parametrize("alg", sorted(ALGORITHMS))
def test_all_algorithms_converge_homogeneous(alg):
    grad, x_opt = _quadratic(n=16, zeta=0.0)
    x = _run(alg, grad, torch.zeros(16, x_opt.shape[0]), ring(16),
             alpha=0.05, beta=0.8, steps=2000)
    err = float((x - x_opt[None]).abs().max())
    # edm_ef's floor is the bf16 payload granularity, not 0
    assert err < (6e-2 if alg == "edm_ef" else 1e-2), (alg, err)


def test_edm_eliminates_heterogeneity_bias():
    grad, x_opt = _quadratic(n=16, zeta=5.0)
    x0 = torch.zeros(16, x_opt.shape[0])
    errs = {}
    for alg in ("edm", "dmsgd"):
        x = _run(alg, grad, x0, ring(16), alpha=0.05, beta=0.9, steps=4000)
        errs[alg] = float(((x - x_opt[None]) ** 2).sum(-1).mean())
    assert errs["edm"] < 1e-6, errs
    assert errs["dmsgd"] > 50 * max(errs["edm"], 1e-12), errs


def test_edm_beta0_equals_ed():
    grad, x_opt = _quadratic(n=8, zeta=1.0)
    x0 = torch.ones(8, x_opt.shape[0])
    x_a = _run("edm", grad, x0, ring(8), alpha=0.03, beta=0.0, steps=50)
    x_b = _run("ed", grad, x0, ring(8), alpha=0.03, beta=0.0, steps=50)
    assert torch.equal(x_a, x_b)


def test_edm_mean_iterate_is_momentum_sgd():
    grad, x_opt = _quadratic(n=8, zeta=2.0)
    d = x_opt.shape[0]
    alpha, beta = 0.04, 0.9
    opt = make_optimizer("edm", alpha=alpha, beta=beta,
                         mix=make_mixer(ring(8)))
    x = torch.zeros(8, d)
    state = opt.init(x)
    m_bar, x_bar = torch.zeros(d), torch.zeros(d)
    for _ in range(30):
        g = grad(x)
        m_bar = beta * m_bar + (1 - beta) * g.mean(0)
        x_bar = x_bar - alpha * m_bar
        x, state = opt.step(x, g, state)
        np.testing.assert_allclose(x.mean(0).numpy(), x_bar.numpy(),
                                   rtol=5e-4, atol=1e-5)


def test_edm_primal_recursion():
    """X(t+2) = W(2X(t+1) − X(t) − αM(t+1) + αM(t)), the paper's (3.4)."""
    grad, x_opt = _quadratic(n=8, zeta=1.0)
    topo = ring(8)
    alpha, beta = 0.05, 0.85
    opt = make_optimizer("edm", alpha=alpha, beta=beta, mix=make_mixer(topo))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, x_opt.shape[0]), dtype=np.float32))
    state = opt.init(x)
    xs, ms = [x], []
    for _ in range(6):
        g = grad(x)
        ms.append(beta * state["m"] + (1 - beta) * g)
        x, state = opt.step(x, g, state)
        xs.append(x)
    for t in range(4):
        rhs = mix_shifts(topo, 2 * xs[t + 1] - xs[t] - alpha * ms[t + 1]
                         + alpha * ms[t])
        np.testing.assert_allclose(xs[t + 2].numpy(), rhs.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_tree_metrics():
    x = torch.stack([torch.ones(3), -torch.ones(3)])
    assert float(consensus_distance(x)) == pytest.approx(6.0)
    assert float(consensus_distance({"a": x, "b": x})) == pytest.approx(12.0)
    assert float(tree_sqnorm({"a": torch.full((4,), 2.0)})) == \
        pytest.approx(16.0)


# ---------------------------------------------------------------------------
# the LR schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 40), (1, 10**9), (10, 10)])
def test_warmup_cosine_matches_reference(warmup, total):
    want = jwarmup_cosine(warmup, total)
    got = warmup_cosine(warmup, total)
    steps = list(range(0, 61))
    w = np.asarray([float(want(jnp.asarray(s))) for s in steps], np.float32)
    g = np.asarray([float(got(s)) for s in steps], np.float32)
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    assert float(got(torch.tensor(7))) == float(got(7))


def test_scale_grads_rounds_to_leaf_dtype():
    sched = warmup_cosine(4, 100)
    g = {"a": torch.full((2, 3), 3.0, dtype=torch.bfloat16),
         "b": torch.full((2,), 3.0)}
    out = scale_grads(g, 1, sched)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == \
        torch.float32
    assert float(out["b"][0]) == pytest.approx(3.0 * 0.5)
