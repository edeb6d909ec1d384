"""The port's topologies and mixing engines against the JAX package's.

* ``dense_matrix()`` is equal (exactly) for every constructor at several n.
* ``mix_dense``, ``mix_shifts`` and the one-device ``ppermute`` engine
  (``agents_per_device = A``, plain and fused combine) equal JAX's on ring,
  exp, torus and hierarchical topologies.  f32: rtol=1e-6, atol=1e-7 (the
  same rolls and weighted sums in the same order).  bf16: rtol=atol=2⁻⁶,
  a few bf16 ulps at |x| ≤ 4 — XLA rounds each weight to bf16 before the
  product (1/3 and 1/6 are inexact there), PyTorch multiplies by the f32
  weight, and each partial sum then rounds to bf16 on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import topology as jtopo
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh

from repro_torch.core import mixing as tmix
from repro_torch.core import topology as ttopo

torch.set_num_threads(1)  # xdist workers share the cores


def _constructors():
    cases = []
    for n in (1, 2, 3, 4, 5, 8, 9, 16):
        cases += [("ring", (n,)), ("exp_graph", (n,)),
                  ("fully_connected", (n,)), ("disconnected", (n,))]
    for p, d in ((1, 4), (2, 2), (2, 4), (3, 3), (4, 2)):
        cases.append(("torus2d", (p, d)))
    for pods, per in ((1, 4), (2, 1), (2, 4), (4, 2), (3, 3)):
        cases.append(("hierarchical", (pods, per)))
    return cases


@pytest.mark.parametrize("name,args", _constructors())
def test_dense_matrix_equal_for_every_constructor(name, args):
    jt = getattr(jtopo, name)(*args)
    tt = getattr(ttopo, name)(*args)
    np.testing.assert_array_equal(tt.dense_matrix(), jt.dense_matrix())
    assert tt.terms == tuple(ttopo.ShiftTerm(t.level, t.shift, t.weight)
                             for t in jt.terms)
    assert tt.grid == jt.grid and tt.name == jt.name
    for t in tt.terms:
        np.testing.assert_array_equal(tt.term_sources(t),
                                      jt.term_sources(t))
    if name != "disconnected" or tt.n_agents == 1:
        tt.check_assumption1()
    np.testing.assert_allclose(tt.lam(), jt.lam(), atol=1e-12)


def test_hierarchical_intra_ring_and_lazify():
    for args in ((2, 4), (3, 3)):
        jt = jtopo.hierarchical(*args, intra="ring").lazify()
        tt = ttopo.hierarchical(*args, intra="ring").lazify()
        np.testing.assert_array_equal(tt.dense_matrix(), jt.dense_matrix())
        assert tt.name == jt.name


TOPOS = [("ring", (8,)), ("exp_graph", (8,)), ("torus2d", (2, 4)),
         ("hierarchical", (2, 4))]


def _x(dtype, A=8, seed=0):
    x = np.random.default_rng(seed).normal(size=(A, 6, 128)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name))
    return jx, tx


def _check(got: torch.Tensor, want, dtype):
    assert str(got.dtype).split(".")[1] == jnp.dtype(dtype).name
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == jnp.float32 \
        else dict(rtol=2 ** -6, atol=2 ** -6)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("name,args", TOPOS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dense_and_shifts_engines_match_reference(name, args, dtype):
    jt, tt = getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)
    jx, tx = _x(dtype)
    _check(tmix.mix_dense(tt, tx), jmix.mix_dense(jt, jx), dtype)
    _check(tmix.mix_shifts(tt, tx), jmix.mix_shifts(jt, jx), dtype)


@pytest.mark.parametrize("name,args", TOPOS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
def test_one_device_ppermute_engine_matches_reference(name, args, dtype,
                                                      fused):
    """JAX's blocked ppermute engine on a 1-device mesh (all 8 agents on
    it) against the port's local-roll engine; with ``fused`` both combine
    through their gossip_axpy kernel (Pallas interpret / plain version)."""
    jt, tt = getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)
    jx, tx = _x(dtype, seed=1)
    mesh = make_gossip_mesh(8, agents_per_device=8)
    want = jmix.mix_ppermute(jt, mesh, gossip_agent_axes(mesh), jx,
                             use_fused_kernel=fused)
    got = tmix.mix_ppermute(tt, tx, agents_per_device=8,
                            use_fused_kernel=fused)
    _check(got, want, dtype)
    # the port's ppermute and dense engines agree (f32 oracle)
    if dtype == jnp.float32:
        _check(got, tmix.mix_dense(tt, tx), dtype)


def test_ppermute_over_several_devices_is_not_ported():
    # agents spread over devices run one rank a device: without a mesh the
    # one-process engine points at mesh= (tests/test_torch_dist_*.py run it)
    with pytest.raises(ValueError, match="mesh="):
        tmix.mix_ppermute(ttopo.ring(4), torch.zeros(4, 8, 128),
                          agents_per_device=1)


def test_build_mixer_static_and_schedule_modes():
    tt = ttopo.ring(4)
    _, tx = _x(jnp.float32, A=4)
    want = tmix.mix_shifts(tt, tx)
    assert torch.equal(tmix.build_mixer(tt, mode="static")(tx), want)
    assert torch.equal(tmix.build_mixer(tt, mode="schedule")(tx, step=5),
                       want)
    # the overlap mode's (issue, complete) pair mixes as the schedule does
    issue, complete = tmix.build_mixer(tt, mode="overlap")
    assert torch.equal(complete(issue(tx, 5), 5), want)
    assert complete.n_terms == len(tt.terms)
