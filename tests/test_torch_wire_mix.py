"""The port's wire-coded mixers against the JAX package's.

The one-device ppermute engine with a wire codec (bf16, int8; fused
through the decode-combine kernels' plain versions, or ``Σ w·decode(p)``)
against JAX's ppermute engine on a 1-device mesh, on the same encoded
payload, at rtol 1e-6 / atol 1e-7: the same rolls, weights and sums in the
same order (XLA may contract an FMA).  Against the port's dense engine on
``codec.quantize(x)`` at atol 1e-6: a matmul sums in another order.  The
schedule mixer's round dispatch is checked against ``make_mixer`` per
round, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import topology as jtopo
from repro.core import wire as jwire
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh

from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core import wire as twire

torch.set_num_threads(1)  # xdist workers share the cores

BR = 8

TOPOS = [("ring", (8,)), ("exp_graph", (8,)), ("hierarchical", (2, 4)),
         ("torus2d", (2, 4))]


def _payloads(fmt, seed=0):
    x = np.random.default_rng(seed).normal(size=(8, 3 * BR, 128)).astype(
        np.float32)
    jc, tc = jwire.make_codec(fmt, BR), twire.make_codec(fmt, BR)
    return x, jc, tc, jc.encode(jnp.asarray(x)), tc.encode(torch.from_numpy(x))


@pytest.mark.parametrize("name,args", TOPOS)
@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True])
def test_wire_ppermute_engine_matches_reference(name, args, fmt, fused):
    """JAX's ppermute engine on a 1-device mesh (all 8 agents on it) with
    the wire codec, and the port's local-roll engine, on the same encoded
    payload; fused through their decode-combine kernels (Pallas interpret /
    plain version), else ``Σ w·decode(p)``."""
    jt, tt = getattr(jtopo, name)(*args), getattr(ttopo, name)(*args)
    x, jc, tc, jpay, tpay = _payloads(fmt, seed=len(name))
    mesh = make_gossip_mesh(8, agents_per_device=8)
    want = np.asarray(jmix.mix_ppermute(jt, mesh, gossip_agent_axes(mesh),
                                        jpay, use_fused_kernel=fused,
                                        wire=jc))
    got = tmix.mix_ppermute(tt, tpay, agents_per_device=8,
                            use_fused_kernel=fused, wire=tc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the port's own oracle: the dense engine on Q(x), and on the payload
    q = tc.quantize(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), tmix.mix_dense(tt, q).numpy(),
                               rtol=0, atol=1e-6)
    for engine in ("dense", "shifts"):
        mixed = tmix.make_mixer(tt, engine, wire=tc)(tpay)
        np.testing.assert_allclose(mixed.numpy(), got.numpy(), rtol=0,
                                   atol=1e-6)


def test_f32_wire_is_the_uncompressed_engine():
    tt = ttopo.ring(4)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, BR, 128)).astype(np.float32))
    f32 = twire.make_codec("f32", BR)
    for fused in (False, True):
        assert torch.equal(
            tmix.mix_ppermute(tt, x, agents_per_device=4,
                              use_fused_kernel=fused, wire=f32),
            tmix.mix_ppermute(tt, x, agents_per_device=4,
                              use_fused_kernel=fused))


@pytest.mark.parametrize("fmt", ["f32", "int8"])
def test_schedule_mixer_dispatches_rounds(fmt):
    """build_mixer(sched, mode="schedule") applies round step % period;
    each round equals make_mixer on that round; mode="static" takes
    period-1 schedules only; the overlap mode's complete(issue(x)) is the
    schedule mixer's mix; a round that is not the port's Topology raises."""
    sched = tsched.RoundRobinExp(8)
    x, _, tc, _, tpay = _payloads(fmt, seed=4)
    mix = tmix.build_mixer(sched, mode="schedule", engine="ppermute",
                           agents_per_device=8, use_fused_kernel=True,
                           wire=tc)
    for step in range(2 * sched.period):
        want = tmix.make_mixer(sched.round(step), "ppermute",
                               agents_per_device=8, use_fused_kernel=True,
                               wire=tc)(tpay)
        assert torch.equal(mix(tpay, step=step), want)
    assert not torch.equal(mix(tpay, step=0), mix(tpay, step=1))
    static = tmix.build_mixer(tsched.StaticSchedule(ttopo.ring(8)),
                              mode="static", wire=tc)
    assert torch.equal(static(tpay), tmix.make_mixer(ttopo.ring(8),
                                                     wire=tc)(tpay))
    with pytest.raises(ValueError, match="period-1"):
        tmix.build_mixer(sched, mode="static")
    issue, complete = tmix.build_mixer(
        sched, mode="overlap", engine="ppermute", agents_per_device=8,
        use_fused_kernel=True, wire=tc)
    for step in range(sched.period):
        assert torch.equal(complete(issue(tpay, step), step),
                           mix(tpay, step=step))
    foreign = jtopo.ring(8)          # any round that is not the port's own
    with pytest.raises(TypeError, match="Topology"):
        tmix.build_mixer(foreign, mode="schedule")
