"""The ring transport (kernel 8's counterpart) against the JAX package.

* ``ring_plan`` equals JAX's for ``ring(1…8)``, ``exp_graph(8)`` and
  ``hierarchical(2, 4)``; ``ring_dma_supported`` follows the port's one
  rule (a flat ±1 ring, every agent on one device, ``(A, rows, 128)`` f32
  payloads; on CPU tensors the plain version runs).
* The plain version, ``ring_combine_ref``, is bit-equal to the one-device
  ppermute engine's rolls plus ``gossip_axpy_ref`` at A ∈ {1, 2, 3, 4, 8},
  NaN and ±Inf included ("bit-equal" lets a NaN match any NaN).
* The port's ``transport="ring_dma"`` agrees with JAX's
  ``ring_combine_reference`` under ``shard_map`` on 4 host devices (run in
  a subprocess: XLA reads the device count once) and with JAX's one-device
  ``mix_ppermute(..., use_fused_kernel=True, interpret=True)``, within
  atol 1e-6 (f32 on both sides, the same three products and two sums; XLA
  may contract them into FMAs).
* A forced ``"ring_dma"`` raises on what it cannot carry; ``"auto"`` takes
  the ring whenever the payload is eligible and the combine fused; a
  2-step smoke train through the ring (the trainer's default) is
  bit-equal to one through the rolls.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as jmix
from repro.core import topology as jtopo
from repro.kernels import ring_dma as jring
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import make_codec, mixing as tmix
from repro_torch.core import topology as ttopo
from repro_torch.kernels import ops, ref, ring_dma
from repro_torch.models import build_model
from repro_torch.train import build_train_step, init_state

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-6


def _bus(A, rows=24, seed=0, edges=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((A, rows, 128)).astype(np.float32)
    if edges:   # NaN and ±Inf in every agent's block, at different places
        for a in range(A):
            x[a, a % rows, 3] = np.nan
            x[a, (a + 5) % rows, 7] = np.inf
            x[a, (a + 9) % rows, 11] = -np.inf
    return x


def _same_bits(a, b):
    """Equal shape and bits, a NaN matching any NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype
    ia, ib = a.view(torch.int32), b.view(torch.int32)
    return bool(((ia == ib) | (torch.isnan(a) & torch.isnan(b))).all())


def _terms(topo):
    return [(t.shift, float(t.weight)) for t in topo.terms]


@pytest.mark.parametrize("name,args", [("ring", (n,)) for n in range(1, 9)]
                         + [("exp_graph", (8,)), ("hierarchical", (2, 4))])
def test_ring_plan_matches_reference(name, args):
    want = jring.ring_plan(getattr(jtopo, name)(*args))
    got = ring_dma.ring_plan(getattr(ttopo, name)(*args))
    assert got == want
    assert (got is None) == (name != "ring")


def test_ring_dma_supported_follows_the_ports_rules():
    r4, bus = ttopo.ring(4), torch.zeros(4, 16, 128)
    ok = dict(agents_per_device=4)
    assert ring_dma.ring_dma_supported(r4, **ok)
    assert ring_dma.ring_dma_supported(r4, payload=bus, **ok)
    assert ring_dma.ring_dma_supported(r4, payload={"a": bus, "b": bus},
                                       **ok)
    assert ring_dma.ring_dma_supported(ttopo.ring(1), agents_per_device=1)
    # not a ±1 ring
    assert "±1 ring" in ring_dma.ring_unfit(ttopo.exp_graph(8),
                                            agents_per_device=8)
    assert not ring_dma.ring_dma_supported(ttopo.hierarchical(2, 2), **ok)
    # one agent per device is multi-GPU gossip
    assert "one device" in ring_dma.ring_unfit(r4, agents_per_device=1)
    # payloads: (A, rows, 128) f32 buses only, every leaf of a tree
    assert ring_dma.bus_payload(bus, 4)
    for bad in (bus.bfloat16(), torch.zeros(4, 16, 64),
                torch.zeros(3, 16, 128), torch.zeros(4, 128),
                (bus.to(torch.int8), torch.ones(4, 1))):
        assert not ring_dma.bus_payload(bad, 4)
        assert "f32 payloads" in ring_dma.ring_unfit(r4, payload=bad, **ok)
    assert not ring_dma.ring_dma_supported(
        r4, payload={"a": bus, "b": torch.zeros(4, 3, 5)}, **ok)


@pytest.mark.parametrize("A", [1, 2, 3, 4, 8])
def test_ring_combine_ref_bit_equal_to_rolls_and_axpy(A):
    topo = ttopo.ring(A)
    x = torch.from_numpy(_bus(A, rows=9, seed=A, edges=True))
    weights = [float(t.weight) for t in topo.terms]
    want = ref.gossip_axpy_ref(tmix.wire_terms(topo, x), weights)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    assert _same_bits(ref.ring_combine_ref(x, _terms(topo)), want)
    # the op on CPU tensors, out of place and into out=
    assert _same_bits(ops.ring_combine(x, _terms(topo)), want)
    out = torch.full_like(x, 7.0)
    got = ops.ring_combine(x, _terms(topo), out=out)
    assert got is out and _same_bits(out, want)
    # the kernel's operand codes name the rolls' sources
    assert ring_dma.ring_sources(_terms(topo), A) == [
        0 if A == 1 or t.shift % A == 0 else 1 if t.shift % A == 1 else 2
        for t in topo.terms]


_JAX_SHARD_MAP = """
import sys
import jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.core.topology import ring
from repro.kernels.ring_dma import ring_combine_reference, ring_plan
x = np.load(sys.argv[1])
A = x.shape[0]
mesh = Mesh(np.array(jax.devices()[:A]), ("data",))
plan = ring_plan(ring(A))
f = shard_map(lambda b: ring_combine_reference(b, plan, "data"), mesh,
              P("data"), P("data"))
np.save(sys.argv[2], np.asarray(jax.jit(f)(x)))
"""


def test_ring_transport_matches_reference_shard_map(tmp_path):
    x = _bus(4, rows=40, seed=7)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _JAX_SHARD_MAP,
                          str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    want = np.load(tmp_path / "y.npy")
    got = tmix.mix_ppermute(ttopo.ring(4), torch.from_numpy(x),
                            agents_per_device=4, use_fused_kernel=True,
                            transport="ring_dma")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("A", [3, 8])
def test_ring_transport_matches_one_device_reference(A):
    x = _bus(A, rows=16, seed=A)
    mesh = make_gossip_mesh(A, agents_per_device=A)
    want = jmix.mix_ppermute(jtopo.ring(A), mesh, gossip_agent_axes(mesh),
                             jnp.asarray(x), use_fused_kernel=True,
                             interpret=True)
    got = tmix.mix_ppermute(ttopo.ring(A), torch.from_numpy(x),
                            agents_per_device=A, use_fused_kernel=True,
                            transport="ring_dma")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_forced_ring_dma_raises_on_what_it_cannot_carry():
    kw = dict(agents_per_device=8, use_fused_kernel=True,
              transport="ring_dma")
    with pytest.raises(ValueError, match="±1 ring"):
        tmix.make_mixer(ttopo.exp_graph(8), "ppermute", **kw)
    with pytest.raises(ValueError, match="wire"):
        tmix.make_mixer(ttopo.ring(8), "ppermute",
                        wire=make_codec("int8", 8), **kw)
    with pytest.raises(ValueError, match="ppermute engine"):
        tmix.make_mixer(ttopo.ring(8), "shifts", **kw)
    with pytest.raises(ValueError, match="one device"):
        tmix.make_mixer(ttopo.ring(8), "ppermute", agents_per_device=4,
                        use_fused_kernel=True, transport="ring_dma")
    with pytest.raises(ValueError, match="unknown transport"):
        tmix.make_mixer(ttopo.ring(8), "ppermute", agents_per_device=8,
                        transport="nccl")
    mix = tmix.make_mixer(ttopo.ring(8), "ppermute", **kw)
    for bad in (torch.zeros(8, 16, 128, dtype=torch.bfloat16),
                torch.zeros(8, 16, 64), {"w": torch.zeros(8, 3, 5)}):
        with pytest.raises(ValueError, match="f32 payloads"):
            mix(bad)
    with pytest.raises(ValueError, match="f32 payloads"):
        tmix.mix_ppermute(ttopo.ring(8), torch.zeros(8, 16, 128),
                          agents_per_device=8, wire=make_codec("bf16", 8),
                          transport="ring_dma")
    # one agent per device is gossip across ranks: it needs a mesh
    with pytest.raises(ValueError, match="mesh="):
        tmix.mix_ppermute(ttopo.ring(4), torch.zeros(4, 8, 128),
                          agents_per_device=1, transport="ring_dma")
    # the op's own checks, the card's on every device: ±1 ring terms, an
    # out= that overlaps no byte of x (the combine reads neighbour blocks)
    x = torch.zeros(4, 8, 128)
    with pytest.raises(ValueError, match="shift 2"):
        ops.ring_combine(x, [(0, 0.5), (2, 0.5)])
    with pytest.raises(ValueError, match="overlaps"):
        ops.ring_combine(x, _terms(ttopo.ring(4)), out=x)
    with pytest.raises(ValueError, match="expected"):
        ops.ring_combine(x, _terms(ttopo.ring(4)), out=x[:2])


def _spy(monkeypatch):
    calls = []
    real = ops.ring_combine

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "ring_combine", spy)
    return calls


def test_auto_takes_the_ring_when_eligible_and_fused(monkeypatch):
    calls = _spy(monkeypatch)
    x = torch.from_numpy(_bus(4, rows=8))
    topo = ttopo.ring(4)
    want = tmix.mix_dense(topo, x)

    def mix(transport="auto", fused=True):
        out = tmix.mix_ppermute(topo, x, agents_per_device=4,
                                use_fused_kernel=fused, transport=transport)
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
        return len(calls)

    assert mix(fused=False) == 0            # the plain combine rolls
    assert mix(transport="ppermute") == 0
    assert mix() == 1                       # eligible and fused: the ring
    assert mix(transport="ring_dma", fused=False) == 2
    # ineligible payloads under auto roll quietly, as in JAX
    tmix.mix_ppermute(topo, x.bfloat16(), agents_per_device=4,
                      use_fused_kernel=True)
    tmix.mix_ppermute(ttopo.exp_graph(4), x, agents_per_device=4,
                      use_fused_kernel=True)
    tmix.mix_ppermute(topo, x.bfloat16(), agents_per_device=4,
                      use_fused_kernel=True, wire=make_codec("bf16", 8))
    assert len(calls) == 2


def _smoke_train(steps=2):
    model = build_model(get_smoke_config("smollm_360m"))
    run = RunConfig(global_batch=4, seq_len=16, algorithm="edm", alpha=0.2,
                    beta=0.9, gossip_engine="ppermute", agents_per_device=4,
                    remat=False)
    step = build_train_step(model, run, ttopo.ring(4),
                            use_fused_kernel=True, device="cpu")
    state = init_state(model, run, 4, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    history = []
    for _ in range(steps):
        tokens = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (4, 1, 16)))
        state, metrics = step(state, {"tokens": tokens})
        history.append({k: float(v) for k, v in metrics.items()})
    return state, history


def test_smoke_train_through_the_ring_is_bit_equal(monkeypatch):
    calls = _spy(monkeypatch)
    ringed, h_ringed = _smoke_train()
    assert len(calls) == 2                  # one ring combine a step
    # the same train with the ring refused: auto rolls
    monkeypatch.setattr(ring_dma, "ring_unfit", lambda *a, **k: "refused")
    rolled, h_rolled = _smoke_train()
    assert len(calls) == 2
    assert h_ringed == h_rolled
    assert torch.equal(ringed["params"], rolled["params"])
    for k in ("m", "psi"):
        assert torch.equal(ringed["opt"][k], rolled["opt"][k])
