"""The port's packed bus against the JAX package's (ungrouped layouts):
identical slots, rows and block_rows; byte-equal packing; an exact unpack
round trip; and pad rows that stay zero through an EDM step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.core import bus as jbus
from repro.models import build_model as jbuild_model

from repro_torch import weights
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.core import bus as tbus
from repro_torch.core import make_edm_bus, make_mixer, ring
from repro_torch.models import build_model
from repro_torch.train import bus_layout_for

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "smollm_360m"
A = 3


def _jax_lifted(cfg, n_agents=A):
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: jax.ShapeDtypeStruct((n_agents,) + s.shape, s.dtype),
        shapes)


@pytest.mark.parametrize("full", [False, True])
def test_layout_matches_reference(full):
    jcfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    tcfg = tget_config(ARCH) if full else tget_smoke_config(ARCH)
    jl = jbus.make_layout(_jax_lifted(jcfg))
    tl = bus_layout_for(build_model(tcfg), A)
    assert tl.rows == jl.rows and tl.block_rows == jl.block_rows
    assert list(tl.paths) == jbus.leaf_paths(_jax_lifted(jcfg))
    assert len(tl.slots) == len(jl.slots)
    for ts, js in zip(tl.slots, jl.slots):
        assert (ts.row, ts.rows, ts.shape, ts.size) == \
            (js.row, js.rows, js.shape, js.size)
        assert str(ts.dtype).split(".")[1] == jnp.dtype(js.dtype).name
    assert tl.logical_elems == jl.logical_elems


@pytest.mark.parametrize("block_rows", [8, 64])
def test_pack_is_byte_equal_and_unpack_round_trips(block_rows):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32)),
        _jax_lifted(cfg))
    jl = jbus.make_layout(tree, block_rows=block_rows)
    jpacked = np.asarray(jbus.pack_tree(jl, tree))

    flat = weights.params_from_tree(jax.tree.map(np.asarray, tree))
    tl = tbus.make_layout(flat, block_rows=block_rows)
    tpacked = tbus.pack_tree(tl, flat)
    assert tpacked.shape == jpacked.shape
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)

    back = tbus.unpack_tree(tl, tpacked)
    for k, v in flat.items():
        assert torch.equal(back[k], v), k
    for a in range(A):
        one = tbus.unpack_agent(tl, tpacked, a)
        for k, v in flat.items():
            assert torch.equal(one[k], v[a]), k


def test_bf16_leaves_round_trip_through_f32_bus():
    tree = {"w": torch.randn(2, 5, 7).to(torch.bfloat16),
            "b": torch.randn(2, 3)}
    layout = tbus.make_layout(tree, block_rows=8)
    bus = tbus.pack_tree(layout, tree)
    assert bus.dtype == torch.float32
    back = tbus.unpack_tree(layout, bus)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"],
                                                             tree["w"])
    assert torch.equal(back["b"], tree["b"])


def _pad_mask(layout):
    mask = torch.ones(layout.padded_elems, dtype=torch.bool)
    for slot in layout.slots:
        mask[slot.row * 128: slot.row * 128 + slot.size] = False
    return mask.view(layout.rows, 128)


@pytest.mark.parametrize("fused", [False, True])
def test_pad_rows_stay_zero_through_an_edm_step(fused):
    model = build_model(tget_smoke_config(ARCH))
    layout = bus_layout_for(model, A)
    pads = _pad_mask(layout)
    assert pads.any()
    gen = torch.Generator().manual_seed(0)

    def random_bus():
        bus = torch.randn(A, layout.rows, 128, generator=gen)
        return bus.masked_fill(pads, 0.0)

    opt = make_edm_bus(0.2, 0.9, make_mixer(ring(A), "ppermute",
                                            agents_per_device=A,
                                            use_fused_kernel=fused),
                       use_fused_kernel=fused)
    x = random_bus()
    state = opt.init(x)
    for _ in range(3):
        x, state = opt.step(x, random_bus(), state)
    for buf in (x, state["m"], state["psi"]):
        assert torch.count_nonzero(buf[:, pads]) == 0
