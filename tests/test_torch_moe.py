"""The port's MoE family and the new architectures' configs against the JAX
package.

* Configs: the port's copies of ``deepseek_moe_16b``,
  ``qwen3_moe_235b_a22b``, ``qwen3_14b``, ``qwen1_5_110b`` and
  ``starcoder2_7b`` equal the reference's, full size and smoke; parameter
  paths, shapes and dtypes equal (the MoE router f32 inside a bf16 model).
* ``_route`` and ``apply_moe`` on numpy-seeded inputs, at the smoke
  config's dropless ``capacity_factor`` 8.0 and at 1.25, where the
  reference is asserted to drop assignments (the router is skewed so that
  it does); top-k ties (two equal router columns) go to the lower expert
  id on both sides.  f32, atol 1e-5: the same op sequence, reduction
  order aside.
* Loss and every gradient of the ``deepseek_moe_16b`` and
  ``qwen3_moe_235b_a22b`` smoke models at both capacities, rtol 1e-4 /
  atol 1e-5 (``test_torch_model.py``'s bound), with the norm weights set
  to seeded nonzero values on both sides.
* bf16 leaves (and the f32 router among them) carried across exactly,
  through the bus and back.

:func:`drop_counter` patches the reference's transformer so that every
``apply_moe`` it runs reports the assignments it drops; the other MoE test
files import it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtf
from repro.configs import get_config, get_smoke_config
from repro.core import bus as jbus
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models.layers import rms_norm as jrms_norm

from repro_torch import weights
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.core import bus as tbus
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)  # xdist workers share the cores

RTOL, ATOL = 1e-4, 1e-5
NEW_ARCHS = ["deepseek_moe_16b", "qwen3_moe_235b_a22b", "qwen3_14b",
             "qwen1_5_110b", "starcoder2_7b"]
MOE_ARCHS = ["deepseek_moe_16b", "qwen3_moe_235b_a22b"]
CAPACITIES = [8.0, 1.25]


def moe_cfg(arch, capacity_factor, dtype="float32"):
    """The (reference, port) smoke configs of ``arch`` at a capacity."""
    kw = dict(capacity_factor=capacity_factor, dtype=dtype)
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(tget_smoke_config(arch), **kw))


def reference_drops(p, cfg, x):
    """Assignments the reference's ``apply_moe`` drops on ``x``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(8, int(cfg.capacity_factor * B * S * k / E))
    h = jrms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    _, idx, _ = jmoe._route(h @ p["router"].astype(h.dtype), k)
    counts = jnp.bincount(idx.reshape(-1), length=E)
    return jnp.sum(jnp.maximum(counts - C, 0))


def drop_counter(monkeypatch):
    """A list that collects, per ``apply_moe`` call the reference's
    transformer makes (jitted, vmapped or not), the assignments dropped;
    read it after ``jax.effects_barrier()``."""
    seen = []
    orig = jtf.apply_moe

    def counted(p, cfg, x, eps):
        jax.debug.callback(lambda n: seen.append(int(np.sum(n))),
                           reference_drops(p, cfg, x))
        return orig(p, cfg, x, eps)

    monkeypatch.setattr(jtf, "apply_moe", counted)
    return seen


@pytest.fixture
def count_drops(monkeypatch):
    return drop_counter(monkeypatch)


def seeded_norms(tree, seed):
    """``tree`` with every zero-initialised leaf (norm weights, QKV
    biases) set to seeded values, so that the carried weights exercise
    them."""
    rng = np.random.default_rng(seed)

    def put(path, x):
        name = jax.tree_util.keystr(path)
        if any(f"'{n}'" in name for n in ("ln", "final_ln", "bq", "bk",
                                           "bv", "q_norm", "k_norm")):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(put, tree)


def carried(tree):
    return weights.params_from_tree(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_copies_match_reference(arch, full):
    get = get_config if full else get_smoke_config
    tget = tget_config if full else tget_smoke_config
    assert dataclasses.asdict(tget(arch)) == dataclasses.asdict(get(arch))
    assert tget(arch).n_params() == get(arch).n_params()
    assert tget_config(get_config(arch).name) == tget_config(arch)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_paths_shapes_dtypes_match_reference(arch, full):
    cfg = get_config(arch) if full else get_smoke_config(arch)
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    want = dict(zip(jbus.leaf_paths(shapes), jax.tree.leaves(shapes)))
    meta = tbuild_model(tget_config(arch) if full
                        else tget_smoke_config(arch)).meta()
    assert tbus.leaf_paths(meta) == list(want)
    for path, sds in want.items():
        assert tuple(meta[path].shape) == tuple(sds.shape), path
        assert str(meta[path].dtype).split(".")[1] == \
            jnp.dtype(sds.dtype).name, path
    if cfg.n_experts:
        assert meta["blocks|0|moe|router"].dtype == torch.float32
        if full:
            assert meta["blocks|0|moe|w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _moe_inputs(cfg, T, seed, skew=0.0, tie=False):
    """(p, x) of one MoE layer from numpy: a router skewed towards expert
    0 by ``skew`` (so capacity binds) and, with ``tie``, expert 2's router
    column equal to expert 1's (every token's logits tie there)."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    sff = cfg.n_shared_experts * ff
    std = lambda n: 1.0 / np.sqrt(n)                          # noqa: E731
    router = rng.standard_normal((d, E)) * std(d)
    router[:, 0] += skew
    if tie:
        router[:, 2] = router[:, 1]
    p = {"ln": 0.1 * rng.standard_normal((d,)),
         "router": router,
         "w_gate": rng.standard_normal((E, d, ff)) * std(d),
         "w_up": rng.standard_normal((E, d, ff)) * std(d),
         "w_down": rng.standard_normal((E, ff, d)) * std(ff)}
    if sff:
        p["shared"] = {"w_gate": rng.standard_normal((d, sff)) * std(d),
                       "w_up": rng.standard_normal((d, sff)) * std(d),
                       "w_down": rng.standard_normal((sff, d)) * std(sff)}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = (rng.standard_normal((2, T // 2, d)) + 0.5).astype(np.float32)
    return p, x


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("capacity_factor", CAPACITIES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_reference(arch, capacity_factor, tie):
    jcfg, tcfg = moe_cfg(arch, capacity_factor)
    skew = 0.05 if capacity_factor < 2 else 0.0
    p, x = _moe_inputs(jcfg, 48, seed=3, skew=skew, tie=tie)
    jp = jax.tree.map(jnp.asarray, p)
    drops = int(reference_drops(jp, jcfg, jnp.asarray(x)))
    if capacity_factor < 2:
        assert drops > 0
    else:
        assert drops == 0
    jy, jaux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x), jcfg.norm_eps)
    tp = weights.params_from_tree(p)
    tp = {"shared": {k.split("|")[1]: v for k, v in tp.items()
                     if k.startswith("shared|")},
          **{k: v for k, v in tp.items() if "|" not in k}}
    if not tp["shared"]:
        del tp["shared"]
    ty, taux = tmoe.apply_moe(tp, tcfg, torch.from_numpy(x), tcfg.norm_eps)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_route_ties_go_to_the_lower_expert():
    logits = np.array([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0],
                       [0.0, 1.0, 1.0, 1.0], [5.0, -1.0, 5.0, 5.0]],
                      np.float32)
    jw, jidx, jaux = jmoe._route(jnp.asarray(logits), 2)
    tw, tidx, taux = tmoe._route(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(),
                                  [[1, 2], [0, 1], [1, 2], [0, 2]])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_router_gradient_matches_reference():
    """``density`` carries no gradient, ``prob_density`` and the top-k
    weights do: d(Σ w·c + aux)/d logits agrees."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((24, 8)).astype(np.float32)
    c = rng.standard_normal((24, 3)).astype(np.float32)

    def jf(lg):
        w, _, aux = jmoe._route(lg, 3)
        return jnp.sum(w * c) + aux

    want = jax.grad(jf)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    w, _, aux = tmoe._route(lt, 3)
    (got,) = torch.autograd.grad((w * torch.from_numpy(c)).sum() + aux, lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", CAPACITIES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch, capacity_factor, count_drops):
    jcfg, tcfg = moe_cfg(arch, capacity_factor)
    jmodel = jbuild_model(jcfg)
    params = seeded_norms(jmodel.init(jax.random.PRNGKey(0)), seed=1)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)}))(params)
    jax.effects_barrier()
    assert (sum(count_drops) > 0) == (capacity_factor < 2)
    leaves = {k: v.clone().requires_grad_()
              for k, v in carried(params).items()}
    loss = tbuild_model(tcfg).loss(leaves, {"tokens":
                                            torch.from_numpy(tokens)})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    want = carried(jg)
    assert set(want) == set(grads)
    for path, g in want.items():
        np.testing.assert_allclose(grads[path].numpy(), g.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_leaves_carry_across_exactly(arch):
    """A bf16 MoE tree (its router f32) carried across keeps every bit, and
    survives the bus: pack → unpack gives the same leaves and dtypes."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = jbuild_model(cfg).init(jax.random.PRNGKey(3))
    flat = dict(zip(jbus.leaf_paths(params), jax.tree.leaves(params)))
    got = carried(params)
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        t = got[path]
        if "router" in path:
            assert t.dtype == torch.float32, path
        else:
            assert t.dtype == torch.bfloat16, path
        assert weights.tensor_to_array(t).tobytes() == arr.tobytes(), path
    tcfg = dataclasses.replace(tget_smoke_config(arch), dtype="bfloat16")
    meta = tbuild_model(tcfg).meta()
    layout = tbus.make_layout(
        {p: torch.empty((2,) + tuple(t.shape), dtype=t.dtype, device="meta")
         for p, t in meta.items()})
    bus = weights.params_to_bus(layout, got, 2)
    for a in range(2):
        back = tbus.unpack_agent(layout, bus, a)
        for path, t in got.items():
            assert back[path].dtype == t.dtype and torch.equal(back[path],
                                                               t), path
