"""The port's dense LM against the JAX package's, on the smoke config.

Weights are made by the JAX package's ``init_lm`` and carried across with
``repro_torch.weights``; tokens come from the JAX ``SyntheticLM``.  Loss and
every leaf's gradient agree at rtol=1e-4, atol=1e-5: both sides run f32
with the same op sequence, and the tolerance covers matmul/softmax
reduction order between XLA and PyTorch on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.core import bus as jbus
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.train import checkpoint

from repro_torch import weights
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.core import bus as tbus
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as tlayers
from repro_torch.models.attention import sdpa_ref as t_sdpa_ref

torch.set_num_threads(1)  # xdist workers share the cores

RTOL, ATOL = 1e-4, 1e-5
ARCH = "smollm_360m"


def _jax_model_params():
    cfg = get_smoke_config(ARCH)
    model = jbuild_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _tokens(cfg, seq=16, batch=2):
    toks = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                        n_agents=1).sample(jax.random.PRNGKey(1), batch)
    return np.array(toks["tokens"])[0]            # (batch, seq) int32


def _port_loss_and_grads(params, tokens):
    model = tbuild_model(tget_smoke_config(ARCH))
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = model.loss(leaves, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("full", [False, True])
def test_config_copy_matches_reference(full):
    get = get_config if full else get_smoke_config
    tget = tget_config if full else tget_smoke_config
    assert dataclasses.asdict(tget(ARCH)) == dataclasses.asdict(get(ARCH))
    assert tget(ARCH).n_params() == get(ARCH).n_params()


@pytest.mark.parametrize("full", [False, True])
def test_param_paths_shapes_dtypes_match_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    shapes = jax.eval_shape(jbuild_model(cfg).init, jax.random.PRNGKey(0))
    want = dict(zip(jbus.leaf_paths(shapes), jax.tree.leaves(shapes)))
    meta = tbuild_model(tget_config(ARCH) if full
                        else tget_smoke_config(ARCH)).meta()
    assert tbus.leaf_paths(meta) == list(want)
    for path, sds in want.items():
        assert tuple(meta[path].shape) == tuple(sds.shape), path
        assert str(meta[path].dtype).split(".")[1] == jnp.dtype(sds.dtype).name


def test_port_init_statistics():
    """The port's own init: zeros for norms, truncated normal with std
    1/sqrt(fan_in) (bounded at 2 std) for matrices."""
    cfg = tget_smoke_config(ARCH)
    params = tbuild_model(cfg).init(torch.Generator().manual_seed(0))
    assert torch.count_nonzero(params["final_ln"]) == 0
    w = params["blocks|0|ffn|w_down"]                  # fan_in = d_ff
    std = 1.0 / np.sqrt(w.shape[1])
    truncated_std = 0.8796 * std                       # std of N(0,1)|[-2,2]
    assert abs(float(w.std()) - truncated_std) < 0.02 * std
    assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)


def test_loss_and_grads_match_reference():
    cfg, model, params = _jax_model_params()
    tokens = _tokens(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(tokens)},
                             remat=False))(params)
    tloss, tgrads = _port_loss_and_grads(
        weights.params_from_tree(jax.tree.map(np.asarray, params)), tokens)
    np.testing.assert_allclose(tloss, float(jloss), rtol=RTOL, atol=ATOL)
    jflat = weights.params_from_tree(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(tgrads)
    for path, jg in jflat.items():
        np.testing.assert_allclose(tgrads[path].numpy(), jg.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=path)


def test_npz_checkpoint_route(tmp_path):
    """``repro.train.checkpoint.save`` → npz → ``params_from_npz``: the
    same parameters (exact) and the same loss as the tree route."""
    cfg, model, params = _jax_model_params()
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, {"params": params, "step": np.int32(3)})
    from_npz = weights.params_from_npz(path)
    from_tree = weights.params_from_tree(jax.tree.map(np.asarray, params))
    assert set(from_npz) == set(from_tree)
    for k in from_tree:
        assert torch.equal(from_npz[k], from_tree[k]), k
    tokens = _tokens(cfg)
    jloss = model.loss(params, {"tokens": jnp.asarray(tokens)}, remat=False)
    tloss, _ = _port_loss_and_grads(from_npz, tokens)
    np.testing.assert_allclose(tloss, float(jloss), rtol=RTOL, atol=ATOL)


def test_bf16_leaves_carry_across_exactly(tmp_path):
    tree = {"a": jnp.linspace(-3, 3, 37, dtype=jnp.bfloat16),
            "b": (jnp.ones((2, 3), jnp.float32),)}
    host = jax.tree.map(np.asarray, tree)
    path = str(tmp_path / "bf16.npz")
    checkpoint.save(path, tree)
    for got in (weights.params_from_tree(host), weights.params_from_npz(path)):
        assert got["a"].dtype == torch.bfloat16
        assert got["b|0"].dtype == torch.float32
        np.testing.assert_array_equal(
            got["a"].float().numpy(), np.asarray(tree["a"], np.float32))


def test_layers_match_reference():
    """rms_norm (1 + w scaling), rope (split halves) and sdpa (GQA, causal
    and sliding window) on shared random inputs."""
    from repro.models import attention as jattn
    from repro.models import layers as jlayers
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 6, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8), (2, 8))
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                     1e4).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)
    k = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 8, 2, 16)).astype(np.float32)
    for window in (0, 3):
        got = t_sdpa_ref(torch.from_numpy(x), torch.from_numpy(k),
                         torch.from_numpy(v), causal=True, window=window)
        want = jattn.sdpa_ref(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
