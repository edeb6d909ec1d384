"""The dense-family variants of the port against the JAX package, on the
smoke configs in f32: QK norm (``qwen3_14b``), QKV bias
(``qwen1_5_110b``), QKV bias with the ungated tanh-GELU MLP
(``starcoder2_7b``).

Biases and norm weights are zero at init, so both sides get the same
seeded nonzero values before anything is compared.

* Loss and every gradient agree at rtol 1e-4, atol 1e-5
  (``test_torch_model.py``'s bound: the same op sequence, reduction order
  aside).
* The QK-norm config's paged decode, chunked-prefill and mixed logits
  agree at atol 1e-4, rtol 1e-3, argmax exact (``test_torch_serve.py``'s
  bound), through the checks of ``test_torch_moe_serve.py``.
* The ungated MLP uses GELU's tanh approximation, as ``jax.nn.gelu``
  does by default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers

from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import layers as tlayers

from test_torch_moe import carried, seeded_norms
from test_torch_moe_serve import (check_decode_paged, check_mixed,
                                  check_prefill_paged, models)

torch.set_num_threads(1)  # xdist workers share the cores

RTOL, ATOL = 1e-4, 1e-5
VARIANTS = ["qwen3_14b", "qwen1_5_110b", "starcoder2_7b"]


@pytest.mark.parametrize("arch", VARIANTS)
def test_loss_and_grads_match_reference(arch):
    cfg = get_smoke_config(arch)
    jmodel = jbuild_model(cfg)
    params = seeded_norms(jmodel.init(jax.random.PRNGKey(0)), seed=2)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)}))(params)
    leaves = {k: v.clone().requires_grad_()
              for k, v in carried(params).items()}
    for name in ("bq", "q_norm"):
        path = f"blocks|0|attn|{name}"
        if path in leaves:
            assert float(leaves[path].detach().abs().min()) > 0, path
    loss = tbuild_model(tget_smoke_config(arch)).loss(
        leaves, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    want = carried(jg)
    assert set(want) == set(grads)
    for path, g in want.items():
        np.testing.assert_allclose(grads[path].numpy(), g.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_gelu_mlp_is_the_tanh_approximation():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3
    w_up = rng.standard_normal((16, 32)).astype(np.float32) * 0.3
    w_down = rng.standard_normal((32, 16)).astype(np.float32) * 0.3
    want = jlayers.gelu_mlp(jnp.asarray(x), jnp.asarray(w_up),
                            jnp.asarray(w_down))
    got = tlayers.gelu_mlp(*(torch.from_numpy(a) for a in (x, w_up, w_down)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("check", [check_decode_paged, check_prefill_paged,
                                   check_mixed],
                         ids=["decode", "prefill", "mixed"])
def test_qk_norm_paged_logits_match_jax(check):
    check(*models("qwen3_14b"))
