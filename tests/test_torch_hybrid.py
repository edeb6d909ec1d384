"""The port's hybrid family (Jamba: Mamba, attention and MoE layers in one
block period, ``jamba_1_5_large_398b``) against the JAX package, at the
smoke config: 8 layers (one period: ``(ssm, dense)`` and ``(ssm, moe)``
alternating, attention at layer 4), d_model 256, 4 heads of 64, 4
experts top-2 of width 512, dense FFN 512, state 16, vocab 512.

Weights come from the reference's ``init_lm`` with the zero-initialised
leaves (norm weights, ``conv_b``) set to seeded values
(``test_torch_mamba.seeded``), carried across by ``repro_torch.weights``;
token inputs are numpy draws.  The reference's functions run under
``jax.jit``, one compile each, shared by the tests through module
fixtures.

Tolerances (those of ``test_torch_mamba.py`` / ``test_torch_moe.py`` for
the same quantities): f32 loss and gradients, the MoE aux loss included,
rtol 1e-4 / atol 1e-5, and the logits and caches of the prefill and
of three decode steps at the same bound (``test_torch_model.py``'s; the
SSM file holds its 2-layer model's at the block bound, rtol 1e-5 / atol
2e-6, which eight layers' reduction orders exceed by up to 7e-6); greedy
tokens equal.  bf16 (the test's docstring says why): against the f32
function of the same weights, the loss within rtol 2e-3 (the SSM file's
bf16 loss bound) or the reference's own bf16 distance, each gradient leaf
within 2 × the reference's bf16 distance + 2⁻⁷, normwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro.serve.engine import grow_caches as j_grow_caches

from repro_torch.configs import (block_period, get_config, get_smoke_config,
                                 layer_kinds)
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate, grow_caches

from test_torch_mamba import _flat, carried, seeded

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "jamba_1_5_large_398b"
RTOL, ATOL = 1e-4, 1e-5          # loss, gradients, logits, caches
BF16_LOSS_RTOL, BF16_GRAD_RATIO = 2e-3, 2.0
# the smallest depth that holds every layer kind of the period (the card
# serves Jamba-1.5-Large at this depth) and its parameters, counted on the
# tree: the reference's analytic ``n_params`` leaves out each Mamba
# layer's ``conv_b`` and ``dt_bias`` (2 · d_inner a layer)
SERVE_LAYERS, SERVE_PARAMS = 5, 24045707264
FULL_PARAMS = 398555111424


def models(dtype="float32"):
    """(JAX model, JAX params, port model, port params) at the smoke
    config in ``dtype``."""
    jcfg = dataclasses.replace(jget_smoke_config(ARCH), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    jparams = seeded(jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(dataclasses.replace(get_smoke_config(ARCH),
                                            dtype=dtype))
    return jmodel, jparams, model, carried(jparams)


@pytest.fixture(scope="module")
def f32():
    return models()


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, B=2, S=16, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# config and parameter tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_config_and_tree_match_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jcfg = jget_config(ARCH) if full else jget_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_config("jamba-1.5-large-398b") == get_config(ARCH)
    assert block_period(cfg) == 8
    assert layer_kinds(cfg)[:8] == [("ssm", "dense"), ("ssm", "moe")] * 2 \
        + [("attn", "dense"), ("ssm", "moe"), ("ssm", "dense"),
           ("ssm", "moe")]
    tree = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in _flat(tree).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in build_model(cfg).meta().items()}
    assert got == want
    if full:
        assert sum(int(np.prod(s)) for s, _ in got.values()) \
            == FULL_PARAMS
        assert got["blocks|1|moe|router"] == ((9, 8192, 16), "float32")
        assert got["blocks|1|moe|w_gate"] == ((9, 16, 8192, 24576),
                                              "bfloat16")
        assert got["blocks|4|attn|wk"] == ((9, 8192, 1024), "bfloat16")
        assert got["blocks|0|ssm|A_log"][1] == "float32"


def test_serving_depth_holds_every_kind():
    """At 5 layers the period is the whole stack and holds (ssm, dense),
    (ssm, moe) and (attn, dense): the card's serving cut."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=SERVE_LAYERS)
    kinds = layer_kinds(cfg)
    assert block_period(cfg) == SERVE_LAYERS
    assert set(kinds) == {("ssm", "dense"), ("ssm", "moe"), ("attn", "dense")}
    assert sum(t.numel() for t in build_model(cfg).meta().values()) \
        == SERVE_PARAMS == cfg.n_params() + 2 * cfg.d_inner * 4


def test_encdec_still_raises():
    """Formerly the pin that ``whisper_small`` was unported: the last
    family of the reference's list now resolves, to the reference's
    config field for field (``tests/test_torch_encdec.py`` holds the
    model)."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS
    cfg = get_config("whisper_small")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jget_config("whisper_small"))
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    with pytest.raises(NotImplementedError, match="unknown architecture"):
        get_config("whisper_large")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(model, params, tokens):
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in params.items()}
    loss = model.loss(leaves, {"tokens": _t(tokens)}, remat=False)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    return loss.detach(), grads


def _jloss_and_grads(jmodel, jparams, tokens):
    return jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)},
                              remat=False)))(jparams)


def test_lm_loss_and_grads_match_reference(f32):
    jmodel, jparams, model, tparams = f32
    tokens = _tokens(model.cfg)
    jloss, jgrads = _jloss_and_grads(jmodel, jparams, tokens)
    loss, grads = _loss_and_grads(model, tparams, tokens)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    want = carried(jgrads)
    assert set(grads) == set(want)
    for p in want:
        _close(grads[p], want[p].numpy(), msg=p)
    # every kind's leaves get a gradient
    for p in ("blocks|0|ssm|in_proj", "blocks|1|moe|w_up",
              "blocks|1|moe|router", "blocks|4|attn|wq",
              "blocks|4|ffn|w_down"):
        assert float(grads[p].abs().max()) > 0, p


def test_moe_aux_loss_is_in_the_loss(f32, monkeypatch):
    """The loss carries the MoE layers' ``router_aux_coef · aux``: with the
    coefficient at 0 it drops by the reference's aux term."""
    jmodel, jparams, model, tparams = f32
    tokens = _tokens(model.cfg)
    with_aux = float(model.loss(tparams, {"tokens": _t(tokens)},
                                remat=False))
    cfg0 = dataclasses.replace(model.cfg, router_aux_coef=0.0)
    without = float(build_model(cfg0).loss(tparams, {"tokens": _t(tokens)},
                                           remat=False))
    jcfg0 = dataclasses.replace(jmodel.cfg, router_aux_coef=0.0)
    jwith = float(jax.jit(lambda p: jmodel.loss(
        p, {"tokens": jnp.asarray(tokens)}, remat=False))(jparams))
    jwithout = float(jax.jit(lambda p: jbuild_model(jcfg0).loss(
        p, {"tokens": jnp.asarray(tokens)}, remat=False))(jparams))
    assert with_aux > without
    np.testing.assert_allclose(with_aux - without, jwith - jwithout,
                               rtol=RTOL, atol=ATOL)


def test_bf16_loss_and_grads_match_reference():
    """bf16 against the reference's bf16 and both against the f32 function
    of the same (bf16-valued) weights, computed by the reference.  In bf16
    the two packages round in different places, and the MoE router's bf16
    logits then route a few tokens differently (1 and 3 of the 32 in the
    last two MoE layers at this seed): a discrete change that moves those
    layers' gradients by 10–47 % in both packages alike.  So the port's
    bf16 run is held to be as close to the f32 function as the
    reference's own: loss within ``BF16_LOSS_RTOL`` of the f32 loss or no
    further from it than the reference's bf16 loss, and each gradient leaf
    (in the reference's dtype) no further from the f32 gradient, normwise,
    than ``BF16_GRAD_RATIO`` × the reference's distance + 2⁻⁷."""
    jmodel, jparams, model, tparams = models("bfloat16")
    tokens = _tokens(model.cfg)
    jmodel32 = jbuild_model(dataclasses.replace(jmodel.cfg, dtype="float32"))
    loss32, grads32 = _jloss_and_grads(
        jmodel32, jax.tree.map(lambda x: x.astype(jnp.float32), jparams),
        tokens)
    jloss, jgrads = _jloss_and_grads(jmodel, jparams, tokens)
    loss, grads = _loss_and_grads(model, tparams, tokens)
    assert loss.dtype == torch.float32
    f32 = float(loss32)
    assert abs(float(loss) - f32) <= max(BF16_LOSS_RTOL * abs(f32),
                                         abs(float(jloss) - f32))
    want, exact = carried(jgrads), carried(grads32)
    assert set(grads) == set(want)
    for p in want:
        assert grads[p].dtype == want[p].dtype, p
        ref = exact[p].double()
        ours = float((grads[p].double() - ref).norm() / ref.norm())
        theirs = float((want[p].double() - ref).norm() / ref.norm())
        assert ours <= BF16_GRAD_RATIO * theirs + 2.0 ** -7, (p, ours,
                                                              theirs)


# ---------------------------------------------------------------------------
# serving: prefill caches, decode steps, greedy_generate, grow_caches
# ---------------------------------------------------------------------------

def test_prefill_caches_and_decode_steps_match_reference(f32):
    """The prefill's caches are a mixed tuple — ``{h, conv}`` at the SSM
    positions of the period, ``{k, v}`` at the attention position — equal
    to the reference's; then three decode steps (caches grown by
    ``grow_caches``, written in place) against ``lm_decode_step``."""
    jmodel, jparams, model, tparams = f32
    S = 12
    tokens = _tokens(model.cfg, S=S)
    jlogits, jcaches = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(tparams, {"tokens": _t(tokens)})
    _close(logits, jlogits, msg="prefill logits")
    assert [set(c) for c in caches] == [{"h", "conv"}] * 4 + [{"k", "v"}] \
        + [{"h", "conv"}] * 3
    assert caches[4]["k"].shape == (1, 2, S, 4, 64)
    assert caches[0]["h"].shape == (1, 2, 512, 16)
    for pi, (c, jc) in enumerate(zip(caches, jcaches)):
        for k in c:
            _close(c[k], jc[k], msg=f"{pi} {k}")
    n = 3
    caches = grow_caches(model, caches, 2, S + n)
    jcaches = j_grow_caches(jmodel, jcaches, 2, S + n)
    jstep = jax.jit(jmodel.decode_step)
    tok = np.argmax(np.asarray(jlogits[:, -1]), -1)[:, None].astype(np.int32)
    for i in range(n):
        jl, jcaches = jstep(jparams, jcaches, jnp.asarray(tok),
                            jnp.asarray(S + i, jnp.int32))
        tl, out = model.decode_step(tparams, caches, _t(tok), S + i)
        assert out is caches                 # written in place
        _close(tl, jl, msg=f"decode {i}")
        for pi, (c, jc) in enumerate(zip(caches, jcaches)):
            for k in c:
                _close(c[k], jc[k], msg=f"decode {i}: {pi} {k}")
        tok = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)


def test_greedy_generate_matches_reference(f32):
    jmodel, jparams, model, tparams = f32
    tokens = _tokens(model.cfg, B=3, S=10, seed=7)
    want = j_greedy_generate(jmodel, jparams,
                             {"tokens": jnp.asarray(tokens)}, n_steps=6)
    got = greedy_generate(model, tparams, {"tokens": _t(tokens)}, n_steps=6)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_grow_caches_grows_only_the_kv_leaves(f32):
    """On the mixed tuple only the attention position's ``k`` / ``v``
    grow (zeros after the prefill's rows); the SSM state passes through
    as the same tensors; the result has the shapes ``init_cache`` would
    allocate."""
    _, _, model, tparams = f32
    tokens = _tokens(model.cfg, B=3, S=10, seed=7)
    _, caches = model.prefill(tparams, {"tokens": _t(tokens)})
    grown = grow_caches(model, caches, 3, 10 + 6)
    target = model.init_cache(3, 16, device="meta")
    for pi, (c, g, t) in enumerate(zip(caches, grown, target)):
        assert {k: tuple(v.shape) for k, v in g.items()} \
            == {k: tuple(v.shape) for k, v in t.items()}, pi
        for k in c:
            if k in ("h", "conv"):
                assert g[k] is c[k], (pi, k)
            else:
                assert g[k].shape[2] == 16 and c[k].shape[2] == 10
                assert torch.equal(g[k][:, :, :10], c[k])
                assert not g[k][:, :, 10:].any()
    with pytest.raises(ValueError, match="does not grow"):
        grow_caches(model, grown, 3, 12)


def test_paged_entries_and_continuous_batching_raise(f32, capsys):
    """A hybrid model serves the fixed batch only: the paged entries and
    the continuous engine raise (attention mixers only, as the
    reference's), and the serve CLI's fixed batch prints ``generated``."""
    from repro_torch.launch import serve
    _, _, model, tparams = f32
    for entry, args in ((model.decode_step_paged, 4),
                        (model.prefill_chunk_paged, 4),
                        (model.decode_step_mixed, 9)):
        with pytest.raises(NotImplementedError,
                           match="attention mixers only"):
            entry(tparams, (), torch.zeros(1, 1), *([None] * args))
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                    "--continuous-batching"])
    capsys.readouterr()
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    assert "generated 3 tokens/request" in capsys.readouterr().out


def test_serve_cli_cuts_the_depth(capsys):
    """``--n-layers`` serves the config at full width and the given depth
    (the card serves Jamba-1.5-Large at 5 layers): at the smoke config's
    width, 5 layers hold one period of every kind."""
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                      "--n-layers", "5", "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
    assert "generated 3 tokens/request" in capsys.readouterr().out
