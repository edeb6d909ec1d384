"""The port's SSM family (Mamba-1, ``falcon_mamba_7b``) against the JAX
package, at the smoke config (2 layers, d_model 256, d_inner 512, state
16, conv 4, dt_rank 8, vocab 512).

Weights come from the reference's ``init_lm`` / ``init_mamba``, with the
zero-initialised leaves (norm weights, ``conv_b``) set to seeded values,
carried across by ``repro_torch.weights``; inputs are numpy draws.  The
reference's functions run under ``jax.jit`` (one compile each, where
op-by-op dispatch of the associative scan takes seconds).

Tolerances.  In f32 the port runs the reference's op sequence in its
order (the scan's within-chunk prefix is ``jax.lax.associative_scan``'s
recursion), so what differs is XLA's fused multiply-adds and reduction
order: the scans within 1e-6 of the reference's chunked scan, the block
and the logits at rtol 1e-5 / atol 2e-6, loss and gradients at rtol 1e-4
/ atol 1e-5 (``test_torch_model.py``'s bound).  The chunked scan is held
to the sequential oracle at the reference's own bound, rtol 2e-4 / atol
2e-5 (``tests/test_properties.py``).  In bf16 XLA keeps f32 inside its
fusions where PyTorch rounds every op, so the block is held at atol
0.05 + 2⁻⁶·|want| (a few bf16 ulps of the activations).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.models import mamba as jmamba
from repro.serve.engine import greedy_generate as j_greedy_generate

from repro_torch import weights
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import mamba as tmamba
from repro_torch.serve import greedy_generate, grow_caches

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "falcon_mamba_7b"
RTOL, ATOL = 1e-4, 1e-5          # loss and gradients
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 2e-6
ZERO_INIT = ("ln", "final_ln", "conv_b")


def seeded(tree, seed=3):
    """``tree`` with its zero-initialised leaves set to seeded values."""
    rng = np.random.default_rng(seed)

    def put(path, x):
        name = jax.tree_util.keystr(path)
        if any(f"'{n}'" in name for n in ZERO_INIT):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(put, tree)


def carried(tree):
    return weights.params_from_tree(jax.tree.map(np.asarray, tree))


def models(dtype="float32"):
    """(JAX model, JAX params, port model, port params) at the smoke
    config in ``dtype``."""
    jcfg = dataclasses.replace(jget_smoke_config(ARCH), dtype=dtype)
    jmodel = jbuild_model(jcfg)
    jparams = seeded(jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(dataclasses.replace(get_smoke_config(ARCH),
                                            dtype=dtype))
    return jmodel, jparams, model, carried(jparams)


def block(dtype="float32"):
    """(cfg, JAX block params, port block params) of one Mamba layer."""
    cfg = dataclasses.replace(jget_smoke_config(ARCH), dtype=dtype)
    jp = seeded(jmamba.init_mamba(jax.random.PRNGKey(1), cfg))
    return cfg, jp, carried(jp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _bf16_close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert np.all(err <= 0.05 + 2.0 ** -6 * np.abs(want)), err.max()


# ---------------------------------------------------------------------------
# config, parameter tree, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_config_and_tree_match_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jcfg = jget_config(ARCH) if full else jget_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_config("falcon-mamba-7b") == get_config(ARCH)
    tree = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in _flat(tree).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in build_model(cfg).meta().items()}
    assert got == want
    if full:
        assert sum(int(np.prod(s)) for s, _ in got.values()) == 7272665088
        for leaf in ("dt_proj", "dt_bias", "A_log", "D"):
            assert got[f"blocks|0|ssm|{leaf}"][1] == "float32"
        assert got["blocks|0|ssm|in_proj"] == ((64, 4096, 16384),
                                               "bfloat16")


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def test_init_mamba_constants_match_reference():
    """S4D-real A_log, dt_bias −4.6 and D 1 in f32 inside a bf16 model,
    zero norm and conv bias, and the random leaves' std, as the
    reference's ``init_mamba``."""
    cfg = get_config(ARCH)
    jp = jax.eval_shape(lambda: jmamba.init_mamba(jax.random.PRNGKey(0),
                                                  jget_smoke_config(ARCH)))
    small = get_smoke_config(ARCH)
    got = tmamba.init_mamba(small, torch.Generator().manual_seed(0))
    want = jmamba.init_mamba(jax.random.PRNGKey(0), jget_smoke_config(ARCH))
    assert set(got) == set(jp)
    for name in ("dt_bias", "D", "ln", "conv_b"):
        assert torch.equal(got[name], _t(want[name])), name
    # log(1..16) correctly rounded; XLA's f32 log is one ulp off at log 7
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(
        want["A_log"]), rtol=1.2e-7, atol=0)
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        fan_in = got[name].shape[0]
        assert abs(float(got[name].std()) * fan_in ** 0.5 - 0.88) < 0.1
    big = dict(tmamba.ssm_specs(cfg, 1))
    for name in ("dt_proj", "dt_bias", "A_log", "D"):
        assert big[name][1] == torch.float32
    assert big["in_proj"][1] == torch.bfloat16


# ---------------------------------------------------------------------------
# conv, scans, block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 512)).astype(np.float32)
    w = rng.standard_normal((4, 512)).astype(np.float32)
    b = rng.standard_normal((512,)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 512)).astype(np.float32)
          if with_state else None)
    jout, jst = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
    out, new = tmamba._causal_conv(_t(x), _t(w), _t(b),
                                   None if st is None else _t(st))
    _close(out, jout, rtol=0, atol=1e-6)
    assert torch.equal(new, _t(jst))


@pytest.mark.parametrize("S,chunk", [(16, 4), (12, 8), (7, 256), (32, 8)])
def test_scans_match_both_references(S, chunk):
    """The port's chunked scan against the reference's (1e-6) and the
    sequential oracle (rtol 2e-4 / atol 2e-5); the port's oracle against
    the reference's.  (12, 8) and (7, 256) take the one-chunk fallback."""
    rng = np.random.default_rng(S)
    B, di, s = 2, 6, 4
    a = rng.uniform(0.3, 0.99, (B, S, di, s)).astype(np.float32)
    b = rng.standard_normal((B, S, di, s)).astype(np.float32)
    h0 = rng.standard_normal((B, di, s)).astype(np.float32)
    ja, jb, jh0 = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    jhs, jhT = jax.jit(jmamba._chunked_scan, static_argnums=3)(
        ja, jb, jh0, chunk)
    rhs, rhT = jax.jit(jmamba.ssm_scan_ref)(ja, jb, jh0)
    hs, hT = tmamba._chunked_scan(_t(a), _t(b), _t(h0), chunk)
    shs, shT = tmamba.ssm_scan_ref(_t(a), _t(b), _t(h0))
    for got, want in ((hs, jhs), (hT, jhT), (shs, rhs), (shT, rhT)):
        _close(got, want, rtol=0, atol=1e-6)
    for got in (hs, hT):
        _close(got, rhs if got is hs else rhT, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_train_and_decode_match_reference(dtype):
    cfg, jp, tp = block(dtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = _t(x).to(getattr(torch, dtype))
    japply = functools.partial(jmamba.apply_mamba, cfg=cfg, chunk=8)
    jy, _ = jax.jit(japply)(jp, x=jx)
    y, none = tmamba.apply_mamba(tp, cfg, tx, chunk=8)
    assert none is None and y.dtype == tx.dtype
    # decode one step from a seeded state
    jcache = {"h": jnp.asarray(rng.standard_normal(
        (2, cfg.d_inner, cfg.ssm_state)), jnp.float32),
        "conv": jnp.asarray(rng.standard_normal(
            (2, cfg.ssm_conv - 1, cfg.d_inner)), jnp.float32)}
    cache = {k: _t(v) for k, v in jcache.items()}
    jyd, jnew = jax.jit(functools.partial(japply, mode="decode"))(
        jp, x=jx[:, :1], cache=jcache)
    yd, new = tmamba.apply_mamba(tp, cfg, tx[:, :1], mode="decode",
                                 cache=cache)
    if dtype == "float32":
        _close(y, jy, msg="train")
        _close(yd, jyd, msg="decode")
        for k in ("h", "conv"):
            _close(new[k], jnew[k], msg=k)
    else:
        _bf16_close(y, jy)
        _bf16_close(yd, jyd)
        assert torch.equal(new["conv"], _t(jnew["conv"]))


def test_train_mode_equals_step_by_step_decode():
    """Running the block token by token in decode mode from a zero state
    reproduces the train-mode (chunked-scan) outputs and final state, as
    ``tests/test_properties.py`` holds the reference to."""
    cfg, _, tp = block()
    S = 12
    x = _t(np.random.default_rng(4).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    zero = tmamba.init_ssm_cache(cfg, 2)
    y, last = tmamba.apply_mamba(tp, cfg, x, cache=zero, chunk=4)
    cache, ys = tmamba.init_ssm_cache(cfg, 2), []
    for t in range(S):
        yt, cache = tmamba.apply_mamba(tp, cfg, x[:, t:t + 1],
                                       mode="decode", cache=cache)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cache["h"].numpy(), last["h"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(cache["conv"], last["conv"])


# ---------------------------------------------------------------------------
# the model: loss and grads, serving
# ---------------------------------------------------------------------------

def _tokens(cfg, B=2, S=16, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_lm_loss_and_grads_match_reference():
    jmodel, jparams, model, tparams = models()
    tokens = _tokens(model.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)},
                              remat=False)))(jparams)
    leaves = {p: v.requires_grad_() for p, v in tparams.items()}
    loss = model.loss(leaves, {"tokens": _t(tokens)}, remat=False)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL)
    want = carried(jgrads)
    assert set(grads) == set(want)
    for p in want:
        _close(grads[p], want[p].numpy(), rtol=RTOL, atol=ATOL, msg=p)


def test_bf16_loss_matches_reference():
    jmodel, jparams, model, tparams = models("bfloat16")
    tokens = _tokens(model.cfg)
    jloss = jax.jit(lambda p: jmodel.loss(
        p, {"tokens": jnp.asarray(tokens)}, remat=False))(jparams)
    loss = model.loss(tparams, {"tokens": _t(tokens)}, remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)


def test_prefill_and_decode_caches_match_reference():
    jmodel, jparams, model, tparams = models()
    tokens = _tokens(model.cfg, S=12)
    jlogits, jcaches = jmodel.prefill(jparams,
                                      {"tokens": jnp.asarray(tokens)})
    logits, caches = model.prefill(tparams, {"tokens": _t(tokens)})
    _close(logits, jlogits, msg="prefill logits")
    assert len(caches) == 1 and set(caches[0]) == {"h", "conv"}
    assert caches[0]["h"].shape == (2, 2, 512, 16)
    assert caches[0]["conv"].dtype == torch.float32
    for k in ("h", "conv"):
        _close(caches[0][k], jcaches[0][k], msg=k)
    nxt = np.argmax(np.asarray(jlogits[:, -1]), -1)[:, None].astype(np.int32)
    jl2, jc2 = jmodel.decode_step(jparams, jcaches, jnp.asarray(nxt),
                                  jnp.asarray(12, jnp.int32))
    l2, c2 = model.decode_step(tparams, caches, _t(nxt), 12)
    _close(l2, jl2, msg="decode logits")
    assert c2 is caches                      # written in place
    for k in ("h", "conv"):
        _close(caches[0][k], jc2[0][k], msg=k)
    meta = model.init_cache(2, 99, device="meta")
    assert [(k, tuple(v.shape), v.device.type) for k, v in meta[0].items()] \
        == [("h", (2, 2, 512, 16), "meta"), ("conv", (2, 2, 3, 512), "meta")]


def test_greedy_generate_matches_reference_and_caches_pass_through():
    jmodel, jparams, model, tparams = models()
    tokens = _tokens(model.cfg, B=3, S=10, seed=7)
    want = j_greedy_generate(jmodel, jparams,
                             {"tokens": jnp.asarray(tokens)}, n_steps=6)
    got = greedy_generate(model, tparams, {"tokens": _t(tokens)}, n_steps=6)
    assert np.array_equal(got.numpy(), np.asarray(want))
    _, caches = model.prefill(tparams, {"tokens": _t(tokens)})
    grown = grow_caches(model, caches, 3, 10 + 6)
    assert all(grown[0][k] is caches[0][k] for k in ("h", "conv"))


def test_bf16_params_carry_across_bit_exact():
    """The reference's bf16 falcon-mamba parameters (the state leaves f32)
    reach the port by path with their bits, and go back the same."""
    jcfg = dataclasses.replace(jget_smoke_config(ARCH), dtype="bfloat16")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(2))
    got = carried(jparams)
    for path, leaf in _flat(jparams).items():
        arr = np.asarray(leaf)
        t = got[path]
        assert t.dtype == (torch.bfloat16 if arr.dtype.itemsize == 2
                           else torch.float32), path
        back = weights.tensor_to_array(t)
        assert back.tobytes() == arr.tobytes(), path


def test_paged_entries_and_continuous_batching_raise():
    from repro_torch.launch import serve
    _, _, model, tparams = models()
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        model.decode_step_paged(tparams, (), torch.zeros(1, 1), None, None,
                                None, None)
    with pytest.raises(NotImplementedError, match="attention mixers only"):
        serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                    "--continuous-batching"])
    out = serve.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "3"])
    assert tuple(out["tokens"].shape) == (2, 3)
