"""The port's encoder-decoder family (``whisper_small``: a bidirectional
encoder over frame embeddings, a causal decoder with cross attention)
against the JAX package, at the smoke config (2 encoder + 2 decoder
layers, d_model 256, 4 heads of 64, d_ff 512, vocab 512, 16 frames, f32).

Weights come from the reference's ``init_encdec`` with the norm weights
set to seeded values, carried across by ``repro_torch.weights`` (from the
tree and from the reference's ``checkpoint.save`` npz); tokens and frames
are numpy draws.

* Config and parameter tree equal to the reference's, full size and
  smoke; the full tree counts 277,893,120 parameters (``n_params``,
  analytic, leaves out the decoder's cross attention).
* Loss and every gradient (the frames' too) at rtol 1e-5 / atol 1e-6; the
  sinusoid, the cross-attention sub-block, the prefill's logits and its
  ``{k, v, xk, xv}`` caches at rtol 1e-5 / atol 2e-6 (f32 on both sides:
  XLA's and PyTorch's reduction orders).
* The prefill of S − 1 tokens plus one decode step equals the full
  prefill within rtol 1e-3 / atol 1e-4 (the reference's own test allows
  2e-2) and the reference's decode step; ``greedy_generate``'s tokens
  equal the reference's exactly, with and without a decode window, and a
  token-by-token ``decode_step`` replay whose cross caches come from the
  prefill; ``grow_caches`` grows ``k`` / ``v`` only and pads frames other
  than ``n_frontend_tokens`` as the reference does.
* ``remat`` / ``remat_policy`` are taken and ignored, as the reference's
  ``encdec_loss`` ignores ``remat``; there is no paged path.
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
from repro.models import attention as jattention
from repro.models import encdec as jencdec
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro.serve.engine import grow_caches as j_grow_caches
from repro.train import checkpoint as jcheckpoint

from repro_torch import weights
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as tattention
from repro_torch.models import build_model
from repro_torch.models import encdec as tencdec
from repro_torch.serve import (ContinuousBatchingEngine, PagedCacheConfig,
                               greedy_generate, grow_caches)

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "whisper_small"
RTOL, ATOL = 1e-5, 1e-6            # loss and gradients
FWD_RTOL, FWD_ATOL = 1e-5, 2e-6    # forward values
FULL_PARAMS = 277893120            # counted on the tree
NORMS = ("ln", "enc_ln", "dec_ln")


def seeded(tree, seed=3):
    """``tree`` with its zero-initialised norm weights set to seeded
    values (so a norm weight's gradient and its place in the tree
    matter)."""
    rng = np.random.default_rng(seed)

    def put(path, x):
        if getattr(path[-1], "key", None) in NORMS:
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(put, tree)


def carried(tree):
    return weights.params_from_tree(jax.tree.map(np.asarray, tree))


def _flat(tree):
    return {"|".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def models(decode_window=0):
    """(JAX model, JAX params, port model, port params) of the smoke
    config, norms seeded."""
    jmodel = jbuild_model(jget_smoke_config(ARCH), decode_window=decode_window)
    jparams = seeded(jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(get_smoke_config(ARCH), decode_window=decode_window)
    return jmodel, jparams, model, carried(jparams)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, B=2, S=12, seed=5, frames=None):
    """numpy tokens (B, S) and frames (B, T, d)."""
    rng = np.random.default_rng(seed)
    T = frames or cfg.n_frontend_tokens
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frontend": rng.standard_normal((B, T, cfg.d_model)).astype(
                np.float32)}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: _t(v) for k, v in b.items()}


def _close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# config, tree, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_config_and_tree_match_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jcfg = jget_config(ARCH) if full else jget_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_config("whisper-small") == get_config(ARCH)
    assert cfg.family == "encdec" and cfg.pos_emb == "sinusoidal"
    assert (cfg.n_enc_layers, cfg.n_frontend_tokens) == (
        (12, 1500) if full else (2, 16))
    tree = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in _flat(tree).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in build_model(cfg).meta().items()}
    assert got == want
    if full:
        n = sum(int(np.prod(s)) for s, _ in got.values())
        assert n == FULL_PARAMS
        # the analytic count leaves out the decoder's cross attention
        # (12 × 2,360,064) and the final norms, and counts each decoder
        # self-attention's norm twice
        assert cfg.n_params() == jcfg.n_params() == 249589248


def test_init_follows_the_specs():
    """Truncated-normal fan-in init: every matrix's std is 1/√fan_in
    (``dec_embed`` over its d axis, ``lm_head`` over its rows), norms are
    zero, values within ±2σ; one generator seed gives one set of
    weights, drawn on the generator's device."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    again = model.init(torch.Generator().manual_seed(0))
    specs = tencdec.encdec_param_specs(cfg)
    assert set(p) == set(specs)
    for path, (shape, dt, fan_in) in specs.items():
        leaf = p[path]
        assert tuple(leaf.shape) == shape and leaf.dtype == dt, path
        assert torch.equal(leaf, again[path]), path
        if fan_in is None:
            assert not leaf.any(), path
            continue
        std = 1.0 / np.sqrt(fan_in)
        assert float(leaf.abs().max()) <= 2 * std + 1e-7, path
        # a normal truncated at ±2σ has std 0.8796·σ
        np.testing.assert_allclose(float(leaf.std()), 0.8796 * std,
                                   rtol=0.1, err_msg=path)
    assert specs["dec_embed"][2] == specs["lm_head"][2] == cfg.d_model
    assert specs["dec_blocks|ffn|w_down"][2] == cfg.d_ff


def test_sinusoid_matches_reference():
    d = get_config(ARCH).d_model
    pos = np.arange(1500)[None]
    got = tencdec._sinusoid(torch.from_numpy(pos), d)
    want = jencdec._sinusoid(jnp.asarray(pos), d)
    assert got.dtype == torch.float32 and got.shape == (1, 1500, d)
    # sin / cos of angles up to 1500 rad: the two exps' frequencies may
    # differ by an ulp, so the angles by an ulp (2⁻¹³ at 1024–2048 rad)
    _close(got, want, rtol=0, atol=2.0 ** -12)
    # below 64 rad an ulp of the angle is at most 2⁻¹⁸
    _close(got[:, :64], np.asarray(want)[:, :64], rtol=0, atol=2.0 ** -17,
           msg="small angles")


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(model, params, b):
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in params.items()}
    front = _t(b["frontend"]).requires_grad_()
    loss = model.loss(leaves, {"tokens": _t(b["tokens"]),
                               "frontend": front}, remat=False)
    grads = torch.autograd.grad(loss, list(leaves.values()) + [front])
    return loss.detach(), dict(zip(list(leaves) + ["frontend"], grads))


@functools.lru_cache(maxsize=None)
def _reference_grads():
    jmodel, jparams, model, _ = models()
    b = _batch(model.cfg)
    jloss, (jgrads, jfront) = jax.jit(jax.value_and_grad(
        lambda p, fe: jmodel.loss(p, {"tokens": jnp.asarray(b["tokens"]),
                                      "frontend": fe}),
        argnums=(0, 1)))(jparams, jnp.asarray(b["frontend"]))
    want = {p: v.numpy() for p, v in carried(jgrads).items()}
    want["frontend"] = np.asarray(jfront)
    return float(jloss), want


def test_loss_and_grads_match_reference():
    _, _, model, tparams = models()
    b = _batch(model.cfg)
    loss, grads = _loss_and_grads(model, tparams, b)
    jloss, want = _reference_grads()
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    assert set(grads) == set(want)
    for p, g in grads.items():
        _close(g, want[p], rtol=RTOL, atol=ATOL, msg=p)
        assert float(g.abs().max()) > 0, p
    # the frames change the loss
    other = dict(b, frontend=_batch(model.cfg, seed=9)["frontend"])
    assert abs(float(model.loss(tparams, _torch(other))) - float(loss)) > 1e-4


def test_weights_from_a_reference_checkpoint(tmp_path):
    """A reference ``checkpoint.save`` npz of the parameter tree carries
    the same bits as the tree, so the same loss and gradients."""
    _, jparams, model, tparams = models()
    path = str(tmp_path / "whisper.npz")
    jcheckpoint.save(path, jparams)
    from_npz = weights.params_from_npz(path)
    assert set(from_npz) == set(tparams)
    for p in tparams:
        assert torch.equal(from_npz[p], tparams[p]), p
    b = _batch(model.cfg)
    loss, grads = _loss_and_grads(model, from_npz, b)
    jloss, want = _reference_grads()
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    for p, g in grads.items():
        _close(g, want[p], rtol=RTOL, atol=ATOL, msg=p)


def test_remat_is_taken_and_ignored():
    """The trainer passes ``remat`` / ``remat_policy`` to every model; the
    encoder-decoder loss takes them and ignores them, as the reference's
    ``encdec_loss`` ignores ``remat``: the same loss and gradients."""
    _, _, model, tparams = models()
    b = _torch(_batch(model.cfg))

    def run(**kw):
        leaves = {p: v.detach().clone().requires_grad_()
                  for p, v in tparams.items()}
        loss = model.loss(leaves, b, **kw)
        return [loss] + list(torch.autograd.grad(loss, list(leaves.values())))

    want = run(remat=False)
    for kw in (dict(), dict(remat=True, remat_policy="dots"),
               dict(remat=True, remat_policy="full")):
        got = run(**kw)
        assert all(torch.equal(a, c) for a, c in zip(got, want)), kw


# ---------------------------------------------------------------------------
# cross attention, prefill, decode, greedy_generate
# ---------------------------------------------------------------------------

def test_cross_attention_matches_reference():
    """``apply_attn(mode="cross")``: pre-norm, ``q = h @ wq``, unmasked
    attention over the encoder's (k, v) (GQA: 2 KV heads under 4), ``wo``
    and the residual; the cache passes through."""
    cfg = dataclasses.replace(jget_smoke_config(ARCH), n_kv_heads=2)
    jp = seeded(jattention.init_attn(jax.random.PRNGKey(4), cfg))
    tp = carried(jp)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, 7, 2, cfg.hd)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(5)[None], (2, 5))
    want, _ = jattention.apply_attn(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                    mode="cross", xattn_kv=(jnp.asarray(k),
                                                            jnp.asarray(v)))
    cache = {"k": torch.zeros(1)}
    got, c = tattention.apply_attn(tp, cfg, _t(x), _t(pos), mode="cross",
                                   cache=cache, xattn_kv=(_t(k), _t(v)))
    _close(got, want)
    assert c is cache


def test_prefill_logits_and_caches_match_reference():
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg, S=10)
    jlogits, jcaches = jax.jit(jmodel.prefill)(jparams, _jax(b))
    logits, caches = model.prefill(tparams, _torch(b))
    _close(logits, jlogits, msg="prefill logits")
    assert len(caches) == 1 and set(caches[0]) == {"k", "v", "xk", "xv"}
    assert caches[0]["k"].shape == (2, 2, 10, 4, 64)
    assert caches[0]["xk"].shape == (2, 2, 16, 4, 64)
    for k in ("k", "v", "xk", "xv"):
        _close(caches[0][k], jcaches[k], msg=k)
    meta = model.init_cache(2, 24, device="meta")[0]
    assert {k: tuple(v.shape) for k, v in meta.items()} == {
        "k": (2, 2, 24, 4, 64), "v": (2, 2, 24, 4, 64),
        "xk": (2, 2, 16, 4, 64), "xv": (2, 2, 16, 4, 64)}


def test_prefill_plus_decode_step_equals_full_prefill():
    """The prefill of S − 1 tokens, its self-attention caches grown to S,
    then one decode step at position S − 1: the logits of the full
    prefill (rtol 1e-3 / atol 1e-4), and the reference's decode step on
    its own caches (the forward bound)."""
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg, S=10)
    tok = _t(b["tokens"])
    full, _ = model.prefill(tparams, _torch(b))
    _, caches = model.prefill(tparams, {"tokens": tok[:, :-1],
                                        "frontend": _t(b["frontend"])})
    caches = grow_caches(model, caches, 2, 10)
    step, caches = model.decode_step(tparams, caches, tok[:, -1:], 9)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=1e-3,
                               atol=1e-4)
    jtok = jnp.asarray(b["tokens"])
    _, jc = jmodel.prefill(jparams, {"tokens": jtok[:, :-1],
                                     "frontend": jnp.asarray(b["frontend"])})
    jc = j_grow_caches(jmodel, jc, 2, 10)
    jstep, jc = jmodel.decode_step(jparams, jc, jtok[:, -1:],
                                   jnp.asarray(9, jnp.int32))
    _close(step, jstep, msg="decode logits")
    for k in ("k", "v", "xk", "xv"):
        _close(caches[0][k], jc[k], msg=k)


@pytest.mark.parametrize("window", [0, 8])
def test_greedy_generate_matches_reference(window):
    jmodel, jparams, model, tparams = models(window)
    b = _batch(model.cfg, B=3, S=10, seed=7)
    want = j_greedy_generate(jmodel, jparams, _jax(b), n_steps=6)
    got = greedy_generate(model, tparams, _torch(b), n_steps=6)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_equals_decode_replay():
    """``greedy_generate`` decodes from position S (the frames are not
    positions of the decoder's stream): a replay that takes the cross
    caches of a one-token prefill, feeds the rest of the prompt token by
    token through ``decode_step`` from position 1, then decodes greedily,
    gives its tokens."""
    _, _, model, tparams = models()
    b = _torch(_batch(model.cfg, B=2, S=9, seed=11))
    tok, n_new = b["tokens"], 5
    want = greedy_generate(model, tparams, b, n_steps=n_new)
    logits, caches = model.prefill(tparams, {"tokens": tok[:, :1],
                                             "frontend": b["frontend"]})
    caches = grow_caches(model, caches, 2, 9 + n_new)
    for t in range(1, 9):
        logits, caches = model.decode_step(tparams, caches, tok[:, t:t + 1], t)
    out = []
    for i in range(n_new):
        nxt = torch.argmax(logits[:, -1].float(), -1).to(torch.int32)[:, None]
        out.append(nxt)
        logits, caches = model.decode_step(tparams, caches, nxt, 9 + i)
    assert torch.equal(torch.cat(out, dim=1), want)


@pytest.mark.parametrize("frames", [16, 12])
def test_grow_caches_grows_self_attention_only(frames):
    """``k`` / ``v`` grow to the target length; ``xk`` / ``xv`` pass
    through when the frames are ``n_frontend_tokens`` (16), and are padded
    to 16 with zero rows otherwise — the reference's behaviour (cross
    attention does not mask them)."""
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg, S=6, frames=frames)
    _, caches = model.prefill(tparams, _torch(b))
    grown = grow_caches(model, caches, 2, 20)[0]
    _, jc = jmodel.prefill(jparams, _jax(b))
    jgrown = j_grow_caches(jmodel, jc, 2, 20)
    for k in ("k", "v", "xk", "xv"):
        assert tuple(grown[k].shape) == jgrown[k].shape, k
        _close(grown[k], jgrown[k], msg=k)
    assert grown["k"].shape[2] == 20 and grown["xk"].shape[2] == 16
    if frames == 16:
        assert grown["xk"] is caches[0]["xk"]
    else:
        assert not grown["xk"][:, :, frames:].any()


def test_no_paged_path():
    """As in the reference, the family has no paged entries: the
    continuous-batching engine refuses it."""
    _, _, model, tparams = models()
    assert model.decode_step_paged is None
    assert model.prefill_chunk_paged is None
    assert model.decode_step_mixed is None
    pcfg = PagedCacheConfig(page_size=8, num_pages=9, max_slots=2,
                            max_context=16)
    with pytest.raises(NotImplementedError, match="greedy_generate"):
        ContinuousBatchingEngine(model, tparams, pcfg, device="cpu")
