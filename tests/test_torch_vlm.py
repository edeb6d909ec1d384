"""The port's VLM family (``pixtral_12b``: a frontend stub's embeddings
before the tokens of a dense decoder) against the JAX package, at the
smoke config (2 layers, d_model 256, 4 heads of 64, d_ff 512, vocab 512,
16 frontend tokens, f32).

Weights come from the reference's ``init_lm`` with the norm weights set
to seeded values (``test_torch_mamba.seeded``), carried across by
``repro_torch.weights``; tokens and frontend embeddings are numpy draws.

* Config and parameter tree equal to the reference's, full size and
  smoke.
* ``lm_loss`` with a ``frontend`` batch key and its gradients (the
  frontend's too) against the reference's, rtol 1e-4 / atol 1e-5
  (``test_torch_model.py``'s bound); the frontend positions predict
  nothing: the loss is the mean over the S − 1 token positions of the
  cross entropy of S − 1 prefills, each of the frontend and a prefix.
* ``lm_prefill`` with a frontend: last-token logits and the ``P + S``
  rows of KV cache at the same bound; ``greedy_generate`` with
  ``n_front`` equal to the reference's tokens.
* The paged engine at a G 4 smoke variant (``n_kv_heads`` 1 under 4
  heads, Pixtral's 32 / 8 grouping), text-only as the reference's
  scheduler: legacy and chunked, ``attn_impl`` ``ref`` and ``kernel``
  (the plain kernel versions on the CPU), tokens equal to
  ``greedy_generate``'s and to the JAX engine's.
* Training: 2 EDM steps on the packed bus with a ``frontend`` batch
  against the reference's unfused trainer (loss and consensus rtol
  1e-4, buses atol 1e-5: ``test_torch_mamba_train.py``'s bounds); the
  static-state step (what ``train/graphs.py`` captures) takes every
  batch key and equals the functional step bit for bit, a new frontend
  giving a new loss; the train CLI's ``--resume`` is bit-equal to the
  uninterrupted run with the frontends drawn per global step.
* The bus metrics, which reduce a range of rows at a time so that
  Pixtral's one-layer bus fits the card, equal the tree metrics.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.serve.engine import greedy_generate as j_greedy_generate
from repro.serve.paged_cache import PagedCacheConfig as JPagedCacheConfig
from repro.serve.scheduler import ContinuousBatchingEngine as JEngine
from repro.serve.scheduler import poisson_load as j_poisson_load
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.serve import (ContinuousBatchingEngine, PagedCacheConfig,
                               greedy_generate, poisson_load)
from repro_torch.train import (build_train_step, init_state,
                               make_gossip_schedule)

from test_torch_mamba import _flat, carried, seeded

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "pixtral_12b"
RTOL, ATOL = 1e-4, 1e-5
FULL_PARAMS = 12247782400          # counted on the tree
A, SEQ, STEPS = 4, 8, 2


@functools.lru_cache(maxsize=None)
def models(n_kv_heads=None):
    """(JAX model, JAX params, port model, port params) of the smoke
    config (with ``n_kv_heads`` KV heads when given), norms seeded."""
    jcfg, cfg = jget_smoke_config(ARCH), get_smoke_config(ARCH)
    if n_kv_heads is not None:
        jcfg = dataclasses.replace(jcfg, n_kv_heads=n_kv_heads)
        cfg = dataclasses.replace(cfg, n_kv_heads=n_kv_heads)
    jmodel = jbuild_model(jcfg)
    jparams = seeded(jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jparams, build_model(cfg), carried(jparams)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg, B=2, S=12, seed=5):
    """numpy tokens (B, S) and frontend embeddings (B, P, d)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frontend": rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("full", [False, True])
def test_config_and_tree_match_reference(full):
    cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
    jcfg = jget_config(ARCH) if full else jget_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_config("pixtral-12b") == get_config(ARCH)
    assert cfg.n_frontend_tokens == (256 if full else 16)
    tree = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {p: (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in _flat(tree).items()}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in build_model(cfg).meta().items()}
    assert got == want
    if full:
        assert sum(int(np.prod(s)) for s, _ in got.values()) == FULL_PARAMS
        assert cfg.n_heads // cfg.n_kv_heads == 4 and cfg.hd == 128


# ---------------------------------------------------------------------------
# loss, prefill, greedy_generate
# ---------------------------------------------------------------------------

def test_lm_loss_and_grads_with_frontend_match_reference():
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg)
    jloss, (jgrads, jfront) = jax.jit(jax.value_and_grad(
        lambda p, fe: jmodel.loss(p, {"tokens": jnp.asarray(b["tokens"]),
                                      "frontend": fe}, remat=False),
        argnums=(0, 1)))(jparams, jnp.asarray(b["frontend"]))
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in tparams.items()}
    front = _t(b["frontend"]).requires_grad_()
    loss = model.loss(leaves, {"tokens": _t(b["tokens"]),
                               "frontend": front}, remat=False)
    grads = torch.autograd.grad(loss, list(leaves.values()) + [front])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    want = carried(jgrads)
    for p, g in zip(leaves, grads):
        _close(g, want[p].numpy(), msg=p)
    _close(grads[-1], jfront, msg="frontend")
    assert float(grads[-1].abs().max()) > 0
    # the frontend changes the loss; text alone is another function
    text = model.loss(tparams, {"tokens": _t(b["tokens"])}, remat=False)
    assert abs(float(text) - float(loss)) > 1e-3


def test_frontend_positions_predict_nothing():
    """The loss is the mean cross entropy of the S − 1 token positions:
    prefill t + 1 tokens after the frontend, the last logits predict
    token t + 1 (computed independently of the loss's slicing)."""
    _, _, model, tparams = models()
    b = _batch(model.cfg, B=2, S=6)
    tok, fe = _t(b["tokens"]), _t(b["frontend"])
    loss = model.loss(tparams, {"tokens": tok, "frontend": fe}, remat=False)
    nll = []
    for t in range(tok.shape[1] - 1):
        logits, _ = model.prefill(tparams, {"tokens": tok[:, :t + 1],
                                            "frontend": fe})
        lp = torch.log_softmax(logits[:, -1].float(), -1)
        nll.append(-lp.gather(-1, tok[:, t + 1:t + 2].long())[:, 0])
    np.testing.assert_allclose(float(loss), float(torch.stack(nll).mean()),
                               rtol=RTOL, atol=ATOL)


def test_prefill_with_frontend_matches_reference():
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg, S=10)
    P = model.cfg.n_frontend_tokens
    jlogits, jcaches = jax.jit(jmodel.prefill)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    logits, caches = model.prefill(tparams, {k: _t(v) for k, v in b.items()})
    _close(logits, jlogits, msg="prefill logits")
    assert caches[0]["k"].shape == (2, 2, P + 10, 4, 64)
    for k in ("k", "v"):
        _close(caches[0][k], jcaches[0][k], msg=k)


def test_greedy_generate_with_frontend_matches_reference():
    jmodel, jparams, model, tparams = models()
    b = _batch(model.cfg, B=3, S=10, seed=7)
    want = j_greedy_generate(jmodel, jparams,
                             {k: jnp.asarray(v) for k, v in b.items()},
                             n_steps=6)
    got = greedy_generate(model, tparams, {k: _t(v) for k, v in b.items()},
                          n_steps=6)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the paged engine at G 4, text-only
# ---------------------------------------------------------------------------

PATHS = {"legacy": dict(), "chunked": dict(prefill_chunk=16,
                                           max_step_tokens=20)}
TRACE = dict(rate=500.0, prompt_buckets=(12, 40), new_token_buckets=(4, 9),
             seed=5)
G4_KV_HEADS = 1


def _pcfg(cls):
    return cls(page_size=8, num_pages=1 + 4 * 8, max_slots=4, max_context=64)


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(path):
    jmodel, jparams, tmodel, _ = models(G4_KV_HEADS)
    eng = JEngine(jmodel, jparams, _pcfg(JPagedCacheConfig), attn_impl="ref",
                  **PATHS[path])
    eng.run(j_poisson_load(6, vocab=tmodel.cfg.vocab_size, **TRACE))
    return {rid: toks.tolist() for rid, toks in eng.completed.items()}


@pytest.mark.parametrize("attn_impl", ["ref", "kernel"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_g4_engine_matches_greedy_generate_and_jax_engine(path, attn_impl):
    _, _, tmodel, tparams = models(G4_KV_HEADS)
    cfg = tmodel.cfg
    assert cfg.n_heads // cfg.n_kv_heads == 4
    eng = ContinuousBatchingEngine(tmodel, tparams, _pcfg(PagedCacheConfig),
                                   attn_impl=attn_impl, device="cpu",
                                   **PATHS[path])
    reqs = poisson_load(6, vocab=cfg.vocab_size, **TRACE)
    eng.run(reqs)
    got = {r: t.tolist() for r, t in eng.completed.items()}
    assert got == _jax_engine_tokens(path)
    for r in reqs:
        want = greedy_generate(tmodel, tparams,
                               {"tokens": torch.from_numpy(r.tokens)[None]},
                               n_steps=r.max_new)[0].tolist()
        assert got[r.rid] == want, r.rid


# ---------------------------------------------------------------------------
# training with a frontend batch
# ---------------------------------------------------------------------------

def _run_kw():
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", remat=False)


def _train_batch(cfg, t):
    """The reference's SyntheticLM tokens (A, 1, SEQ) of step t and numpy
    frontend embeddings (A, 1, P, d)."""
    data = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, n_agents=A)
    tokens = np.array(data.sample(jax.random.PRNGKey(100 + t), 1)["tokens"])
    fe = np.random.default_rng(t).standard_normal(
        (A, 1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "frontend": fe}


def test_frontend_trajectory_matches_reference():
    jmodel = jbuild_model(jget_smoke_config(ARCH))
    params = seeded(jmodel.init(jax.random.PRNGKey(0)), seed=6)
    jmodel = dataclasses.replace(jmodel, init=lambda key: params)
    jrun = JRunConfig(**_run_kw())
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    run = RunConfig(**_run_kw())
    state = weights.train_state_from_arrays(jax.tree.map(np.array, jstate))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jstep = jax.jit(jbuild_train_step(
        jmodel, jrun, jmake_gossip_schedule(jrun, A),
        use_fused_kernel=False, mesh=mesh,
        agent_axes=gossip_agent_axes(mesh)))
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    model = build_model(get_smoke_config(ARCH))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    for t in range(STEPS):
        b = _train_batch(model.cfg, t)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: _t(v) for k, v in b.items()})
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {t} {k}")
    for name, got, want in (("params", state["params"], jstate["params"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("psi", state["opt"]["psi"],
                             jstate["opt"]["psi"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_static_step_takes_the_frontend():
    """The static-state step (``StaticBusStep.run``, the body a CUDA graph
    replays from static batch buffers) reads every batch key: over steps
    with new frontends it equals the functional step bit for bit, and the
    same tokens under another frontend give another loss."""
    model = build_model(get_smoke_config(ARCH))
    run = RunConfig(**_run_kw())
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    batches = [{k: _t(v) for k, v in _train_batch(model.cfg, t).items()}
               for t in range(STEPS)]
    want = init_state(model, run, A, seed=0, device="cpu")
    want_metrics = []
    for b in batches:
        want, m = step(want, b)
        want_metrics.append(m)
    state = init_state(model, run, A, seed=0, device="cpu")
    for t, b in enumerate(batches):
        metrics = step.static.run(state, b, None)
        state["step"] += 1
        for k, v in want_metrics[t].items():
            assert torch.equal(metrics[k], v), (t, k)
    assert torch.equal(state["params"], want["params"])
    other = dict(batches[0], frontend=batches[1]["frontend"])
    fresh = init_state(model, run, A, seed=0, device="cpu")
    m = step.static.run(fresh, other, None)
    assert not torch.equal(m["loss"], want_metrics[0]["loss"])


CLI = ["--device", "cpu", "--arch", ARCH, "--smoke", "--agents", str(A),
       "--agents-per-device", str(A), "--gossip-engine", "ppermute",
       "--fused-kernel", "--seq", str(SEQ)]


def test_cli_resume_with_frontends_is_the_uninterrupted_run(tmp_path):
    ck = str(tmp_path / "ck.npz")
    full = tcli.main(CLI + ["--steps", "4"])
    tcli.main(CLI + ["--steps", "2", "--ckpt", ck])
    rest = tcli.main(CLI + ["--steps", "2", "--resume", ck])
    assert rest["state"]["step"] == 4
    assert torch.equal(full["state"]["params"], rest["state"]["params"])
    for k in full["state"]["opt"]:
        assert torch.equal(full["state"]["opt"][k], rest["state"]["opt"][k])
    assert full["metrics"][2:] == rest["metrics"]


def test_bus_metrics_reduce_in_row_ranges(monkeypatch):
    """The bus metrics reduce a few rows at a time (a 6 GiB agent block
    of Pixtral's one-layer bus is not copied whole): over ranges of 5
    rows they equal the tree metrics of the same values, rtol 1e-6."""
    from repro_torch.core import metrics
    monkeypatch.setattr(metrics, "_ROWS", 5)
    rng = np.random.default_rng(3)
    bus = torch.from_numpy(rng.standard_normal((3, 23, 128)).astype(
        np.float32))
    np.testing.assert_allclose(float(metrics.bus_consensus(bus)),
                               float(metrics.consensus_distance(bus)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics.bus_grad_norm(bus)),
                               float(metrics.tree_sqnorm(bus).sqrt()),
                               rtol=1e-6)
