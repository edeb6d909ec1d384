"""The example twins on the port (``examples/*_torch.py``) against their
JAX references' loops, on the CPU at reduced sizes, as
``tests/test_torch_quickstart.py`` holds the quickstart twin.

* ``heterogeneity_sweep_torch.py``: the Fig. 1-style table at 100 steps
  with full-batch gradients (σ = 0, so both sides take the same
  gradients) against ``heterogeneity_sweep.py``'s loop, every algorithm
  at every ζ², within rtol 1e-3 (f32 on both sides); ``edm_ef`` rounds
  its payload to bf16, where one f32 ulp can flip a rounding, so it is
  held within atol 1e-5 instead.  With the example's noise (σ = 0.05) at
  1000 steps the EDM and ED floors are flat in ζ² (within 2×) while
  DmSGD's grows more than 100-fold.
* ``serving_torch.py`` on the reference's weights and prompts (f32): the
  greedy tokens and the windowed decode step's tokens equal the
  reference's exactly.
* ``decentralized_lm_train_torch.py`` at its small config: 3 steps from
  the reference's carried state on the same numpy batches against the
  reference's train step (the bus path, ppermute on ``make_gossip_mesh``):
  loss and consensus within rtol 1e-4; the checkpoint round trip
  max|Δ| = 0.
* Each twin raises without a GPU unless given ``--device cpu``, and runs
  with it.
"""
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.core import ALGORITHMS as JALGORITHMS
from repro.core import make_mixer, make_optimizer, ring
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import quadratic_problem
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.serve import build_serve_step as j_build_serve_step
from repro.serve import greedy_generate as j_greedy_generate
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.core import ALGORITHMS

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]


def _twin(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the heterogeneity sweep
# ---------------------------------------------------------------------------

SWEEP_STEPS = 100


def _reference_sweep(cs, steps):
    """``heterogeneity_sweep.py``'s loop at σ = 0 (every algorithm's step
    jitted once and reused across ζ²)."""
    n = 32
    topo = ring(n)
    opts = {alg: make_optimizer(alg, alpha=0.05, beta=0.9,
                                mix=make_mixer(topo))
            for alg in sorted(JALGORITHMS)}
    steps_j = {alg: jax.jit(opt.step) for alg, opt in opts.items()}
    table = {}
    for c in cs:
        _, full, x_opt, zeta2 = quadratic_problem(n, c=c, sigma=0.0, seed=0)
        full = jax.jit(full)
        row = {}
        for alg, opt in opts.items():
            x = jnp.zeros((n, x_opt.shape[0]))
            state = opt.init(x)
            for _ in range(steps):
                x, state = steps_j[alg](x, full(x), state)
            row[alg] = float(jnp.mean(jnp.sum((x - x_opt[None]) ** 2, -1)))
        table[zeta2] = row
    return table


def test_sweep_twin_matches_reference():
    mod = _twin("heterogeneity_sweep_torch")
    assert sorted(ALGORITHMS) == sorted(JALGORITHMS)
    got = mod.sweep(SWEEP_STEPS, sigma=0.0, device="cpu")
    want = _reference_sweep(mod.HETEROGENEITY, SWEEP_STEPS)
    assert len(got) == len(want) == 4
    for (zg, rg), (zw, rw) in zip(got.items(), want.items()):
        np.testing.assert_allclose(zg, zw, rtol=1e-6)
        assert set(rg) == set(rw) == set(ALGORITHMS)
        for alg in rw:
            if alg == "edm_ef":
                np.testing.assert_allclose(rg[alg], rw[alg], rtol=0,
                                           atol=1e-5, err_msg=alg)
            else:
                np.testing.assert_allclose(rg[alg], rw[alg], rtol=1e-3,
                                           err_msg=f"{alg} at {zw}")


def test_sweep_twin_floors():
    """With gradient noise (σ = 0.05): EDM's and ED's floors are flat in
    ζ², DmSGD's grows with it."""
    mod = _twin("heterogeneity_sweep_torch")
    table = mod.sweep(1000, cs=(100.0, 0.3), algorithms=("edm", "ed",
                                                         "dmsgd"),
                      device="cpu")
    (z_lo, lo), (z_hi, hi) = table.items()
    assert z_hi > 1e4 * z_lo
    for alg in ("edm", "ed"):
        assert max(lo[alg], hi[alg]) < 2 * min(lo[alg], hi[alg]), (alg, lo,
                                                                    hi)
        assert hi[alg] < 1e-3
    assert hi["dmsgd"] > 100 * lo["dmsgd"] and hi["dmsgd"] > 1.0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_serving_twin_matches_reference():
    mod = _twin("serving_torch")
    jcfg = jget_smoke_config(mod.ARCH)
    assert jcfg.dtype == "float32"
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (mod.B, mod.S)).astype(np.int32)
    got = mod.run("cpu", params=weights.params_from_tree(
        jax.tree.map(np.asarray, jparams)), prompts=prompts)
    want = j_greedy_generate(jmodel, jparams,
                             {"tokens": jnp.asarray(prompts)},
                             n_steps=mod.N_NEW)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want))
    jmodel_w = jbuild_model(jcfg, decode_window=mod.WINDOW)
    logits, caches = jmodel_w.prefill(jparams,
                                      {"tokens": jnp.asarray(prompts)})
    assert got["window_cache_shape"] == jax.tree.leaves(caches)[0].shape
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    nxt, _ = j_build_serve_step(jmodel_w)(jparams, caches, tok,
                                          jnp.asarray(mod.S, jnp.int32))
    assert got["window_next"].tolist() == nxt[:, 0].tolist()


# ---------------------------------------------------------------------------
# decentralized LM training
# ---------------------------------------------------------------------------

A, SEQ, STEPS = 4, 16, 3


def _lm_batches(cfg):
    data = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, n_agents=A,
                        phi=0.2)
    return [np.array(data.sample(jax.random.PRNGKey(100 + t), 1)["tokens"])
            for t in range(STEPS)]


def test_lm_twin_matches_reference(tmp_path):
    mod = _twin("decentralized_lm_train_torch")
    cfg = mod.lm_100m(False)
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    jmodel = jbuild_model(jcfg)
    run = mod.make_run(A, SEQ)
    jrun = JRunConfig(**dataclasses.asdict(run))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    state = weights.train_state_from_arrays(jax.tree.map(np.array, jstate))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jstep = jax.jit(jbuild_train_step(
        jmodel, jrun, jmake_gossip_schedule(jrun, A), use_fused_kernel=False,
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    batches = _lm_batches(cfg)
    jm = []
    for b in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        jm.append({k: float(v) for k, v in m.items()})
    lines = []
    state, history = mod.train(
        cfg, run, A, STEPS,
        lambda t: {"tokens": torch.from_numpy(batches[t])}, device="cpu",
        state=state, log_every=1, log=lines.append)
    assert len(lines) == STEPS and state["step"] == STEPS
    assert state["params"].shape[0] == A            # the packed bus
    for t in range(STEPS):
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(history[t][k], jm[t][k], rtol=1e-4,
                                       err_msg=f"step {t} {k}")
    diff = mod.checkpoint_roundtrip(tmp_path / "lm.npz", cfg, A, state)
    assert diff == 0.0


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")


@pytest.mark.parametrize("name, args, expect", [
    ("heterogeneity_sweep_torch", ["--steps", "3"], "EDM/ED floors"),
    ("serving_torch", [], "one windowed decode step ok"),
    ("decentralized_lm_train_torch", ["--steps", "1", "--seq", "16"],
     "checkpoint roundtrip max|Δ| = 0.0e+00")])
def test_twin_needs_a_device_or_cpu(name, args, expect, tmp_path):
    if name == "decentralized_lm_train_torch":
        args = args + ["--ckpt", str(tmp_path / "lm.npz")]
    cmd = [sys.executable, str(ROOT / "examples" / f"{name}.py")] + args
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    out = subprocess.run(cmd + ["--device", "cpu"], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout
