"""The slice as a whole: the tree-resident train path of the port against
the JAX package's, and the paper's problems.

* 3-step trajectories of ``edm`` (fused and plain), ``dmsgd``, ``dsgt_hb``
  (fused) and ``qg`` on the smoke ``smollm_360m``; the levers
  ``gossip_every``, the LR schedule and ``gossip_dtype`` run through
  :func:`check_trajectory` in ``test_torch_tree_levers.py``;
* the tree ``init_state`` and the bf16 bits of a carried tree state;
* the §E.1 / §E.2 problem tables and the §E.3 partition equal the JAX
  package's;
* the train CLI on the tree path.

Trajectories.  JAX side: ``build_train_step`` on the tree path
(``packed_bus=False``) with the one-device ppermute engine
(``make_gossip_mesh(4, agents_per_device=4)``), the fused Pallas kernels in
interpret mode where ``use_fused_kernel`` is set.  Port side: the same
configuration on ``device="cpu"`` (the kernels' plain versions).  Both
start from the JAX ``init_state``'s tree state carried across by
``weights.train_state_from_arrays`` and take 3 steps on the JAX
``SyntheticLM`` tokens (f32 leaves).  Loss, consensus and grad norm agree
per step at rtol 1e-5, the final parameters and optimizer state at atol
1e-5 (f32 on both sides; the slack covers reduction order in the model's
matmuls and softmax).

With ``gossip_dtype="bfloat16"`` the payload is rounded to bf16 and the
consensus of the first steps is mostly that rounding, so the case here
runs the fused combine on both sides (f32 accumulation, one rounding): the
plain bf16 sum rounds after every operation in eager PyTorch, while XLA
by default keeps parts of the jitted chain in f32 (its excess precision;
29 % apart in consensus at step 0).  The plain case,
``"edm-gossip-bf16"``, agrees once XLA's excess precision is off: it runs
in ``test_torch_tree_gossip_bf16.py``, its JAX side in a process started
with that flag.  An
element whose f32 value lies within the reduction-order slack of a bf16
rounding boundary still rounds one bf16 ulp apart, and over 3 steps a
flipped payload feeds the next ψ: consensus is held at rtol 1e-3 and the
state within 4 bf16 ulps, atol 1e-5 + 2⁻⁵·|x| (2 ulps seen, on ≤ 2 of
~10⁶ elements per leaf).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import dirichlet_partition as jdirichlet_partition
from repro.data import logistic_problem as jlogistic_problem
from repro.data import quadratic_problem as jquadratic_problem
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import ring
from repro_torch.data import (dirichlet_partition, logistic_problem,
                              quadratic_problem)
from repro_torch.models import build_model
from repro_torch.train import build_train_step, init_state

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
A, SEQ, STEPS = 4, 16, 3

CASES = {
    "edm-fused": dict(algorithm="edm", fused=True),
    "edm": dict(algorithm="edm"),
    "dmsgd": dict(algorithm="dmsgd"),
    "dsgt_hb-fused": dict(algorithm="dsgt_hb", fused=True),
    "qg": dict(algorithm="qg"),
    "edm-fused-every2": dict(algorithm="edm", fused=True, gossip_every=2),
    "dmsgd-warmup-cosine": dict(algorithm="dmsgd", warmup_steps=2,
                                total_steps=4),
    "edm-fused-gossip-bf16": dict(algorithm="edm", fused=True,
                                  gossip_dtype="bfloat16"),
    "edm-gossip-bf16": dict(algorithm="edm", gossip_dtype="bfloat16"),
}
CAST_CASES = ("edm-fused-gossip-bf16", "edm-gossip-bf16")


def run_kw(case):
    kw = dict(CASES[case])
    kw.pop("fused", None)
    return dict(global_batch=A, seq_len=SEQ, alpha=0.2, beta=0.9,
                gossip_engine="ppermute", agents_per_device=A,
                packed_bus=False, remat=False, **kw)


def walk(tree, prefix=""):
    """A nested numpy tree as ``{|-joined path: array}``."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(walk(v, f"{prefix}|{k}" if prefix else str(k)))
    return out


def jax_trajectory(case):
    model = jbuild_model(get_smoke_config("smollm_360m"))
    run = JRunConfig(**run_kw(case))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    step = jax.jit(jbuild_train_step(
        model, run, make_gossip_schedule(run, A),
        use_fused_kernel=CASES[case].get("fused", False), mesh=mesh,
        agent_axes=gossip_agent_axes(mesh)))
    state = jinit_state(model, run, A, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    data = JSyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    batches, metrics = [], []
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        batches.append(np.array(batch["tokens"]))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batches, metrics, jax.tree.map(np.asarray, state)


def check_trajectory(case, reference=None):
    """Run ``case`` on both sides and assert agreement as stated above;
    ``reference`` is the JAX side's :func:`jax_trajectory`, when it was
    run elsewhere (in a process with other XLA flags)."""
    init, batches, jmetrics, jfinal = reference or jax_trajectory(case)
    model = build_model(tget_smoke_config("smollm_360m"))
    state = weights.train_state_from_arrays(init)
    step = build_train_step(model, RunConfig(**run_kw(case)), ring(A),
                            use_fused_kernel=CASES[case].get("fused", False),
                            device="cpu")
    tmetrics = []
    for tokens in batches:
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        tmetrics.append({k: float(v) for k, v in m.items()})
    cast = case in CAST_CASES
    for t, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            rtol = 1e-3 if cast and key == "consensus" else 1e-5
            np.testing.assert_allclose(tm[key], jm[key], rtol=rtol,
                                       err_msg=f"step {t} {key}")
    assert state["step"] == int(jfinal["step"]) == STEPS
    assert tmetrics[-1]["consensus"] > 0
    assert set(state["opt"]) == set(jfinal["opt"])
    trees = {"params": (state["params"], jfinal["params"])}
    for slot in jfinal["opt"]:
        trees[slot] = (state["opt"][slot], jfinal["opt"][slot])
    for name, (got, want) in trees.items():
        want = walk(want)
        assert set(got) == set(want), name
        for p, w in want.items():
            g = got[p].numpy()
            assert g.dtype == w.dtype, (name, p)
            atol = 1e-5 + (2.0 ** -5 * np.abs(w) if cast else 0.0)
            assert np.all(np.abs(g - w) <= atol), (name, p)




@pytest.mark.parametrize("case", ["edm-fused", "edm", "dmsgd",
                                  "dsgt_hb-fused", "qg"])
def test_tree_trajectory_matches_reference(case):
    check_trajectory(case)


def test_init_state_matches_reference_tree():
    """The port's tree ``init_state`` from JAX-initialised weights equals
    the JAX tree state: replicated x(0), zero slots, ψ(0) = x(0) in its
    own buffer."""
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    jrun = JRunConfig(**run_kw("dsgt_hb-fused"))
    jstate = jax.tree.map(np.asarray, jinit_state(jmodel, jrun, A,
                                                  jax.random.PRNGKey(0)))
    params = weights.params_from_tree(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    model = build_model(tget_smoke_config("smollm_360m"))
    for alg, slots in (("dsgt_hb", {"y", "g_prev", "m"}),
                       ("edm", {"m", "psi"}), ("edm_ef", {"m", "psi", "e"}),
                       ("dsgd", set())):
        run = RunConfig(**{**run_kw("dsgt_hb-fused"), "algorithm": alg})
        state = init_state(model, run, A, params=params, device="cpu")
        assert set(state["opt"]) == slots and state["step"] == 0
        for p, w in walk(jstate["params"]).items():
            assert np.array_equal(state["params"][p].numpy(), w)
            for slot in slots:
                want = w if slot == "psi" else np.zeros_like(w)
                assert np.array_equal(state["opt"][slot][p].numpy(), want)
        if "psi" in slots:
            assert all(state["opt"]["psi"][p].data_ptr()
                       != state["params"][p].data_ptr() for p in params)


def test_bf16_tree_state_carries_bits_exactly():
    import dataclasses
    import jax.numpy as jnp
    cfg = dataclasses.replace(get_smoke_config("smollm_360m"),
                              dtype="bfloat16")
    jrun = JRunConfig(**{**run_kw("edm"), "algorithm": "qg"})
    jstate = jinit_state(jbuild_model(cfg), jrun, A, jax.random.PRNGKey(1))
    jstate["opt"]["m"] = jax.tree.map(lambda x: x * 3 + 1,
                                      jstate["params"])
    arrays = jax.tree.map(np.asarray, jstate)
    state = weights.train_state_from_arrays(arrays)
    for name, tree in (("params", arrays["params"]),
                       ("m", arrays["opt"]["m"])):
        got = state["params"] if name == "params" else state["opt"]["m"]
        for p, w in walk(tree).items():
            assert got[p].dtype == torch.bfloat16
            assert np.array_equal(got[p].view(torch.int16).numpy(),
                                  np.asarray(w).view(np.int16)), (name, p)
    assert jnp.bfloat16 == arrays["params"]["embed"].dtype


def test_problem_tables_match_reference():
    """The §E.1 / §E.2 tables come from numpy in the JAX package's order:
    x* and ζ² equal bit for bit, and the gradients, which read the tables
    A, b and U, v, agree at a common x at rtol 1e-5 (einsum order); the
    §E.3 partition is equal."""
    _, jfull, jx, jzeta = jquadratic_problem(8, c=0.5, seed=3)
    sg, full, x_star, zeta = quadratic_problem(8, c=0.5, seed=3,
                                               device="cpu")
    assert zeta == jzeta
    np.testing.assert_array_equal(x_star.numpy(), np.asarray(jx))
    x = np.random.default_rng(0).standard_normal((8, 10), dtype=np.float32)
    np.testing.assert_allclose(full(torch.from_numpy(x)).numpy(),
                               np.asarray(jfull(x)), rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    noisy = sg(torch.from_numpy(x), gen) - full(torch.from_numpy(x))
    assert 0.01 < float(noisy.std()) < 0.1          # sigma = 0.05
    _, jlfull, jloss = jlogistic_problem(4, d=5, m=50, seed=2)
    _, lfull, loss = logistic_problem(4, d=5, m=50, seed=2, device="cpu")
    xl = np.random.default_rng(1).standard_normal((4, 5), dtype=np.float32)
    np.testing.assert_allclose(lfull(torch.from_numpy(xl)).numpy(),
                               np.asarray(jlfull(xl)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss(torch.from_numpy(xl[0]))),
                               float(jloss(xl[0])), rtol=1e-5)
    labels = np.random.default_rng(5).integers(0, 10, size=500)
    for got, want in zip(dirichlet_partition(labels, 6, 0.3, seed=1),
                         jdirichlet_partition(labels, 6, 0.3, seed=1)):
        np.testing.assert_array_equal(got, want)


def test_tree_cli_runs_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "smollm_360m", "--smoke", "--no-packed-bus",
         "--algorithm", "dsgt_hb", "--agents", "4", "--agents-per-device",
         "4", "--gossip-engine", "ppermute", "--fused-kernel", "--steps",
         "2", "--seq", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "alg=dsgt_hb" in out.stdout and "+tree" in out.stdout
    lines = [l for l in out.stdout.splitlines() if "loss=" in l]
    assert len(lines) == 2, out.stdout
    for l in lines:
        assert np.isfinite(float(l.split("loss=")[1].split()[0]))
        assert np.isfinite(float(l.split("consensus=")[1].split()[0]))
