"""The slice as a whole: the port's 4-agent packed-bus EDM training against
the JAX package's fused one-device ppermute path.

JAX side: ``build_train_step`` with ``gossip_engine="ppermute"`` on a
1-device mesh (``make_gossip_mesh(4, agents_per_device=4)``), the fused
Pallas kernels (interpret mode on the CPU) and the ring.  Port side: the
same configuration on ``device="cpu"`` (the kernels' plain versions).  Both
start from the JAX package's carried state and take 3 steps on the JAX
``SyntheticLM`` tokens.  Loss and consensus agree per step at rtol=1e-4;
the final x, m and ψ buses at atol=1e-5 (f32 on both sides; the slack
covers reduction order in the model's matmuls and softmax, compounded over
3 steps).
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
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import ring
from repro_torch.models import build_model
from repro_torch.train import build_train_step, bus_layout_for, init_state

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
A, SEQ, STEPS = 4, 16, 3


def _run_kw(gossip_every):
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                gossip_every=gossip_every, remat=False)


def _jax_trajectory(gossip_every):
    model = jbuild_model(get_smoke_config("smollm_360m"))
    run = JRunConfig(**_run_kw(gossip_every))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    step = jax.jit(jbuild_train_step(
        model, run, make_gossip_schedule(run, A), use_fused_kernel=True,
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    state = jinit_state(model, run, A, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state)
    data = JSyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    batches, metrics = [], []
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        batches.append(np.array(batch["tokens"]))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batches, metrics, jax.tree.map(np.array, state)


def _port_trajectory(init, batches, gossip_every):
    model = build_model(tget_smoke_config("smollm_360m"))
    run = RunConfig(**_run_kw(gossip_every))
    step = build_train_step(model, run, ring(A), use_fused_kernel=True,
                            device="cpu")
    state = {"params": torch.from_numpy(init["params"]),
             "opt": {k: torch.from_numpy(v) for k, v in init["opt"].items()},
             "step": int(init["step"])}
    metrics = []
    for tokens in batches:
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("gossip_every", [1, 2])
def test_trajectory_matches_reference(gossip_every):
    init, batches, jmetrics, jfinal = _jax_trajectory(gossip_every)
    tmetrics, tfinal = _port_trajectory(init, batches, gossip_every)
    for t, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4,
                                       err_msg=f"step {t} {key}")
    assert tfinal["step"] == int(jfinal["step"]) == STEPS
    np.testing.assert_allclose(tfinal["params"].numpy(), jfinal["params"],
                               rtol=0, atol=1e-5)
    for k in ("m", "psi"):
        np.testing.assert_allclose(tfinal["opt"][k].numpy(), jfinal["opt"][k],
                                   rtol=0, atol=1e-5, err_msg=k)
    # the gossip really mixed: agents drifted apart, then were pulled in
    assert tmetrics[-1]["consensus"] > 0


def test_init_state_from_reference_weights_is_byte_equal():
    """x(0) from JAX-initialised weights carried across equals the JAX
    init_state's bus byte for byte; m(0) = 0 and ψ(0) = x(0) in a distinct
    buffer."""
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    jrun = JRunConfig(**_run_kw(1))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    params = weights.params_from_tree(
        jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0))))
    model = build_model(tget_smoke_config("smollm_360m"))
    state = init_state(model, RunConfig(**_run_kw(1)), A, params=params,
                       device="cpu")
    np.testing.assert_array_equal(state["params"].numpy(),
                                  np.asarray(jstate["params"]))
    assert torch.count_nonzero(state["opt"]["m"]) == 0
    assert torch.equal(state["opt"]["psi"], state["params"])
    assert state["opt"]["psi"].data_ptr() != state["params"].data_ptr()
    layout = bus_layout_for(model, A)
    assert state["params"].shape == (A, layout.rows, 128)


def test_cli_runs_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "smollm_360m", "--smoke", "--steps", "2", "--agents", "4",
         "--seq", "16", "--gossip-engine", "ppermute",
         "--agents-per-device", "4", "--fused-kernel"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if "loss=" in l]
    assert len(lines) == 2, out.stdout
    assert "+fused +bus" in out.stdout
    for l in lines:
        loss = float(l.split("loss=")[1].split()[0])
        assert np.isfinite(loss)
