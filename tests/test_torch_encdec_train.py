"""Training the port's encoder-decoder family (``whisper_small``) on the
packed bus, against the JAX package, at the smoke config (2 + 2 layers,
d_model 256, 16 frames, f32).

* The bus layout: the reference's rows at the smoke config, and the full
  model's ``(4, 2171392, 128)`` f32 bus from the shapes alone.
* A 3-step EDM trajectory on 4 agents over the ring against the
  reference's ``build_train_step`` (ppermute engine on
  ``make_gossip_mesh``) from one carried state and the same numpy tokens
  and frames: loss and consensus within rtol 1e-4, params / m / ψ within
  atol 1e-5 (``test_torch_vlm.py``'s bounds).  The reference's trainer
  passes no ``remat_policy`` to this family and the port's passes one,
  which the loss ignores.
* The static-state step (what ``train/graphs.py`` captures) reads new
  frames every step: bit-equal to the functional step over steps with new
  frames, and the same tokens under other frames give another loss.
* The CLIs: train ``--ckpt`` (frames drawn per global step, so
  ``--resume`` is bit-equal to the uninterrupted run), the port's and the
  reference's ``export_consensus`` of that file equal, then the serve
  CLI's fixed batch ``--ckpt`` serving the export's digest.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import bus_layout_for as jbus_layout_for
from repro.train import checkpoint as jcheckpoint
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule)

from test_torch_encdec import seeded

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper_small"
A, SEQ, STEPS = 4, 8, 3


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bus_layout_matches_reference():
    jmodel = jbuild_model(jget_smoke_config(ARCH))
    model = build_model(get_smoke_config(ARCH))
    want = jbus_layout_for(jmodel, A)
    got = bus_layout_for(model, A)
    assert got.rows == want.rows
    assert [(s.row, s.rows, s.shape) for s in got.slots] == [
        (s.row, s.rows, tuple(s.shape)) for s in want.slots]
    full = bus_layout_for(build_model(get_config(ARCH)), A)
    assert (A, full.rows, 128) == (4, 2171392, 128)
    assert sum(s.size for s in full.slots) == 277893120


def _run_kw():
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", remat=False)


def _train_batch(cfg, t):
    """The reference's SyntheticLM tokens (A, 1, SEQ) of step t and numpy
    frames (A, 1, T, d)."""
    data = JSyntheticLM(vocab_size=cfg.vocab_size, seq_len=SEQ, n_agents=A)
    tokens = np.array(data.sample(jax.random.PRNGKey(100 + t), 1)["tokens"])
    fe = np.random.default_rng(t).standard_normal(
        (A, 1, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": tokens, "frontend": fe}


def test_trajectory_matches_reference():
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


def test_static_step_reads_new_frames():
    """The static-state step (``StaticBusStep.run``, the body a CUDA graph
    replays from static batch buffers) reads the frames: over steps with
    new frames it equals the functional step bit for bit, and the same
    tokens under other frames give another loss."""
    model = build_model(get_smoke_config(ARCH))
    run = RunConfig(**_run_kw())
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    batches = [{k: _t(v) for k, v in _train_batch(model.cfg, t).items()}
               for t in range(2)]
    batches[1]["tokens"] = batches[0]["tokens"]     # only the frames change
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


def test_cli_train_resume_export_serve(tmp_path):
    """Train 2 steps with ``--ckpt``, resume 2 more: bit-equal to 4
    uninterrupted steps.  The port's and the reference's
    ``export_consensus`` of the file agree bit for bit, and the serve
    CLI's fixed batch ``--ckpt`` serves the export's digest;
    ``--continuous-batching`` raises (no paged path)."""
    ck, ck4 = str(tmp_path / "ck.npz"), str(tmp_path / "ck4.npz")
    full = tcli.main(CLI + ["--steps", "4", "--ckpt", ck4])
    tcli.main(CLI + ["--steps", "2", "--ckpt", ck])
    rest = tcli.main(CLI + ["--steps", "2", "--resume", ck])
    assert rest["state"]["step"] == 4
    assert torch.equal(full["state"]["params"], rest["state"]["params"])
    for k in full["state"]["opt"]:
        assert torch.equal(full["state"]["opt"][k], rest["state"]["opt"][k])
    assert full["metrics"][2:] == rest["metrics"]

    out, jout = str(tmp_path / "cons.npz"), str(tmp_path / "jcons.npz")
    checkpoint.export_consensus(ck4, out)
    jcheckpoint.export_consensus(ck4, jout)
    mine, theirs = weights.params_from_npz(out), weights.params_from_npz(jout)
    assert set(mine) == set(theirs) == set(
        build_model(get_smoke_config(ARCH)).meta())
    for p in mine:
        assert torch.equal(mine[p], theirs[p]), p
    digest = weights.params_digest(mine)

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    serve = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", ARCH, "--smoke", "--ckpt", out]
    res = subprocess.run(serve + ["--batch", "2", "--prompt-len", "8",
                                  "--new-tokens", "4"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"(sha256 {digest})" in res.stdout
    assert "frontend=16" in res.stdout and "generated 4 tokens" in res.stdout
    res = subprocess.run(serve + ["--continuous-batching"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no paged decode path" in res.stderr
