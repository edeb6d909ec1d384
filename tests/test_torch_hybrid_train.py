"""The port's hybrid training against the JAX package's, on the
``jamba_1_5_large_398b`` smoke config (8 layers: Mamba, attention and
MoE layers in one block period) with 4 agents on the ring.

* Layout: the packed bus of the mixed period, ungrouped and under the
  ``ssm:0,moe`` preset pair (the conv / state leaves and the expert
  leaves each in a group of their own, both opted out), equals the
  reference's ``bus_layout_for`` row for row: every leaf's row and
  padded size, and every group's name, rows and cadence.
* The slice as a whole: 2 EDM steps on the packed bus, ungrouped and
  under ``ssm:0,moe``, from the JAX package's state (zero-init leaves
  seeded) on its ``SyntheticLM`` tokens.  The JAX side runs its plain
  (unfused) step on a 1-device mesh with ``agents_per_device=4``; the
  port its fused step (the kernels' plain versions on the CPU).  Loss and
  consensus per step at rtol 1e-4; the final x, m and ψ buses at atol
  1e-5 (``test_torch_mamba_train.py``'s bounds).  Under ``ssm:0,moe``
  the opted-out rows of x equal the EDM update's φ rows, ``(ψ' + x) −
  ψ``, bit for bit after every step.

``remat`` and checkpoints of the hybrid model are in
``test_torch_hybrid_state.py``, which imports this file's run settings.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import bus_layout_for as jbus_layout_for
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule
from repro.train import resolve_features as jresolve_features

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for,
                               make_gossip_schedule, resolve_features)

from test_torch_mamba import seeded

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "jamba_1_5_large_398b"
A, SEQ, STEPS = 4, 16, 2
GROUPS = "ssm:0,moe"


def _run_kw(groups="", **kw):
    base = dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", gossip_groups=groups, remat=False)
    base.update(kw)
    return base


def _layouts(groups, dtype="float32"):
    jrun, run = JRunConfig(**_run_kw(groups)), RunConfig(**_run_kw(groups))
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    cfg = dataclasses.replace(tget_smoke_config(ARCH), dtype=dtype)
    return (jbus_layout_for(jbuild_model(jcfg), A,
                            groups=jresolve_features(jrun).groups),
            bus_layout_for(build_model(cfg), A,
                           resolve_features(run).groups))


@pytest.mark.parametrize("groups", ["", GROUPS])
def test_mixed_period_layout_matches_reference(groups):
    jl, tl = _layouts(groups)
    assert tl.rows == jl.rows and tl.block_rows == jl.block_rows
    assert len(tl.slots) == len(jl.slots)
    for ts, js in zip(tl.slots, jl.slots):
        assert (ts.row, ts.rows, ts.shape, ts.size) == \
            (js.row, js.rows, js.shape, js.size)
        assert str(ts.dtype).split(".")[1] == np.dtype(js.dtype).name
    assert [(g.name, g.row, g.rows, g.slots, g.gossip_every)
            for g in tl.groups] == [(g.name, g.row, g.rows, g.slots,
                                     g.gossip_every) for g in jl.groups]
    if groups:
        names = {g.name: {tl.paths[i] for i in g.slots} for g in tl.groups}
        assert set(names) == {"experts", "ssm_state", "dense"}
        assert names["experts"] == {f"blocks|{pi}|moe|{w}"
                                    for pi in (1, 3, 5, 7)
                                    for w in ("w_gate", "w_up", "w_down")}
        assert names["ssm_state"] == {
            f"blocks|{pi}|ssm|{n}" for pi in (0, 1, 2, 3, 5, 6, 7)
            for n in ("conv_w", "conv_b", "A_log", "D", "dt_bias")}
        assert all(g.gossip_every == 0 for g in tl.groups
                   if g.name != "dense")


def _states(groups):
    """(JAX model, run, state), (port model, run, state): the same x(0)."""
    jmodel = jbuild_model(get_smoke_config(ARCH))
    params = seeded(jmodel.init(jax.random.PRNGKey(0)), seed=6)
    jmodel = dataclasses.replace(jmodel, init=lambda key: params)
    jrun = JRunConfig(**_run_kw(groups))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    run = RunConfig(**_run_kw(groups))
    state = weights.train_state_from_arrays(jax.tree.map(np.array, jstate))
    return (jmodel, jrun, jstate), (build_model(tget_smoke_config(ARCH)),
                                    run, state)


@pytest.mark.parametrize("groups", ["", GROUPS])
def test_hybrid_trajectory_matches_reference(groups):
    (jmodel, jrun, jstate), (model, run, state) = _states(groups)
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jstep = jax.jit(jbuild_train_step(
        jmodel, jrun, jmake_gossip_schedule(jrun, A),
        use_fused_kernel=False, mesh=mesh,
        agent_axes=gossip_agent_axes(mesh)))
    # on the step's output sharding, so that step 1 reuses step 0's compile
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    layout = bus_layout_for(model, A, resolve_features(run).groups)
    opted_out = [slice(g.row, g.row + g.rows) for g in layout.groups
                 if g.gossip_every == 0]
    assert len(opted_out) == (2 if groups else 0)
    data = JSyntheticLM(vocab_size=jmodel.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        jstate, jm = jstep(jstate, batch)
        before = [(state["params"][:, r].clone(),
                   state["opt"]["psi"][:, r].clone()) for r in opted_out]
        state, m = step(state, {"tokens": torch.from_numpy(
            np.array(batch["tokens"]))})
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {t} {k}")
        for r, (x0, psi0) in zip(opted_out, before):
            phi = (state["opt"]["psi"][:, r] + x0) - psi0
            assert torch.equal(state["params"][:, r], phi), (t, r)
    for name, got, want in (("params", state["params"], jstate["params"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("psi", state["opt"]["psi"],
                             jstate["opt"]["psi"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)
