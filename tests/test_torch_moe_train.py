"""The port's MoE training against the JAX package's, on the
``deepseek_moe_16b`` smoke config with 4 agents on the ring.

* Presets: ``resolve_group_specs`` on ``moe``, ``moe:k`` and lists of
  them equals the reference's; the resolved layout places the expert
  leaves (not the shared experts, not the router) in the ``experts``
  group, as the reference's does, row for row.
* The slice as a whole: 3 EDM steps on the packed bus under
  ``gossip_groups="moe"`` (experts opt out) and ``"moe:2"`` (experts
  gossip every other step), at capacity 1.25 — where the reference is
  asserted to drop assignments — from the JAX package's state (norm
  weights seeded nonzero) on its ``SyntheticLM`` tokens.  The JAX side
  runs on a 1-device mesh with ``agents_per_device=4`` and its plain
  (unfused) EDM update and combine — the Pallas kernels in interpret mode
  take ~6 s a step on the CPU; the port's fused step (the kernels' plain
  versions on the CPU).  Loss and consensus per step at rtol 1e-4; the
  final x, m and ψ buses at atol 1e-5.
* Opt-out rows: after every step of the port's ``moe`` run the expert
  rows of x equal the EDM update's φ rows, ``(ψ' + x) − ψ``, bit for bit.
* Checkpoints: a bf16 MoE bus state (its routers f32) saved by the
  reference loads in the port and saves back byte for byte, and its
  consensus export loads through ``load_consensus`` with every leaf's
  dtype.  (The reference cannot load a bf16 bus state, its own file
  included: ROADMAP §3.)
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
from repro.train import checkpoint as jckpt
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule
from repro.train import resolve_features as jresolve_features
from repro.train import resolve_group_specs as jresolve_group_specs

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule,
                               resolve_features, resolve_group_specs)

from test_torch_moe import count_drops, seeded_norms  # noqa: F401

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "deepseek_moe_16b"
A, SEQ, STEPS = 4, 32, 3


def _run_kw(groups="", **kw):
    base = dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", gossip_groups=groups, remat=False)
    base.update(kw)
    return base


def _spec(s):
    return (s.name, s.match, s.gossip_every, s.wire, s.schedule)


@pytest.mark.parametrize("preset", ["moe", "moe:0", "moe:2", "moe:3,moe:1"])
def test_presets_resolve_as_reference(preset):
    got = resolve_group_specs(RunConfig(**_run_kw(preset)))
    want = jresolve_group_specs(JRunConfig(**_run_kw(preset)))
    assert [_spec(s) for s in got] == [_spec(s) for s in want]
    assert got[0].match == ("moe|w_gate", "moe|w_up", "moe|w_down")


def test_expert_group_layout_matches_reference():
    jrun, run = JRunConfig(**_run_kw("moe")), RunConfig(**_run_kw("moe"))
    jl = jbus_layout_for(jbuild_model(get_smoke_config(ARCH)), A,
                         groups=jresolve_features(jrun).groups)
    tl = bus_layout_for(build_model(tget_smoke_config(ARCH)), A,
                        resolve_features(run).groups)
    assert [(g.name, g.row, g.rows, g.slots, g.gossip_every)
            for g in tl.groups] == [(g.name, g.row, g.rows, g.slots,
                                     g.gossip_every) for g in jl.groups]
    experts = tl.groups[0]
    paths = {tl.paths[i] for i in experts.slots}
    assert paths == {f"blocks|0|moe|{n}" for n in ("w_gate", "w_up",
                                                    "w_down")}


def _states(groups, capacity_factor):
    """(JAX model, run, state), (port model, run, state): the same x(0),
    norm weights seeded."""
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              capacity_factor=capacity_factor)
    jmodel = jbuild_model(cfg)
    seeded = seeded_norms(jmodel.init(jax.random.PRNGKey(0)), seed=6)
    jmodel = dataclasses.replace(jmodel, init=lambda key: seeded)
    jrun = JRunConfig(**_run_kw(groups))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    model = build_model(dataclasses.replace(tget_smoke_config(ARCH),
                                            capacity_factor=capacity_factor))
    run = RunConfig(**_run_kw(groups))
    state = weights.train_state_from_arrays(jax.tree.map(np.array, jstate))
    return (jmodel, jrun, jstate), (model, run, state)


@pytest.mark.parametrize("groups", ["moe", "moe:2"])
def test_moe_trajectory_matches_reference(groups, count_drops):
    (jmodel, jrun, jstate), (model, run, state) = _states(groups, 1.25)
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
    experts = next(g for g in layout.groups if g.name == "experts")
    rows = slice(experts.row, experts.row + experts.rows)
    data = JSyntheticLM(vocab_size=jmodel.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        jstate, jm = jstep(jstate, batch)
        x0 = state["params"][:, rows].clone()
        psi0 = state["opt"]["psi"][:, rows].clone()
        state, m = step(state, {"tokens": torch.from_numpy(
            np.array(batch["tokens"]))})
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {t} {k}")
        phi = (state["opt"]["psi"][:, rows] + x0) - psi0
        gossiped = groups == "moe:2" and t % 2 == 1
        assert torch.equal(state["params"][:, rows], phi) != gossiped, t
    jax.effects_barrier()
    assert sum(count_drops) > 0
    for name, got, want in (("params", state["params"], jstate["params"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("psi", state["opt"]["psi"],
                             jstate["opt"]["psi"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_bf16_moe_state_files_load_in_either_package(tmp_path):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    jmodel = jbuild_model(cfg)
    jrun = JRunConfig(**_run_kw("moe"))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(1))
    jlayout = jbus_layout_for(jmodel, A, groups=jresolve_features(jrun).groups)
    jfile, pfile = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jckpt.save_state(jfile, jstate, layout=jlayout)
    model = build_model(dataclasses.replace(tget_smoke_config(ARCH),
                                            dtype="bfloat16"))
    run = RunConfig(**_run_kw("moe"))
    layout = bus_layout_for(model, A, resolve_features(run).groups)
    like = init_state(model, run, A, device="cpu")
    state = checkpoint.load_state(jfile, like, layout=layout)
    assert torch.equal(state["params"], torch.from_numpy(
        np.array(jstate["params"])))
    checkpoint.save_state(pfile, state, layout=layout)
    with np.load(jfile) as fj, np.load(pfile) as fp:
        assert sorted(fj.files) == sorted(fp.files)
        for k in fj.files:
            assert fj[k].dtype.str == fp[k].dtype.str, k
            assert fj[k].tobytes() == fp[k].tobytes(), k
        assert fp["params|blocks|0|moe|router"].dtype == np.float32
        assert fp["params|blocks|0|moe|w_gate"].dtype.str == "|V2"
    export = str(tmp_path / "consensus.npz")
    checkpoint.export_consensus(pfile, export)
    params = checkpoint.load_consensus(export, model.meta(), device="cpu")
    for path, t in model.meta().items():
        assert params[path].dtype == t.dtype and params[path].shape == \
            t.shape, path
