"""The port's SSM training against the JAX package's, on the
``falcon_mamba_7b`` smoke config with 4 agents on the ring, and the
port's ``remat``.

* Presets: ``resolve_group_specs`` on ``ssm``, ``ssm:k`` and ``moe:2,ssm``
  equals the reference's (one group each, in the order given); the
  resolved layout puts the conv / SSM state leaves (``conv_w``,
  ``conv_b``, ``A_log``, ``D``, ``dt_bias``) in the ``ssm_state`` group
  and the projections in ``dense``, row for row as the reference's.
* The slice as a whole: 2 EDM steps on the packed bus under
  ``gossip_groups="ssm"`` (the state leaves opt out) and ``"ssm:2"``
  (they gossip every other step), from the JAX package's state (zero-init
  leaves seeded) on its ``SyntheticLM`` tokens.  The JAX side runs its
  plain (unfused) step on a 1-device mesh with ``agents_per_device=4``;
  the port its fused step (the kernels' plain versions on the CPU).  Loss
  and consensus per step at rtol 1e-4; the final x, m and ψ buses at atol
  1e-5.  After every step of the port's run the state rows of x equal the
  EDM update's φ rows, ``(ψ' + x) − ψ``, bit for bit, except on a step
  where the group gossips.
* ``remat``: ``"full"`` and ``"dots"`` give gradients bit-equal to
  ``remat=False`` for the dense and the SSM smoke models; the trainer
  passes ``RunConfig.remat_policy`` through (an unknown policy raises).
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
from repro.train import resolve_group_specs as jresolve_group_specs

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build_model
from repro_torch.models.mamba import SSM_STATE_LEAF_PATTERNS
from repro_torch.train import (build_train_step, bus_layout_for, init_state,
                               make_gossip_schedule, resolve_features,
                               resolve_group_specs)

from test_torch_mamba import seeded

torch.set_num_threads(1)  # xdist workers share the cores

ARCH = "falcon_mamba_7b"
A, SEQ, STEPS = 4, 32, 2


def _run_kw(groups="", **kw):
    base = dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", gossip_groups=groups, remat=False)
    base.update(kw)
    return base


def _spec(s):
    return (s.name, s.match, s.gossip_every, s.wire, s.schedule)


@pytest.mark.parametrize("preset", ["ssm", "ssm:0", "ssm:2", "moe:2,ssm"])
def test_presets_resolve_as_reference(preset):
    got = resolve_group_specs(RunConfig(**_run_kw(preset)))
    want = jresolve_group_specs(JRunConfig(**_run_kw(preset)))
    assert [_spec(s) for s in got] == [_spec(s) for s in want]
    assert got[-1].name == "ssm_state"
    assert got[-1].match == SSM_STATE_LEAF_PATTERNS
    if preset == "moe:2,ssm":
        assert [s.name for s in got] == ["experts", "ssm_state"]


def test_ssm_group_layout_matches_reference():
    jrun, run = JRunConfig(**_run_kw("ssm")), RunConfig(**_run_kw("ssm"))
    jl = jbus_layout_for(jbuild_model(get_smoke_config(ARCH)), A,
                         groups=jresolve_features(jrun).groups)
    tl = bus_layout_for(build_model(tget_smoke_config(ARCH)), A,
                        resolve_features(run).groups)
    assert [(g.name, g.row, g.rows, g.slots, g.gossip_every)
            for g in tl.groups] == [(g.name, g.row, g.rows, g.slots,
                                     g.gossip_every) for g in jl.groups]
    state = next(g for g in tl.groups if g.name == "ssm_state")
    paths = {tl.paths[i] for i in state.slots}
    assert paths == {f"blocks|0|ssm|{n}" for n in ("conv_w", "conv_b",
                                                   "A_log", "D", "dt_bias")}


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


@pytest.mark.parametrize("groups", ["ssm", "ssm:2"])
def test_ssm_trajectory_matches_reference(groups):
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
    group = next(g for g in layout.groups if g.name == "ssm_state")
    rows = slice(group.row, group.row + group.rows)
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
        gossiped = groups == "ssm:2" and t % 2 == 1
        assert torch.equal(state["params"][:, rows], phi) != gossiped, t
    for name, got, want in (("params", state["params"], jstate["params"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("psi", state["opt"]["psi"],
                             jstate["opt"]["psi"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _grads(model, params, tokens, **kw):
    leaves = {p: v.detach().clone().requires_grad_()
              for p, v in params.items()}
    loss = model.loss(leaves, {"tokens": tokens}, **kw)
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))


@pytest.mark.parametrize("arch", ["smollm_360m", ARCH])
def test_remat_gradients_are_bit_equal(arch):
    model = build_model(tget_smoke_config(arch))
    params = model.init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 24)))
    loss, want = _grads(model, params, tokens, remat=False)
    for policy in ("full", "dots"):
        got_loss, got = _grads(model, params, tokens, remat=True,
                               remat_policy=policy)
        assert torch.equal(got_loss, loss), policy
        for g, w in zip(got, want):
            assert torch.equal(g, w), policy
    with pytest.raises(ValueError, match="remat_policy"):
        _grads(model, params, tokens, remat=True, remat_policy="offload")


def test_trainer_passes_remat_policy():
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(remat=True, remat_policy="offload"))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            device="cpu")
    state = init_state(model, run, A, device="cpu")
    tokens = torch.zeros((A, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat_policy"):
        step(state, {"tokens": tokens})
