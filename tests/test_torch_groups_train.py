"""Policy groups in the port's trainer (DESIGN §12) against the JAX package.

* The slice as a whole: 3 grouped EDM steps of the 4-group policy of
  ``test_torch_groups.py`` on the ring, from the JAX package's carried
  state and on its ``SyntheticLM`` tokens.  JAX side as
  ``test_torch_train.py`` runs it (1-device mesh, ``agents_per_device=4``,
  Pallas in interpret mode), with each wired group's encode put in at the
  schedule-mixer seam (the reference's group mixer leaves it out:
  ``test_torch_groups.py``).  Loss and consensus agree per step at rtol
  1e-4; the final x, m and ψ buses at atol 1e-5 on the rows of the f32 and
  the opt-out groups.  On a wired group's rows the quantizer is a step
  function: f32 drift between the two sides (the model's reduction order)
  moves a value across a rounding tie now and then, which puts that
  element one quantum apart after the combine.  Those rows are held, as
  ``test_torch_wire_trajectory.py`` holds the EF wire, within ``QUANTA``
  quanta of the group's wire plus 1e-5, with at most ``FLIP_SHARE`` of
  their elements off by more than 1e-5.
* The port's default, explicit catch-all and 2-group all-gossip runs are
  bit-equal on the unpacked leaves (the ring, the EDM update and the
  combines are per row).
* A grouped step's graph key is every gossiping group's (mixes, round)
  pair: the chip cell's policy has two keys.
* The train CLI takes ``--gossip-groups @file.json`` and prints each
  group's modeled wire bytes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import mixing as jmix
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import bus as tbus
from repro_torch.core import group_wire_bytes_per_step
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, init_state,
                               make_gossip_schedule, make_group_plans,
                               resolve_features)

from test_torch_groups import A, ARCH, CATCH_ALL, POLICY, TWO_GROUPS, _run_kw
from test_torch_wire_trajectory import FLIP_SHARE, QUANTA, _quantum

torch.set_num_threads(1)  # xdist workers share the cores

SEQ, STEPS = 16, 3


@pytest.fixture
def reference_encodes(monkeypatch):
    """Each wired group's payload encoded before the reference's engines
    see it (see ``test_torch_groups.py``)."""
    orig = jmix.make_schedule_mixer

    def with_encode(sched, engine="shifts", *args, wire=None, **kw):
        inner = orig(sched, engine, *args, wire=wire, **kw)
        if wire is None or wire.fmt == "f32":
            return inner
        return lambda tree, step=0: inner(wire.encode(tree), step)

    monkeypatch.setattr(jmix, "make_schedule_mixer", with_encode)


def test_grouped_trajectory_matches_reference(reference_encodes):
    jmodel = jbuild_model(get_smoke_config(ARCH))
    jrun = JRunConfig(**_run_kw(POLICY))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jstep = jax.jit(jbuild_train_step(
        jmodel, jrun, jmake_gossip_schedule(jrun, A), use_fused_kernel=True,
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    data = JSyntheticLM(vocab_size=jmodel.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(POLICY))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    state = weights.train_state_from_arrays(jax.tree.map(np.array, jstate))
    assert state["params"].shape[1] == bus_layout_for(
        model, A, resolve_features(run).groups).rows
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, {"tokens": torch.from_numpy(
            np.array(batch["tokens"]))})
        for k in ("loss", "consensus"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {t} {k}")
    layout = bus_layout_for(model, A, resolve_features(run).groups)
    x = np.asarray(jstate["params"])
    pairs = [("params", state["params"], x)] + [
        (k, state["opt"][k], np.asarray(jstate["opt"][k]))
        for k in ("m", "psi")]
    for name, got, want in pairs:
        got = got.numpy()
        for g in layout.groups:
            rows = slice(g.row, g.row + g.rows)
            if g.wire == "f32":
                np.testing.assert_allclose(got[:, rows], want[:, rows],
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{name} {g.name}")
                continue
            # the payload φ ≈ x carries x's magnitude: its quantum bounds
            bound = QUANTA * _quantum(x[:, rows], g.wire, w_max=0.5) + 1e-5
            diff = np.abs(got[:, rows] - want[:, rows])
            assert np.all(diff <= bound), (name, g.name,
                                           (diff / bound).max())
            assert np.mean(diff > 1e-5) <= FLIP_SHARE, (name, g.name)


def _port_leaves(groups, fused=True, steps=STEPS):
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(groups))
    layout = bus_layout_for(model, A, resolve_features(run).groups)
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=fused, device="cpu")
    state = init_state(model, run, A, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(steps):
        tokens = rng.integers(0, model.cfg.vocab_size, size=(A, 1, SEQ))
        state, _ = step(state, {"tokens": torch.from_numpy(tokens)})
    buses = {"params": state["params"], **state["opt"]}
    return {k: tbus.unpack_tree(layout, buses[k])
            for k in ("params", "m", "psi")}


@pytest.mark.parametrize("fused", [False, True])
def test_default_catch_all_and_two_group_trajectories_bit_equal(fused):
    ref = _port_leaves("", fused)
    for groups in (CATCH_ALL, TWO_GROUPS):
        got = _port_leaves(groups, fused)
        for k in ref:
            for p, v in ref[k].items():
                assert torch.equal(got[k][p], v), (groups, k, p)


def test_grouped_step_keys_per_gossiping_group():
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(POLICY))
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    keys = [step.static.key(t) for t in range(6)]
    # attn (ring), ffn (every other step), norm (round_robin, period 2)
    assert keys[0] == ((True, 0), (False, -1), (True, 0))
    assert keys[1] == ((True, 0), (True, 0), (True, 1))
    assert keys[2:] == keys[:2] * 2
    assert len(set(keys)) == 2


def test_cli_gossip_groups_from_file(tmp_path, capsys):
    path = tmp_path / "groups.json"
    path.write_text(POLICY)
    res = tcli.main(["--device", "cpu", "--arch", ARCH, "--smoke",
                     "--steps", "2", "--agents", str(A), "--seq", str(SEQ),
                     "--agents-per-device", str(A), "--gossip-engine",
                     "ppermute", "--fused-kernel", "--gossip-groups",
                     f"@{path}"])
    out = capsys.readouterr().out
    assert "groups=embed:2048r/k0/f32" in out
    assert "group ffn: rows" in out
    for m in res["metrics"]:
        assert all(np.isfinite(v) for v in m.values())
    model = build_model(tget_smoke_config(ARCH))
    run = RunConfig(**_run_kw(POLICY))
    layout = bus_layout_for(model, A, resolve_features(run).groups)
    plans = make_group_plans(run, layout, make_gossip_schedule(run, A))
    want = [group_wire_bytes_per_step(
        layout.groups, {p.group.name: p.sched for p in plans if p.sched}, t,
        codecs={p.group.name: p.wire for p in plans if p.wire})
        for t in range(2)]
    for g in res["groups"]:
        k, name = g["gossip_every"], g["name"]
        # the bytes of the group's first gossiping step, t = k − 1
        assert g["wire_bytes"] == (want[k - 1][name] if k else 0), name
        assert g["gossip_steps"] == sum(bool(w[name]) for w in want), name
    by_name = {g["name"]: (g["wire_bytes"], g["gossip_steps"])
               for g in res["groups"]}
    assert by_name["embed"] == (0, 0) and by_name["ffn"][1] == 1 and \
        by_name["ffn"][0] == want[1]["ffn"] > 0
