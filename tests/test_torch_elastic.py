"""The port's elastic gossip (``repro_torch.core.elastic``, masked rounds in
the mixing engines, churn in the trainer) against the JAX package's.

* ``DropPlan``: the JSON of either package loads in the other, and
  ``to_json`` / ``random`` give the reference's plans.
* ``degrade_round``: dense matrices, terms, source and weight tables and
  wire rows equal to the reference's (exactly) on a ring-8 tail drop
  (which is ring-6 on the survivors), seeded random masks, the exp graph,
  hierarchical and torus rounds and the round-robin rounds.
* ``ElasticSchedule``: rounds, round index, ``epoch_stats`` and the
  Assumption-1 check equal to the reference's; the wire-byte model under
  masking equal for every engine, blocking and codec.
* Masked engines, f32: ``shifts`` and the one-device ``ppermute`` engine
  (plain, and fused: the table kernel's plain version) bit-equal to the
  reference's ``mix_shifts`` and to its ppermute engine on a 1-device mesh
  (``make_gossip_mesh(A, agents_per_device=A)``, its gather route), and
  within rtol 1e-6 / atol 1e-7 of its ``mix_dense`` (a matmul sums in
  another order); the port's ``dense`` within the same of the reference's.
  bf16 payloads within 2⁻⁶ (a few bf16 ulps, as ``test_torch_mixing.py``
  states why).  Wire payloads (int8 and bf16): the plain ppermute combine
  bit-equal to the reference's (decode, then gather), the fused one
  within 1e-6 relative: the q8 combine takes (w·scale)·q where the
  reference takes w·(q·scale).
* The table kernel's plain version equals the reference's gather route
  bit for bit, Inf and NaN included.
* Churn in the trainer: a 4-agent run whose agent 3 drops at step 2 and
  rejoins at step 4 agrees with the reference's at every step (loss,
  consensus, grad norm within rtol 1e-5; final buses within rtol 1e-5,
  atol 1e-6: the f32 drift of ``test_torch_train.py``); a run
  checkpointed at the drop and resumed at 3 agents is bit-equal on the
  survivors to the uninterrupted run, and the grow back to 4 agents equals
  the reference's resize of the same file; the train CLI runs ``--churn``
  and ``--resume`` across agent counts.

Inputs are made with numpy from seeds and fed to both packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import elastic as jel
from repro.core import mixing as jmix
from repro.core import schedule as jsched
from repro.core import topology as jtopo
from repro.core.wire import make_codec as jmake_codec
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import bus_layout_for as jbus_layout_for
from repro.train import checkpoint as jckpt
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import elastic as tel
from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core.wire import make_codec
from repro_torch.kernels import ref
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule)

torch.set_num_threads(1)  # xdist workers share the cores


def _pair(name, *args):
    return getattr(ttopo, name)(*args), getattr(jtopo, name)(*args)


# ---------------------------------------------------------------------------
# DropPlan
# ---------------------------------------------------------------------------

def test_drop_plan_json_round_trip(tmp_path):
    events = [(0, []), (8, [3, 5]), (16, [1])]
    tp, jp = tel.DropPlan.from_events(8, events), \
        jel.DropPlan.from_events(8, events)
    assert tp.to_json() == jp.to_json()
    assert tp.epochs == jp.epochs and tp.starts == jp.starts
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(jp.to_json()))
    for spec in (str(path), json.dumps(jp.to_json()), jp.to_json()):
        assert tel.DropPlan.from_json(spec) == tp
    assert jel.DropPlan.from_json(json.dumps(tp.to_json())).epochs == tp.epochs
    alive = {"n_agents": 4, "epochs": [{"start": 0, "alive": [1, 1, 0, 1]}]}
    assert tel.DropPlan.from_json(alive).epochs == \
        jel.DropPlan.from_json(alive).epochs
    for step in (0, 7, 8, 15, 16, 99):
        assert tp.epoch_index(step) == jp.epoch_index(step)
        np.testing.assert_array_equal(tp.alive_at(step), jp.alive_at(step))
    np.testing.assert_array_equal(tp.always_alive(), jp.always_alive())
    for seed in (0, 13):
        assert tel.DropPlan.random(16, 0.3, seed=seed).epochs == \
            jel.DropPlan.random(16, 0.3, seed=seed).epochs
    for bad in ([(1, [])], [(0, []), (0, [1])], [(0, [0, 1, 2, 3])]):
        with pytest.raises(ValueError):
            tel.DropPlan.from_events(4, bad)


# ---------------------------------------------------------------------------
# degrade_round, ElasticSchedule, wire bytes
# ---------------------------------------------------------------------------

def _round_cases():
    rng = np.random.default_rng(0)
    cases = [(("ring", 8), [1] * 6 + [0, 0])]
    for name, args in (("ring", (8,)), ("exp_graph", (16,)),
                       ("exp_graph", (8,)), ("hierarchical", (2, 8)),
                       ("torus2d", (2, 4)), ("fully_connected", (5,))):
        n = int(np.prod(args))
        for _ in range(3):
            alive = rng.random(n) < 0.6
            alive[rng.integers(n)] = True
            cases.append(((name,) + args, alive.astype(int).tolist()))
    return cases


def _same_round(tr, jr):
    np.testing.assert_array_equal(tr.dense_matrix(), jr.dense_matrix())
    assert tr.name == jr.name and tr.n_agents == jr.n_agents
    assert [(t.level, t.shift, t.weight) for t in tr.terms] == \
        [(t.level, t.shift, t.weight) for t in jr.terms]
    for tt, jt in zip(tr.terms, jr.terms):
        np.testing.assert_array_equal(tr.term_sources(tt),
                                      jr.term_sources(jt))
    assert tel.is_masked(tr) == jmix._is_masked(jr)
    if tel.is_masked(tr):
        assert tr.sources == jr.sources and tr.weights == jr.weights
        assert tr.alive == jr.alive
        for B in (1, 2) if tr.n_agents % 2 == 0 else (1,):
            for engine in ("ppermute", "dense", "shifts"):
                assert tr.wire_rows(B, engine) == jr.wire_rows(B, engine)
        np.testing.assert_allclose(tr.lam(), jr.lam(), atol=1e-12)


@pytest.mark.parametrize("topo,alive", _round_cases())
def test_degrade_round_matches_reference(topo, alive):
    tt, jt = _pair(*topo)
    _same_round(tel.degrade_round(tt, alive), jel.degrade_round(jt, alive))
    # the healthy round passes through as itself
    assert tel.degrade_round(tt, [1] * tt.n_agents) is tt


def test_ring8_tail_drop_is_ring6_and_round_robin_rounds():
    W = tel.degrade_round(ttopo.ring(8), [1] * 6 + [0, 0]).dense_matrix()
    np.testing.assert_array_equal(W[:6, :6], ttopo.ring(6).dense_matrix())
    np.testing.assert_array_equal(W[6:, 6:], np.eye(2))
    alive = [1, 0, 1, 1, 1, 0, 1, 1]
    for tr, jr in zip(tsched.RoundRobinExp(8).rounds,
                      jsched.RoundRobinExp(8).rounds):
        _same_round(tel.degrade_round(tr, alive),
                    jel.degrade_round(jr, alive))


def _schedules():
    out = []
    for name, tb, jb in (
            ("ring8", tsched.StaticSchedule(ttopo.ring(8)),
             jsched.StaticSchedule(jtopo.ring(8))),
            ("exp16", tsched.StaticSchedule(ttopo.exp_graph(16)),
             jsched.StaticSchedule(jtopo.exp_graph(16))),
            ("hier2x8", tsched.StaticSchedule(ttopo.hierarchical(2, 8)),
             jsched.StaticSchedule(jtopo.hierarchical(2, 8))),
            ("rr8", tsched.RoundRobinExp(8), jsched.RoundRobinExp(8)),
            ("alt2x4", tsched.AlternatingHierarchical(2, 4),
             jsched.AlternatingHierarchical(2, 4))):
        out.append(pytest.param(tb, jb, id=name))
    return out


@pytest.mark.parametrize("tbase,jbase", _schedules())
def test_elastic_schedule_matches_reference(tbase, jbase):
    kw = dict(seed=13, n_epochs=4, epoch_len=jbase.period)
    tplan = tel.DropPlan.random(tbase.n_agents, 0.25, **kw)
    jplan = jel.DropPlan.random(jbase.n_agents, 0.25, **kw)
    ts, js = tel.ElasticSchedule(tbase, tplan), jel.ElasticSchedule(jbase,
                                                                    jplan)
    assert ts.name == js.name and ts.period == js.period
    for tr, jr in zip(ts.rounds, js.rounds):
        _same_round(tr, jr)
    for step in range(3 * ts.period):
        assert ts.round_index(step) == int(js.round_index(step))
    for te, je in zip(ts.epoch_stats(), js.epoch_stats()):
        assert te.keys() == je.keys()
        assert (te["epoch"], te["start"], te["alive"]) == \
            (je["epoch"], je["start"], je["alive"])
        np.testing.assert_allclose(te["lambda"], je["lambda"], atol=1e-12)
    tstats, jstats = ts.product_spectral_stats(), js.product_spectral_stats()
    assert tstats.keys() == jstats.keys()
    assert tstats["permutes_per_step"] == jstats["permutes_per_step"]
    ts.check_assumption1()
    js.check_assumption1()
    # the wire-byte model under masking
    elems = 512 * 128
    for step in range(0, 4 * ts.period, max(1, ts.period // 2)):
        for engine in ("ppermute", "shifts", "dense"):
            for B in (1, 2, 4):
                for fmt in (None, "bf16", "int8"):
                    tc = None if fmt is None else make_codec(fmt, 8)
                    jc = None if fmt is None else jmake_codec(fmt, 8)
                    assert tsched.wire_bytes_per_step(
                        ts, step, elems_per_agent=elems, agents_per_device=B,
                        engine=engine, codec=tc) == \
                        jsched.wire_bytes_per_step(
                            js, step, elems_per_agent=elems,
                            agents_per_device=B, engine=engine, codec=jc), \
                        (step, engine, B, fmt)


def test_elastic_schedule_rejects_bad_plans():
    with pytest.raises(ValueError, match="align"):
        tel.ElasticSchedule(tsched.RoundRobinExp(8),
                            tel.DropPlan.from_events(8, [(0, []), (1, [2])]))
    with pytest.raises(ValueError):
        tel.ElasticSchedule(tsched.StaticSchedule(ttopo.ring(4)),
                            tel.DropPlan.from_events(8, [(0, [])]))
    with pytest.raises(AssertionError, match="contracting"):
        # a survivor pair that never meets: exp round of offset 2 on 4
        sched = tsched.StaticSchedule(ttopo.Topology(
            "pairs", 4, (ttopo.ShiftTerm("flat", 0, 0.5),
                         ttopo.ShiftTerm("flat", 2, 0.5))))
        tel.ElasticSchedule(sched, tel.DropPlan.from_events(
            4, [(0, [])])).check_assumption1()


# ---------------------------------------------------------------------------
# masked engines
# ---------------------------------------------------------------------------

MASKED = [(("ring", 8), [1, 0, 1, 1, 0, 1, 1, 1]),
          (("exp_graph", 8), [1, 1, 1, 1, 1, 0, 0, 1]),
          (("hierarchical", 2, 4), [0, 1, 1, 1, 1, 0, 1, 1])]


def _x(A, dtype, seed):
    x = np.random.default_rng(seed).normal(size=(A, 16, 128)).astype(
        np.float32)
    return (jnp.asarray(x, dtype),
            torch.from_numpy(x).to(getattr(torch, jnp.dtype(dtype).name)))


def _bits(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("topo,alive", MASKED)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_masked_engines_match_reference(topo, alive, dtype):
    tt, jt = _pair(*topo)
    tr, jr = tel.degrade_round(tt, alive), jel.degrade_round(jt, alive)
    A = tt.n_agents
    jx, tx = _x(A, dtype, seed=sum(alive))
    jdense = jmix.mix_dense(jr, jx)
    got = {"dense": tmix.mix_dense(tr, tx), "shifts": tmix.mix_shifts(tr, tx)}
    for fused in (False, True):
        got[f"ppermute fused={fused}"] = tmix.make_mixer(
            tr, "ppermute", agents_per_device=A,
            use_fused_kernel=fused)(tx)
    tol = dict(rtol=1e-6, atol=1e-7) if dtype == jnp.float32 else \
        dict(rtol=2 ** -6, atol=2 ** -6)
    for name, val in got.items():
        assert val.dtype == tx.dtype, name
        np.testing.assert_allclose(val.float().numpy(),
                                   np.asarray(jdense, np.float32), **tol,
                                   err_msg=name)
    if dtype == jnp.float32:
        # the gather route, the plain and the table combine: the same sums
        mesh = make_gossip_mesh(A, agents_per_device=A)
        jpp = jmix.mix_ppermute(jr, mesh, gossip_agent_axes(mesh), jx)
        _bits(got["shifts"], jmix.mix_shifts(jr, jx))
        for fused in (False, True):
            _bits(got[f"ppermute fused={fused}"], jpp)
    else:
        # the plain route rounds every product and sum to bf16 on both sides
        # (the reference's 1-device ppermute engine takes this same route)
        np.testing.assert_allclose(got["ppermute fused=False"].float().numpy(),
                                   np.asarray(jmix.mix_shifts(jr, jx),
                                              np.float32), **tol)


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_masked_wire_engines_match_reference(fmt):
    tt, jt = _pair("ring", 8)
    alive = [1, 1, 0, 1, 1, 1, 0, 1]
    tr, jr = tel.degrade_round(tt, alive), jel.degrade_round(jt, alive)
    x = np.random.default_rng(5).normal(size=(8, 48, 128)).astype(np.float32)
    tc, jc = make_codec(fmt, 16), jmake_codec(fmt, 16)
    tpay, jpay = tc.encode(torch.from_numpy(x)), jc.encode(jnp.asarray(x))
    mesh = make_gossip_mesh(8, agents_per_device=8)
    want = np.asarray(jmix.mix_ppermute(jr, mesh, gossip_agent_axes(mesh),
                                        jpay, wire=jc))
    plain = tmix.make_mixer(tr, "ppermute", agents_per_device=8,
                            wire=tc)(tpay)
    np.testing.assert_array_equal(plain.numpy(), want)
    fused = tmix.make_mixer(tr, "ppermute", agents_per_device=8,
                            use_fused_kernel=True, wire=tc)(tpay)
    assert fused.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-6, atol=1e-7)
    for engine in ("dense", "shifts"):
        got = tmix.make_mixer(tr, engine, wire=tc)(tpay)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_table_combine_plain_is_the_gather_route():
    """``ref.table_combine_ref`` on a masked round's tables equals the
    reference's gather route (``mix_shifts``) bit for bit, with NaN and
    ±Inf in the payload, in f32; a bf16 payload rounds once to bf16 (f32
    accumulation, as the combine kernel)."""
    tt, jt = _pair("exp_graph", 8)
    alive = [1, 1, 1, 0, 1, 1, 0, 1]
    tr, jr = tel.degrade_round(tt, alive), jel.degrade_round(jt, alive)
    x = np.random.default_rng(2).normal(size=(8, 3, 128)).astype(np.float32)
    x[1, 0, 5], x[4, 2, 7], x[6, 1, 9] = np.nan, np.inf, -np.inf
    src, w = tmix.round_tables(tr)
    got = ref.table_combine_ref(torch.from_numpy(x), torch.from_numpy(src),
                                torch.from_numpy(w))
    _bits(got, jmix.mix_shifts(jr, jnp.asarray(x)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got_b = ref.table_combine_ref(xb, torch.from_numpy(src),
                                  torch.from_numpy(w),
                                  out_dtype=torch.float32)
    _bits(got_b, jmix.mix_shifts(jr, jnp.asarray(xb.float().numpy())))


# ---------------------------------------------------------------------------
# churn in the trainer
# ---------------------------------------------------------------------------

A, SEQ = 4, 16
CHURN = [(0, []), (2, [3]), (4, [])]


def _run_kw(n=A, **kw):
    base = dict(global_batch=n, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=n,
                topology="ring", remat=False)
    base.update(kw)
    return base


def _tokens(steps, n=A, seed=100):
    rng = np.random.default_rng(seed)
    vocab = get_smoke_config("smollm_360m").vocab_size
    return [rng.integers(0, vocab, size=(n, 1, SEQ)).astype(np.int32)
            for _ in range(steps)]


def test_churn_trajectory_matches_reference():
    steps = 6
    kw = _run_kw()
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    jplan = jel.DropPlan.from_events(A, CHURN)
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jstep = jax.jit(jbuild_train_step(
        jmodel, jrun, jmake_gossip_schedule(jrun, A, churn=jplan),
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, jstate)
    model = build_model(tget_smoke_config("smollm_360m"))
    sched = make_gossip_schedule(run, A, churn=json.dumps(
        tel.DropPlan.from_events(A, CHURN).to_json()))
    assert sched.name == "elastic(static(ring))"
    step = build_train_step(model, run, sched, use_fused_kernel=True,
                            device="cpu")
    state = weights.train_state_from_arrays(init)
    for t, tokens in enumerate(_tokens(steps)):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {t} {k}")
    pairs = [("params", state["params"], jstate["params"])] + [
        (k, state["opt"][k], jstate["opt"][k]) for k in ("m", "psi")]
    for name, got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _port_steps(model, run, sched, state, tokens, fused=True):
    step = build_train_step(model, run, sched, use_fused_kernel=fused,
                            device="cpu")
    for tok in tokens:
        state, _ = step(state, {"tokens": torch.from_numpy(tok)})
    return state


def test_resumed_churn_trajectory_matches_uninterrupted(tmp_path):
    """Agent 3 drops at step 2 for good: the 4-agent run checkpointed at
    the drop and resumed at 3 agents (the degraded ring(4) on its 3
    survivors is ring(3)) is bit-equal on the survivors to the
    uninterrupted run; the grow back to 4 equals the reference's resize of
    the same file."""
    model = build_model(tget_smoke_config("smollm_360m"))
    layout = bus_layout_for(model, A)
    run4, run3 = RunConfig(**_run_kw()), RunConfig(**_run_kw(3))
    tokens = _tokens(4)
    sched4 = make_gossip_schedule(
        run4, A, churn=tel.DropPlan.from_events(A, [(0, []), (2, [3])]))
    full = init_state(model, run4, A, device="cpu")
    full = _port_steps(model, run4, sched4, full, tokens[:2])
    path = str(tmp_path / "drop.npz")
    checkpoint.save_state(path, full, layout=layout)
    full = _port_steps(model, run4, sched4, full, tokens[2:])

    like3 = init_state(model, run3, 3, device="cpu")
    res = checkpoint.load_state_resized(path, like3, layout=layout)
    assert res["step"] == 2
    res = _port_steps(model, run3, make_gossip_schedule(run3, 3), res,
                      [t[:3] for t in tokens[2:]])
    assert torch.equal(res["params"], full["params"][:3])
    for k in ("m", "psi"):
        assert torch.equal(res["opt"][k], full["opt"][k][:3]), k

    # the grow leg: 3 → 4, against the reference's resize of the same file
    path3 = str(tmp_path / "three.npz")
    checkpoint.save_state(path3, res, layout=layout)
    grown = checkpoint.load_state_resized(path3, init_state(
        model, run4, A, device="cpu"), layout=layout)
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    jrun = JRunConfig(**_run_kw())
    jgrown = jckpt.load_state_resized(
        path3, jinit_state(jmodel, jrun, A, jax.random.PRNGKey(0)),
        layout=jbus_layout_for(jmodel, A))
    np.testing.assert_array_equal(grown["params"].numpy(),
                                  np.asarray(jgrown["params"]))
    for k in ("m", "psi"):
        np.testing.assert_array_equal(grown["opt"][k].numpy(),
                                      np.asarray(jgrown["opt"][k]))
    assert torch.equal(grown["params"][:3], res["params"])
    assert torch.equal(grown["opt"]["psi"][3], grown["params"][3])
    assert not grown["opt"]["m"][3].any()


def test_train_cli_churn_and_resume_across_agent_counts(tmp_path, capsys):
    plan = json.dumps(tel.DropPlan.from_events(A, CHURN).to_json())
    base = ["--device", "cpu", "--arch", "smollm_360m", "--smoke", "--seq",
            str(SEQ), "--gossip-engine", "ppermute", "--fused-kernel"]
    ckpt = str(tmp_path / "churn.npz")
    res = tcli.main(base + ["--agents", "4", "--agents-per-device", "4",
                            "--steps", "3", "--churn", plan, "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "schedule=elastic(static(ring))" in out
    assert [e["alive"] for e in res["epochs"]] == [4, 3, 4]
    assert res["epochs"][1]["wire_bytes"][1] < res["epochs"][0][
        "wire_bytes"][1]
    assert all(np.isfinite(v) for m in res["metrics"] for v in m.values())
    res3 = tcli.main(base + ["--agents", "3", "--agents-per-device", "3",
                             "--steps", "1", "--resume", ckpt])
    assert f"resumed <- {ckpt} @ step 3" in capsys.readouterr().out
    assert res3["state"]["step"] == 4
    assert res3["state"]["params"].shape[0] == 3


def test_tree_path_churn_table_kernel_matches_dense_engine():
    """The tree path under churn: the fused one-device ppermute engine (the
    table kernel's plain version, once per leaf) against the dense engine
    (each degraded round's matrix), 3 dsgd steps over the drop and the
    rejoin, within rtol 1e-5 / atol 1e-6 (a matmul sums in another
    order)."""
    model = build_model(tget_smoke_config("smollm_360m"))
    states = {}
    for engine in ("ppermute", "dense"):
        run = RunConfig(**_run_kw(algorithm="dsgd", packed_bus=False,
                                  gossip_engine=engine))
        sched = make_gossip_schedule(run, A, churn=tel.DropPlan.from_events(
            A, [(0, []), (1, [0]), (2, [])]))
        state = init_state(model, run, A, device="cpu")
        states[engine] = _port_steps(model, run, sched, state, _tokens(3))
    for path, leaf in states["ppermute"]["params"].items():
        np.testing.assert_allclose(leaf.numpy(),
                                   states["dense"]["params"][path].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=path)
