"""The port's overlapped gossip pipeline (``make_overlap_mixer``, the
pipeline slots, the delayed train step, straggler plans and pipeline
checkpoints) against the JAX package's.

* Mixer, f32: the port's ``complete(issue(x))`` — ppermute on one device,
  plain and fused (the ring kernel's or the table kernel's plain version),
  and dense — within rtol 1e-6 / atol 1e-7 of the reference's **dense**
  overlap engine with ``late=`` (its per-term W_eff oracle, a matmul: it
  sums in another order) at every step of a static ring, the round-robin
  exp schedule, a churned schedule (masked rounds) and a schedule whose
  rounds differ in arity (weight-0 pad slots).  The reference's ppermute
  overlap mixer asserts one agent per device under masking, so it is no
  oracle there; on the unmasked schedules, on its 1-device mesh, it is
  one bit for bit: NaN and ±Inf payloads (0·Inf in a pad slot is NaN),
  late slots, and the int8 and bf16 wires (plain combine; the fused one
  within 1e-6 relative: (w·scale)·q against w·(q·scale)).  A NaN row read
  only through late slots reaches no other agent's output.
* ``StragglerPlan.late_at`` equal to the reference's, on the host or as a
  tensor.
* Train step, 4 agents, the smoke ``smollm_360m``, 5 steps, against the
  reference's ``build_train_step(overlap="delayed")`` (its ppermute
  engine on a 1-device mesh, plain combine): f32 and a straggler plan
  per step within rtol 1e-5, atol 1e-9 (loss, consensus, grad norm: at
  step 0 the port's consensus is exactly 0, XLA leaves ~1e-11) and the final
  buses within rtol 1e-5, atol 1e-6 (the f32 drift of
  ``test_torch_train.py``); the int8 wire per step within rtol 1e-3 and
  the buses within the quanta bound of ``test_torch_wire_trajectory.py``
  (an EF encode differs in its last bits, so a few values within an ulp
  of a rounding tie quantize one step apart).  Step 0 is the synchronous
  step bit for bit; ``overlap="off"`` is the synchronous step.
* Pipeline checkpoints: either package's file loads in the other (odd
  parity, int8 residual) and saves back to the same bytes; a resumed run
  is bit-equal to the uninterrupted one (through the train CLI too);
  ``resize_state`` / ``load_state_resized`` equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import bus as jbus
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
from repro_torch.core import bus as tbus
from repro_torch.core import elastic as tel
from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core.wire import make_codec
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule)

from test_torch_wire_trajectory import FLIP_SHARE, QUANTA, _quantum

torch.set_num_threads(1)  # xdist workers share the cores


def test_pipeline_slot_semantics():
    x = torch.arange(2 * 8 * 128, dtype=torch.float32).view(2, 8, 128)
    pipe = tbus.make_pipeline(x)
    assert pipe["parity"] == 0 and tuple(pipe["slot"].shape) == (2, 2, 8, 128)
    assert torch.equal(tbus.pipeline_payload(pipe), x)
    assert not pipe["slot"][1].any()
    nxt = tbus.pipeline_advance(pipe, x + 1)
    assert nxt["parity"] == 1 and torch.equal(tbus.pipeline_payload(nxt),
                                              x + 1)
    assert torch.equal(tbus.pipeline_spare(nxt), x)       # the dead slot
    jpipe = jbus.pipeline_advance(jbus.make_pipeline(jnp.asarray(x.numpy())),
                                  jnp.asarray((x + 1).numpy()))
    np.testing.assert_array_equal(nxt["slot"].numpy(),
                                  np.asarray(jpipe["slot"]))
    assert int(jpipe["parity"]) == nxt["parity"]


# ---------------------------------------------------------------------------
# the overlap mixer
# ---------------------------------------------------------------------------

def _mixed_arity(pkg):
    """Rounds of arity 3 (ring) and 2 (one-peer exp): round 1 pads."""
    rounds = (pkg[1].ring(8),) + pkg[2].RoundRobinExp(8).rounds[:2]
    return pkg[2].GossipSchedule("mixed", 8, rounds)


PORT, REF = (None, ttopo, tsched), (None, jtopo, jsched)


def _schedules():
    plan = [(0, []), (2, [2, 5])]
    return {
        "ring4": (tsched.StaticSchedule(ttopo.ring(4)),
                  jsched.StaticSchedule(jtopo.ring(4))),
        "round_robin8": (tsched.RoundRobinExp(8), jsched.RoundRobinExp(8)),
        "mixed_arity8": (_mixed_arity(PORT), _mixed_arity(REF)),
        "churn8": (tel.ElasticSchedule(tsched.StaticSchedule(ttopo.ring(8)),
                                       tel.DropPlan.from_events(8, plan)),
                   jel.ElasticSchedule(jsched.StaticSchedule(jtopo.ring(8)),
                                       jel.DropPlan.from_events(8, plan))),
    }


def _lates(K, rng):
    out = [None, np.zeros(K, bool)]
    for _ in range(2):
        late = rng.random(K) < 0.5
        late[rng.integers(K)] = True
        out.append(late)
    return out


@pytest.mark.parametrize("name", list(_schedules()))
def test_overlap_mixer_matches_reference_dense(name):
    tsch, jsch = _schedules()[name]
    A = tsch.n_agents
    rng = np.random.default_rng(3)
    x = rng.normal(size=(A, 8, 128)).astype(np.float32)
    tx = torch.from_numpy(x)
    jissue, jcomplete = jmix.build_mixer(jsch, mode="overlap",
                                         engine="dense")
    mixers = {"dense": tmix.build_mixer(tsch, mode="overlap", engine="dense")}
    for fused in (False, True):
        mixers[f"ppermute fused={fused}"] = tmix.build_mixer(
            tsch, mode="overlap", engine="ppermute", agents_per_device=A,
            use_fused_kernel=fused)
    K = jcomplete.n_terms
    for step in range(3):
        for late in _lates(K, rng):
            jl = None if late is None else jnp.asarray(late)
            want = np.asarray(jcomplete(jissue(jnp.asarray(x), step), step,
                                        late=jl))
            for mname, (issue, complete) in mixers.items():
                assert complete.n_terms == K
                got = complete(issue(tx, step), step, late=late)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=1e-6, atol=1e-7,
                    err_msg=f"{mname} step {step} late {late}")
    with pytest.raises(ValueError, match="straggler"):
        tmix.build_mixer(tsch, mode="overlap", engine="shifts")[1](
            tx, 0, late=np.ones(K, bool))


@pytest.mark.parametrize("name", ["ring4", "mixed_arity8"])
def test_overlap_mixer_bit_equal_to_reference_ppermute(name):
    """Unmasked schedules: the reference's ppermute overlap mixer on its
    1-device mesh stacks and combines what the port reads in place — the
    same sums bit for bit, with NaN / ±Inf, pads and late slots."""
    tsch, jsch = _schedules()[name]
    A = tsch.n_agents
    rng = np.random.default_rng(4)
    x = rng.normal(size=(A, 8, 128)).astype(np.float32)
    x[0, 1, 2], x[1, 3, 4], x[A - 1, 5, 6] = np.nan, np.inf, -np.inf
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jissue, jcomplete = jmix.build_mixer(
        jsch, mode="overlap", engine="ppermute", mesh=mesh,
        agent_axes=gossip_agent_axes(mesh))
    K = jcomplete.n_terms
    jmix_at = jax.jit(lambda p, step, late: jcomplete(jissue(p, step), step,
                                                      late=late),
                      static_argnums=1)
    mixers = [tmix.build_mixer(tsch, mode="overlap", engine="ppermute",
                               agents_per_device=A, use_fused_kernel=fused)
              for fused in (False, True)]
    for issue, complete in mixers:
        assert complete.self_index == tuple(
            next((k for k, t in enumerate(r.terms) if t.shift == 0),
                 len(r.terms)) for r in jsch.rounds)
    for step in range(jsch.period):
        for late in _lates(K, np.random.default_rng(step))[1:]:
            want = np.asarray(jmix_at(jnp.asarray(x), step,
                                      jnp.asarray(late)))
            for fused, (issue, complete) in enumerate(mixers):
                got = complete(issue(torch.from_numpy(x), step), step,
                               late=late)
                np.testing.assert_array_equal(
                    got.numpy(), want, err_msg=f"fused {fused} step {step}")


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_overlap_wire_mixer_matches_reference(fmt):
    tsch, jsch = _schedules()["mixed_arity8"]
    x = np.random.default_rng(6).normal(size=(8, 32, 128)).astype(np.float32)
    tc, jc = make_codec(fmt, 16), jmake_codec(fmt, 16)
    tpay, jpay = tc.encode(torch.from_numpy(x)), jc.encode(jnp.asarray(x))
    mesh = make_gossip_mesh(8, agents_per_device=8)
    jissue, jcomplete = jmix.build_mixer(
        jsch, mode="overlap", engine="ppermute", mesh=mesh,
        agent_axes=gossip_agent_axes(mesh), wire=jc)
    jmix_at = jax.jit(lambda p, step, late: jcomplete(jissue(p, step), step,
                                                      late=late),
                      static_argnums=1)
    mixers = [tmix.build_mixer(tsch, mode="overlap", engine="ppermute",
                               agents_per_device=8, use_fused_kernel=fused,
                               wire=tc) for fused in (False, True)]
    # round 0 (the ring) and round 1 (one peer, a pad slot), slot 1 late
    for step, late in ((0, np.zeros(3, bool)), (1, np.array([0, 1, 0],
                                                            bool))):
        want = np.asarray(jmix_at(jpay, step, jnp.asarray(late)))
        for fused, (issue, complete) in enumerate(mixers):
            got = complete(issue(tpay, step), step, late=late)
            assert got.dtype == torch.float32
            if fused:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-7)
            else:
                np.testing.assert_array_equal(got.numpy(), want)


def test_late_slot_never_multiplies_the_late_row():
    """A row read only through late slots holds NaN: every output that
    reached it only that way stays finite and equals the reference's."""
    tsch, jsch = _schedules()["ring4"]
    x = np.random.default_rng(8).normal(size=(4, 8, 128)).astype(np.float32)
    x[2] = np.nan                     # agent 2: read by 1 (slot 2), 3 (slot 1)
    late = np.array([False, True, True])   # both neighbour slots late
    mesh = make_gossip_mesh(4, agents_per_device=4)
    jissue, jcomplete = jmix.build_mixer(
        jsch, mode="overlap", engine="ppermute", mesh=mesh,
        agent_axes=gossip_agent_axes(mesh))
    want = np.asarray(jcomplete(jissue(jnp.asarray(x), 0), 0,
                                late=jnp.asarray(late)))
    for fused in (False, True):
        issue, complete = tmix.build_mixer(
            tsch, mode="overlap", engine="ppermute", agents_per_device=4,
            use_fused_kernel=fused)
        got = complete(issue(torch.from_numpy(x), 0), 0, late=late).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.isfinite(got[[0, 1, 3]]).all() and np.isnan(got[2]).all()
        np.testing.assert_array_equal(got[[0, 1, 3]], x[[0, 1, 3]])


def test_straggler_plan_late_at_matches_reference():
    late = ((1, (1,)), (3, (0, 2)))
    tp, jp = tel.StragglerPlan(3, late), jel.StragglerPlan(3, late)
    for step in range(6):
        want = np.asarray(jp.late_at(step))
        np.testing.assert_array_equal(tp.late_at(step), want)
        got = tp.late_at(step, device="cpu")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tel.StragglerPlan(3, ((0, (3,)),))


# ---------------------------------------------------------------------------
# the delayed train step
# ---------------------------------------------------------------------------

A, SEQ, STEPS = 4, 16, 5
LATE = ((1, (1,)), (2, (1, 2)))


def _run_kw(**kw):
    base = dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                topology="ring", remat=False, overlap="delayed")
    base.update(kw)
    return base


def _tokens(steps=STEPS, seed=200):
    rng = np.random.default_rng(seed)
    vocab = get_smoke_config("smollm_360m").vocab_size
    return [rng.integers(0, vocab, size=(A, 1, SEQ)).astype(np.int32)
            for _ in range(steps)]


def _jax_run(kw, tokens, late=None):
    jrun = JRunConfig(**kw)
    model = jbuild_model(get_smoke_config("smollm_360m"))
    mesh = make_gossip_mesh(A, agents_per_device=A)
    plan = None if late is None else jel.StragglerPlan(3, late)
    step = jax.jit(jbuild_train_step(
        model, jrun, jmake_gossip_schedule(jrun, A), mesh=mesh,
        agent_axes=gossip_agent_axes(mesh), straggler_plan=plan))
    state = jinit_state(model, jrun, A, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state)
    metrics = []
    for tok in tokens:
        state, m = step(state, {"tokens": jnp.asarray(tok)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.array, state)


def _port_run(kw, init, tokens, late=None, fused=True):
    run = RunConfig(**kw)
    model = build_model(tget_smoke_config("smollm_360m"))
    plan = None if late is None else tel.StragglerPlan(3, late)
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=fused, straggler_plan=plan,
                            device="cpu")
    state = weights.train_state_from_arrays(init)
    metrics = []
    for tok in tokens:
        state, m = step(state, {"tokens": torch.from_numpy(tok)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _buses(state):
    out = {"params": state["params"], "phi": state["pipeline"]["slot"][
        int(state["pipeline"]["parity"])]}
    out.update(state["opt"])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", ["f32", "straggler", "int8"])
def test_delayed_trajectory_matches_reference(case):
    kw = _run_kw(wire="int8") if case == "int8" else _run_kw()
    late = LATE if case == "straggler" else None
    tokens = _tokens()
    init, jm, jfinal = _jax_run(kw, tokens, late)
    assert set(init) == {"params", "opt", "step", "pipeline"}
    tm, tfinal = _port_run(kw, init, tokens, late)
    rtol = 1e-3 if case == "int8" else 1e-5
    for t, (a, b) in enumerate(zip(tm, jm)):
        # atol: at step 0 the port's consensus is 0 (W x(0) = x(0) exactly
        # for the ring's weights); XLA's fused combine leaves ~1e-11
        for k in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=1e-9,
                                       err_msg=f"step {t} {k}")
    assert tfinal["step"] == STEPS and tfinal["pipeline"]["parity"] == \
        int(jfinal["pipeline"]["parity"]) == STEPS % 2
    got, want = _buses(tfinal), _buses({**jfinal, "pipeline": {
        "slot": jfinal["pipeline"]["slot"],
        "parity": int(jfinal["pipeline"]["parity"])}})
    assert got.keys() == want.keys()
    for k in got:
        if case != "int8":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            continue
        bound = QUANTA * _quantum(want["params"], "int8", w_max=0.5) + 1e-5
        diff = np.abs(got[k] - want[k])
        assert np.all(diff <= bound), (k, (diff / bound).max())
        assert np.mean(diff > 1e-5) <= FLIP_SHARE, k


def test_delayed_step0_is_synchronous_and_off_is_synchronous():
    tokens = _tokens(2)
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    init = jax.tree.map(np.array, jinit_state(
        jmodel, JRunConfig(**_run_kw()), A, jax.random.PRNGKey(0)))
    sync_init = {k: v for k, v in init.items() if k != "pipeline"}
    sync_m, sync = _port_run(_run_kw(overlap="off"), sync_init, tokens[:1])
    dm, delayed = _port_run(_run_kw(), init, tokens[:1])
    assert dm[0]["loss"] == sync_m[0]["loss"]
    for k in ("m", "psi"):
        assert torch.equal(delayed["opt"][k], sync["opt"][k])
    # the new live payload is the synchronous step's φ: its mix is x(1)
    phi = tbus.pipeline_payload(delayed["pipeline"])
    assert torch.equal(tmix.mix_ppermute(ttopo.ring(A), phi,
                                         agents_per_device=A,
                                         use_fused_kernel=True),
                       sync["params"])
    # overlap="off" is the synchronous step, bit for bit
    a_m, a = _port_run(_run_kw(overlap="off"), sync_init, tokens)
    b_m, b = _port_run({k: v for k, v in _run_kw().items()
                        if k != "overlap"}, sync_init, tokens)
    assert a_m == b_m and torch.equal(a["params"], b["params"])


def test_straggler_and_overlap_guards():
    model = build_model(tget_smoke_config("smollm_360m"))
    sched = make_gossip_schedule(RunConfig(**_run_kw()), A)
    with pytest.raises(ValueError, match="overlap"):
        build_train_step(model, RunConfig(**_run_kw(overlap="off")), sched,
                         straggler_plan=tel.StragglerPlan(3), device="cpu")
    with pytest.raises(ValueError, match="arity"):
        build_train_step(model, RunConfig(**_run_kw()), sched,
                         straggler_plan=tel.StragglerPlan(5), device="cpu")
    for kw in (dict(gossip_every=2), dict(gossip_dtype="bfloat16"),
               dict(packed_bus=False), dict(overlap="eager")):
        with pytest.raises(ValueError):
            build_train_step(model, RunConfig(**_run_kw(**kw)), sched,
                             device="cpu")


# ---------------------------------------------------------------------------
# pipeline checkpoints
# ---------------------------------------------------------------------------

def _jax_pipeline_state(wire, parity, seed=0, n_agents=A):
    """A reference train state with a pipeline, random leaves from numpy
    (pads zero, as a bus keeps them), the given parity."""
    model = jbuild_model(get_smoke_config("smollm_360m"))
    run = JRunConfig(**{**_run_kw(wire=wire), "global_batch": n_agents,
                        "agents_per_device": n_agents})
    state = jinit_state(model, run, n_agents, jax.random.PRNGKey(0))
    layout = jbus_layout_for(model, n_agents)
    rng = np.random.default_rng(seed)

    def rand(b):
        b = np.asarray(b)
        if b.ndim == 0:
            return np.asarray(3, b.dtype)
        r = rng.standard_normal(b.shape).astype(np.float32)
        buses = r.reshape((-1, n_agents) + b.shape[-2:])
        return np.stack([np.asarray(jbus.pack_tree(
            layout, jbus.unpack_tree(layout, jnp.asarray(x))))
            for x in buses]).reshape(b.shape)

    state = jax.tree.map(rand, state)
    state["pipeline"]["parity"] = np.asarray(parity, np.int32)
    return state, layout, model, run


def _same_files(a, b):
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype.str == fb[k].dtype.str, k
            assert fa[k].tobytes() == fb[k].tobytes(), k


@pytest.mark.parametrize("wire,parity", [("f32", 1), ("int8", 0)])
def test_pipeline_checkpoints_load_in_either_package(wire, parity, tmp_path):
    jstate, jlayout, _, _ = _jax_pipeline_state(wire, parity)
    jfile, pfile, jjfile = (str(tmp_path / n) for n in ("j.npz", "p.npz",
                                                        "jj.npz"))
    jckpt.save_state(jfile, jstate, layout=jlayout)
    model = build_model(tget_smoke_config("smollm_360m"))
    run = RunConfig(**_run_kw(wire=wire))
    layout = bus_layout_for(model, A)
    state = checkpoint.load_state(jfile, init_state(model, run, A,
                                                    device="cpu"),
                                  layout=layout)
    assert state["pipeline"]["parity"] == parity and state["step"] == 3
    live = jstate["pipeline"]["slot"][parity]
    for s in range(2):       # the live payload in both slots
        np.testing.assert_array_equal(state["pipeline"]["slot"][s].numpy(),
                                      live)
    checkpoint.save_state(pfile, state, layout=layout)
    _same_files(jfile, pfile)
    back = jckpt.load_state(pfile, jstate, layout=jlayout)
    assert int(back["pipeline"]["parity"]) == parity
    jckpt.save_state(jjfile, back, layout=jlayout)
    _same_files(pfile, jjfile)


def test_pipeline_resize_matches_reference(tmp_path):
    jstate, jlayout, jmodel, jrun = _jax_pipeline_state("f32", 1, seed=3)
    path = str(tmp_path / "s.npz")
    jckpt.save_state(path, jstate, layout=jlayout)
    model = build_model(tget_smoke_config("smollm_360m"))
    layout = bus_layout_for(model, A)
    for n_new, surv in ((3, None), (6, None), (4, [3, 1])):
        run = RunConfig(**{**_run_kw(), "global_batch": n_new,
                           "agents_per_device": n_new})
        like = init_state(model, run, n_new, device="cpu")
        got = checkpoint.load_state_resized(path, like, layout=layout,
                                            survivors=surv)
        jrun2 = dataclasses.replace(jrun, global_batch=n_new,
                                    agents_per_device=n_new)
        want = jckpt.load_state_resized(
            path, jinit_state(jmodel, jrun2, n_new, jax.random.PRNGKey(0)),
            layout=jlayout, survivors=surv)
        np.testing.assert_array_equal(got["pipeline"]["slot"].numpy(),
                                      np.asarray(want["pipeline"]["slot"]))
        assert got["pipeline"]["parity"] == int(want["pipeline"]["parity"])
        np.testing.assert_array_equal(got["params"].numpy(),
                                      np.asarray(want["params"]))


def test_resumed_overlap_run_is_bit_equal(tmp_path):
    """Through the train CLI: 3 delayed int8 steps, against 1 step,
    ``--ckpt`` (an odd parity in the file), and 2 steps ``--resume``d."""
    base = ["--device", "cpu", "--arch", "smollm_360m", "--smoke", "--seq",
            str(SEQ), "--agents", "4", "--agents-per-device", "4",
            "--gossip-engine", "ppermute", "--fused-kernel", "--overlap",
            "delayed", "--wire", "int8"]
    full = tcli.main(base + ["--steps", "3"])
    ckpt = str(tmp_path / "ov.npz")
    tcli.main(base + ["--steps", "1", "--ckpt", ckpt])
    with np.load(ckpt) as f:
        assert int(f["pipeline|parity"]) == 1
        assert any(k.startswith("pipeline|phi|") for k in f.files)
    res = tcli.main(base + ["--steps", "2", "--resume", ckpt])
    assert res["metrics"][-1] == full["metrics"][-1]
    a, b = res["state"], full["state"]
    assert a["pipeline"]["parity"] == b["pipeline"]["parity"] == 1
    assert torch.equal(a["params"], b["params"])
    assert torch.equal(tbus.pipeline_payload(a["pipeline"]),
                       tbus.pipeline_payload(b["pipeline"]))
    for k in ("m", "psi", "e"):
        assert torch.equal(a["opt"][k], b["opt"][k]), k
