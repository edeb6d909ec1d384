"""The gossip wire and the time-varying schedules of the port against the
JAX package: schedules, the EF optimizer step, the property the wire
exists for, the CLI and the feature checks.  The wire-coded mixers are in
``test_torch_wire_mix.py``, the multi-step training trajectories in
``test_torch_wire_trajectory.py``.

Tolerances, with the reason:
* schedules: dense matrices and the wire-byte model exact (the same numpy
  code); period-product λ within 1e-12 (eigenvalues of the same matrix);
* EF step: ``x' + W·e'`` (which equals ``W·c`` whatever ``q`` a rounding
  tie gives) within atol 1e-5, and ``e'`` off by more than 1e-5 — a flipped
  quantum — on a share ≤ 1e-4 of the elements;
* EF floor: the mean squared error over the last 50 of 200 steps within
  10 % of JAX's, for EF and for naive quantization.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.core import mixing as jmix
from repro.core import schedule as jsched
from repro.core import topology as jtopo
from repro.core import wire as jwire
from repro.core.optimizers import make_edm_bus_ef as j_make_edm_bus_ef
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.train import resolve_features as j_resolve_features

from repro_torch.configs.base import RunConfig
from repro_torch.core import mixing as tmix
from repro_torch.core import schedule as tsched
from repro_torch.core import topology as ttopo
from repro_torch.core import wire as twire
from repro_torch.core.optimizers import make_edm_bus_ef
from repro_torch.train import resolve_features

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
BR = 8


def _sched_cases():
    cases = []
    for n in (2, 4, 5, 8):
        cases += [("static", ("ring", (n,))), ("static", ("exp_graph", (n,))),
                  ("round_robin", (n, None)), ("round_robin", (n, 3))]
    for pods, per, every in ((2, 2, 1), (2, 4, 1), (4, 2, 2), (3, 3, 3)):
        cases += [("alt_hier", (pods, per, every)),
                  ("static", ("hierarchical", (pods, per))),
                  ("static", ("torus2d", (pods, per)))]
    return cases


def _build(mod_sched, mod_topo, kind, args):
    if kind == "static":
        name, targs = args
        return mod_sched.StaticSchedule(getattr(mod_topo, name)(*targs))
    if kind == "round_robin":
        return mod_sched.RoundRobinExp(args[0], seed=args[1])
    pods, per, every = args
    return mod_sched.AlternatingHierarchical(pods, per, intra_every=every)


@pytest.mark.parametrize("kind,args", _sched_cases())
def test_schedule_matches_reference(kind, args):
    js = _build(jsched, jtopo, kind, args)
    ts = _build(tsched, ttopo, kind, args)
    assert ts.name == js.name and ts.period == js.period
    for jr, tr in zip(js.rounds, ts.rounds):
        np.testing.assert_array_equal(tr.dense_matrix(), jr.dense_matrix())
        assert tr.terms == tuple(ttopo.ShiftTerm(t.level, t.shift, t.weight)
                                 for t in jr.terms)
        assert tr.grid == jr.grid
    np.testing.assert_array_equal(ts.period_product(), js.period_product())
    assert abs(ts.product_lam() - js.product_lam()) <= 1e-12
    assert ts.product_spectral_stats()["permutes_per_step"] == \
        js.product_spectral_stats()["permutes_per_step"]
    ts.check_assumption1()
    n = ts.n_agents
    for step in range(ts.period + 1):
        assert ts.round_index(step) == js.round_index(step)
        for fmt in (None, "f32", "bf16", "int8"):
            jc = jwire.make_codec(fmt, BR) if fmt else None
            tc = twire.make_codec(fmt, BR) if fmt else None
            for engine in ("ppermute", "shifts", "dense"):
                for b in {1, n}:
                    kw = dict(elems_per_agent=5 * BR * 128 + 77,
                              agents_per_device=b, engine=engine)
                    assert tsched.wire_bytes_per_step(ts, step, codec=tc,
                                                      **kw) == \
                        jsched.wire_bytes_per_step(js, step, codec=jc, **kw)


def test_make_schedule_and_matrix_lam_match_reference():
    for name, kw in (("static", {}), ("round_robin", dict(seed=5)),
                     ("alt_hier", dict(pods=2, period=2))):
        js = jsched.make_schedule(name, 8, **kw)
        ts = tsched.make_schedule(name, 8, **kw)
        assert ts.name == js.name
        np.testing.assert_array_equal(ts.period_product(),
                                      js.period_product())
    W = np.random.default_rng(0).uniform(size=(5, 5))
    W /= W.sum(1, keepdims=True)
    assert ttopo.matrix_lam(W) == jtopo.matrix_lam(W)
    with pytest.raises(ValueError, match="unknown gossip schedule"):
        tsched.make_schedule("nope", 4)


# ---------------------------------------------------------------------------
# the EF optimizer step and the floor
# ---------------------------------------------------------------------------

def _state(seed, A=4, rows=4 * BR):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(A, rows, 128)).astype(np.float32)
            for _ in range(5)]


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True])
def test_ef_step_matches_reference(fmt, fused):
    """One make_edm_bus_ef step from identical buses (x, g, m, ψ, e) with
    the one-device ppermute mixer, fused or not, on both sides."""
    x, g, m, psi, e = _state(seed=1)
    A = x.shape[0]
    mesh = make_gossip_mesh(A, agents_per_device=A)
    jc, tc = jwire.make_codec(fmt, BR), twire.make_codec(fmt, BR)
    jmix_fn = jmix.make_mixer(jtopo.ring(A), "ppermute", mesh=mesh,
                              agent_axes=gossip_agent_axes(mesh),
                              use_fused_kernel=fused, wire=jc)
    jopt = j_make_edm_bus_ef(0.2, 0.9, jmix_fn, jc, block_rows=BR,
                             use_fused_kernel=fused)
    jx, jst = jopt.step(jnp.asarray(x), jnp.asarray(g),
                        {"m": jnp.asarray(m), "psi": jnp.asarray(psi),
                         "e": jnp.asarray(e)})
    tmix_fn = tmix.make_mixer(ttopo.ring(A), "ppermute", agents_per_device=A,
                              use_fused_kernel=fused, wire=tc)
    topt = make_edm_bus_ef(0.2, 0.9, tmix_fn, tc, use_fused_kernel=fused)
    st = {k: torch.from_numpy(v.copy()) for k, v in
          (("m", m), ("psi", psi), ("e", e))}
    bufs = {k: v.data_ptr() for k, v in st.items()}
    tx, tst = topt.step(torch.from_numpy(x), torch.from_numpy(g), st)
    assert {k: v.data_ptr() for k, v in tst.items()} == bufs   # in place
    for k in ("m", "psi"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    W = ttopo.ring(A).dense_matrix()
    je, te = np.asarray(jst["e"]), tst["e"].numpy()

    def wc(xb, eb):
        return xb + (W @ eb.reshape(A, -1)).reshape(eb.shape)

    np.testing.assert_allclose(wc(tx.numpy(), te), wc(np.asarray(jx), je),
                               rtol=0, atol=1e-5)
    assert np.mean(np.abs(te - je) > 1e-5) <= 1e-4


def _floor_problem(A=4, rows=2 * BR, seed=0):
    """Heterogeneous diagonal least squares: agent i minimizes
    ½‖H_i^½ (x − b_i)‖², with b_i offset per agent, so the optimum x* is
    the H-weighted mean and every agent's own optimum is far from it."""
    rng = np.random.default_rng(seed)
    b = (rng.normal(size=(A, rows, 128)) * 3.0
         + (np.arange(A) * 5.0 - 7.5)[:, None, None]).astype(np.float32)
    H = rng.uniform(0.5, 2.0, size=(A, rows, 128)).astype(np.float32)
    return H, b, (H * b).sum(0) / H.sum(0)


def _floor(side, fmt, error_feedback, steps=200, alpha=0.1, beta=0.5):
    H, b, xstar = _floor_problem()
    A = b.shape[0]
    errs = []
    if side == "jax":
        codec = jwire.make_codec(fmt, BR)
        opt = j_make_edm_bus_ef(alpha, beta,
                                jmix.make_mixer(jtopo.ring(A), "dense",
                                                wire=codec),
                                codec, error_feedback=error_feedback)
        step = jax.jit(opt.step)
        x = jnp.zeros(b.shape, jnp.float32)
        st = opt.init(x)
        for _ in range(steps):
            x, st = step(x, jnp.asarray(H) * (x - jnp.asarray(b)), st)
            errs.append(float(jnp.mean((x - xstar) ** 2)))
    else:
        codec = twire.make_codec(fmt, BR)
        opt = make_edm_bus_ef(alpha, beta,
                              tmix.make_mixer(ttopo.ring(A), "dense",
                                              wire=codec),
                              codec, error_feedback=error_feedback)
        Ht, bt, xs = map(torch.from_numpy, (H, b, xstar))
        x = torch.zeros(b.shape)
        st = opt.init(x)
        for _ in range(steps):
            x, st = opt.step(x, Ht * (x - bt), st)
            errs.append(float(((x - xs) ** 2).mean()))
    return float(np.mean(errs[-50:]))


def test_int8_ef_floor_matches_reference_and_beats_naive():
    """The property the wire exists for: with error feedback the int8
    wire keeps EDM near the optimum; naive quantization stalls far from
    it.  Both floors within 10 % of JAX's."""
    floors = {(side, ef): _floor(side, "int8", ef)
              for side in ("jax", "port") for ef in (True, False)}
    for ef in (True, False):
        j, t = floors[("jax", ef)], floors[("port", ef)]
        assert abs(t - j) <= 0.1 * j, (ef, t, j)
    for side in ("jax", "port"):
        assert floors[(side, False)] > 100 * floors[(side, True)], floors


def test_naive_quantization_leaves_residual_zero():
    x, g, m, psi, _ = _state(seed=5)
    tc = twire.make_codec("int8", BR)
    opt = make_edm_bus_ef(0.2, 0.9, tmix.make_mixer(ttopo.ring(4), "dense",
                                                    wire=tc),
                          tc, error_feedback=False)
    st = opt.init(torch.from_numpy(x))
    for _ in range(2):
        _, st = opt.step(torch.from_numpy(x), torch.from_numpy(g), st)
    assert torch.count_nonzero(st["e"]) == 0


# ---------------------------------------------------------------------------
# features and the CLI
# ---------------------------------------------------------------------------

def test_resolve_features_rejects_what_the_reference_rejects():
    base = dict(algorithm="edm", gossip_engine="ppermute",
                agents_per_device=4)
    for kw in (dict(wire="int8", packed_bus=False),
               dict(wire="bf16", algorithm="dsgd", gossip_engine="shifts"),
               dict(wire="int8", gossip_dtype="bfloat16")):
        run = {**base, **kw}
        with pytest.raises(AssertionError):
            j_resolve_features(JRunConfig(**run))
        with pytest.raises(ValueError, match="wire"):
            resolve_features(RunConfig(**run))
    with pytest.raises(ValueError, match="wire"):
        resolve_features(RunConfig(**base, wire="fp8"))
    for wire in ("f32", "bf16", "int8"):
        for sched in ("static", "round_robin", "alt_hier"):
            run = {**base, "wire": wire, "gossip_schedule": sched}
            feats = resolve_features(RunConfig(**run))
            assert feats.wire == j_resolve_features(JRunConfig(**run)).wire
            assert feats.packed_bus


def test_cli_int8_round_robin_runs_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--smoke", "--arch", "smollm_360m", "--wire", "int8",
         "--gossip-schedule", "round_robin", "--topology", "exp",
         "--agents", "4", "--agents-per-device", "4", "--gossip-engine",
         "ppermute", "--fused-kernel", "--steps", "2", "--seq", "16"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "schedule=round_robin_exp(4) period=2" in out.stdout
    assert "wire=int8" in out.stdout and "wire_bytes/step=0" in out.stdout
    lines = [l for l in out.stdout.splitlines() if "loss=" in l]
    assert len(lines) == 2, out.stdout
    for l in lines:
        assert np.isfinite(float(l.split("loss=")[1].split()[0]))
