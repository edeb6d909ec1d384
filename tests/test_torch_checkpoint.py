"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's (``repro.train.checkpoint``), and the train → export → serve
hand-off through the port's CLIs, on the smoke ``smollm_360m`` with 4
agents.

* Files: a state saved by either package loads in the other and saves
  back to the same leaves, byte for byte (bus states with and without the
  EF residual, a tree state, a tree of bf16 leaves); a bus state's file
  loads as a tree state and back.
* Consensus export: on f32 leaves byte-identical to
  ``repro.train.checkpoint.export_consensus`` on the same gathered-layout
  file; on bf16 leaves (which the reference's numpy mean cannot take)
  equal to its formula, the float64 mean rounded once by ml_dtypes.
* ``resize_state`` (shrink, identity, grow) and ``load_state_resized``
  equal to the reference's, bit for bit.
* The train CLI: a run resumed through ``--ckpt`` / ``--resume`` is bit
  for bit the uninterrupted run (bus, tree, int8 wire); an f32-wire file
  resumed under the int8 wire starts with a zero residual.
* The hand-off on the CPU: train CLI ``--ckpt`` → port export → serve CLI
  ``--ckpt``, the served parameters' digest that of the export.

Inputs are random leaves made with numpy from a seed (the format is what
is tested, so every bit pattern counts), carried into both packages.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.core import bus as jbus
from repro.models import build_model as jbuild_model
from repro.train import bus_layout_for as jbus_layout_for
from repro.train import checkpoint as jckpt
from repro.train import init_state as jinit_state

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.bus import pack_tree, unpack_tree
from repro_torch.launch import train as tcli
from repro_torch.models import build_model
from repro_torch.train import bus_layout_for, checkpoint, init_state

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
A = 4

# (algorithm, packed bus, wire, leaf dtype)
STATES = {
    "bus-edm": ("edm", True, "f32", "float32"),
    "bus-edm-int8": ("edm", True, "int8", "float32"),
    "tree-dsgt_hb": ("dsgt_hb", False, "f32", "float32"),
    "tree-edm-bf16": ("edm", False, "f32", "bfloat16"),
}


def _cfg(dtype):
    return dataclasses.replace(get_smoke_config("smollm_360m"), dtype=dtype)


def _jax_state(kind, seed=0, n_agents=A):
    """A JAX train state of ``kind`` with random leaves (numpy, from
    ``seed``), its model and its bus layout (None on the tree)."""
    alg, bus, wire, dtype = STATES[kind]
    model = jbuild_model(_cfg(dtype))
    run = JRunConfig(global_batch=n_agents, seq_len=16, algorithm=alg,
                     gossip_engine="ppermute", agents_per_device=n_agents,
                     packed_bus=bus, wire=wire, remat=False)
    state = jinit_state(model, run, n_agents, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def rand(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return np.asarray(3, x.dtype)
        return rng.standard_normal(x.shape).astype(np.float32).astype(
            x.dtype)

    state = jax.tree.map(rand, state)
    layout = jbus_layout_for(model, n_agents) if bus else None
    if layout is not None:   # pads stay zero, as a bus state keeps them
        state = jax.tree.map(
            lambda b: np.asarray(jbus.pack_tree(layout,
                                                jbus.unpack_tree(layout, b)))
            if np.ndim(b) == 3 else b, state)
    return state, layout


def _port_like(kind, n_agents=A):
    """The port's freshly built state of ``kind`` (the template a resume
    loads into) and its bus layout."""
    alg, bus, wire, dtype = STATES[kind]
    model = build_model(dataclasses.replace(
        tget_smoke_config("smollm_360m"), dtype=dtype))
    run = RunConfig(global_batch=n_agents, seq_len=16, algorithm=alg,
                    gossip_engine="ppermute", agents_per_device=n_agents,
                    packed_bus=bus, wire=wire, remat=False)
    state = init_state(model, run, n_agents, device="cpu")
    return state, (bus_layout_for(model, n_agents) if bus else None)


def _same_files(a, b):
    """Two npz files hold the same keys, shapes, dtypes and bytes."""
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            x, y = fa[k], fb[k]
            assert x.shape == y.shape and x.dtype.itemsize == \
                y.dtype.itemsize and x.dtype.kind == y.dtype.kind, k
            assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("kind", list(STATES))
def test_files_load_in_either_package_byte_equal(kind, tmp_path):
    jstate, jlayout = _jax_state(kind)
    jfile, pfile, jjfile = (str(tmp_path / n) for n in
                            ("j.npz", "p.npz", "jj.npz"))
    jckpt.save_state(jfile, jstate, layout=jlayout)
    like, layout = _port_like(kind)
    state = checkpoint.load_state(jfile, like, layout=layout)
    assert state["step"] == 3 and set(state["opt"]) == set(jstate["opt"])
    checkpoint.save_state(pfile, state, layout=layout)
    _same_files(jfile, pfile)
    back = jckpt.load_state(pfile, jstate, layout=jlayout)
    jckpt.save_state(jjfile, back, layout=jlayout)
    _same_files(pfile, jjfile)
    if kind == "tree-edm-bf16":
        with np.load(pfile) as f:
            assert f["params|embed"].dtype.str == "|V2"


def test_bus_and_tree_files_interchange(tmp_path):
    """A bus state's file loads as the tree state of the same parameters
    and the tree state's file back into the bus, leaf for leaf."""
    jstate, jlayout = _jax_state("bus-edm", seed=1)
    f = str(tmp_path / "bus.npz")
    jckpt.save_state(f, jstate, layout=jlayout)
    bus_like, layout = _port_like("bus-edm")
    bus = checkpoint.load_state(f, bus_like, layout=layout)
    tree_like = {"params": unpack_tree(layout, bus_like["params"]),
                 "opt": {k: unpack_tree(layout, v)
                         for k, v in bus_like["opt"].items()},
                 "step": 0}
    tree = checkpoint.load_state(f, tree_like)
    for name, b, t in (("params", bus["params"], tree["params"]),
                       ("m", bus["opt"]["m"], tree["opt"]["m"]),
                       ("psi", bus["opt"]["psi"], tree["opt"]["psi"])):
        for p, leaf in unpack_tree(layout, b).items():
            assert torch.equal(leaf, t[p]), (name, p)
    g = str(tmp_path / "tree.npz")
    checkpoint.save_state(g, tree)
    bus2 = checkpoint.load_state(g, bus_like, layout=layout)
    assert torch.equal(bus2["params"], pack_tree(layout, tree["params"]))
    assert torch.equal(bus2["params"], bus["params"])
    _same_files(f, g)


def test_export_consensus_f32_byte_identical_to_reference(tmp_path):
    jstate, jlayout = _jax_state("bus-edm", seed=2)
    src = str(tmp_path / "state.npz")
    jckpt.save_state(src, jstate, layout=jlayout)
    want, got = str(tmp_path / "want.npz"), str(tmp_path / "got.npz")
    jckpt.export_consensus(src, want)
    checkpoint.export_consensus(src, got)
    _same_files(want, got)
    with np.load(got) as f:
        assert "embed" in f.files and not any("|" == k[0] for k in f.files)
        assert f["embed"].dtype == np.float32


@pytest.mark.parametrize("n_agents", [3, 4])
def test_export_consensus_bf16_is_the_float64_mean_rounded_once(
        n_agents, tmp_path):
    """The reference raises on bf16 leaves (numpy reads them as |V2); the
    port's export equals its formula computed through ml_dtypes."""
    jstate, _ = _jax_state("tree-edm-bf16", seed=3, n_agents=n_agents)
    src, dst = str(tmp_path / "state.npz"), str(tmp_path / "export.npz")
    jckpt.save_state(src, jstate)
    with pytest.raises(ValueError):
        jckpt.export_consensus(src, str(tmp_path / "ref.npz"))
    checkpoint.export_consensus(src, dst)
    with np.load(src) as s, np.load(dst) as d:
        keys = [k for k in s.files if k.startswith("params|")]
        assert sorted(k[len("params|"):] for k in keys) == sorted(d.files)
        for k in keys:
            leaf = s[k].view(ml_dtypes.bfloat16)
            want = leaf.mean(axis=0, dtype=np.float64).astype(
                ml_dtypes.bfloat16)
            got = d[k[len("params|"):]]
            assert got.dtype.str == "|V2" and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), k


def test_float64_to_bf16_rounding_matches_ml_dtypes():
    """The export rounds float64 to bf16 through torch; on values at,
    just above and just below every kind of rounding tie it gives the bits
    ml_dtypes' astype gives."""
    rng = np.random.default_rng(4)
    base = rng.standard_normal(20000).astype(ml_dtypes.bfloat16).astype(
        np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(base))) - 7)
    vals = np.concatenate([
        base + ulp / 2, base - ulp / 2, base + ulp / 2 * (1 + 2.0 ** -30),
        base + ulp / 2 * (1 - 2.0 ** -30), base + ulp * rng.uniform(
            -1, 1, base.size), rng.standard_normal(1000) * 1e-40,
        [0.0, -0.0, np.inf, -np.inf, 3.3e38, -3.3e38]])
    want = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(vals).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


RESIZES = {"shrink": ([0, 2, 3], 3), "identity": ([0, 1, 2, 3], 4),
           "grow2": ([1, 3], 4), "grow3": ([0, 1, 2], 4)}


@pytest.mark.parametrize("kind", ["bus-edm", "tree-edm-bf16"])
@pytest.mark.parametrize("resize", list(RESIZES))
def test_resize_state_matches_reference(kind, resize):
    survivors, n = RESIZES[resize]
    jstate, _ = _jax_state(kind, seed=5)
    want = jax.tree.map(np.asarray, jckpt.resize_state(jstate, survivors, n))
    got = checkpoint.resize_state(weights.train_state_from_arrays(jstate),
                                  survivors, n)
    want = weights.train_state_from_arrays(want)
    assert got["step"] == want["step"] and set(got["opt"]) == set(
        want["opt"])

    def same(a, b, name):
        if isinstance(a, dict):
            assert set(a) == set(b), name
            for p in a:
                same(a[p], b[p], f"{name}|{p}")
            return
        assert a.dtype == b.dtype and a.shape == b.shape, name
        ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(a.view(ints), b.view(ints)), name

    same(got["params"], want["params"], "params")
    for slot in want["opt"]:
        same(got["opt"][slot], want["opt"][slot], slot)


@pytest.mark.parametrize("n_new", [3, 6])
def test_load_state_resized_matches_reference(n_new, tmp_path):
    jstate, jlayout = _jax_state("bus-edm", seed=6)
    f = str(tmp_path / "state.npz")
    jckpt.save_state(f, jstate, layout=jlayout)
    jlike, jlayout_new = _jax_state("bus-edm", n_agents=n_new)
    want = jckpt.load_state_resized(f, jlike, layout=jlayout_new)
    like, layout = _port_like("bus-edm", n_agents=n_new)
    got = checkpoint.load_state_resized(f, like, layout=layout)
    for g, w in ((got["params"], want["params"]),
                 (got["opt"]["m"], want["opt"]["m"]),
                 (got["opt"]["psi"], want["opt"]["psi"])):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert got["step"] == int(want["step"])


CLI = ["--device", "cpu", "--arch", "smollm_360m", "--smoke", "--agents",
       "4", "--agents-per-device", "4", "--gossip-engine", "ppermute",
       "--fused-kernel", "--seq", "16"]
RESUME_CASES = {"bus": [], "tree": ["--no-packed-bus", "--algorithm",
                                    "dsgt_hb"],
                "int8": ["--wire", "int8"]}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _states_equal(a, b):
    assert a["step"] == b["step"] and set(a["opt"]) == set(b["opt"])
    pairs = [(a["params"], b["params"])] + [(a["opt"][s], b["opt"][s])
                                            for s in a["opt"]]
    for x, y in pairs:
        if isinstance(x, dict):
            assert set(x) == set(y)
            for p in x:
                assert torch.equal(_bits(x[p]), _bits(y[p])), p
        else:
            assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_cli_resume_is_the_uninterrupted_run(case, tmp_path):
    args = CLI + RESUME_CASES[case]
    ck = str(tmp_path / "ck.npz")
    full = tcli.main(args + ["--steps", "4"])
    first = tcli.main(args + ["--steps", "2", "--ckpt", ck])
    rest = tcli.main(args + ["--steps", "2", "--resume", ck])
    assert first["state"]["step"] == 2 and rest["state"]["step"] == 4
    _states_equal(full["state"], rest["state"])
    assert full["metrics"][2:] == rest["metrics"]


def test_int8_resume_of_an_f32_file_starts_with_zero_residual(tmp_path):
    ck, ck8 = str(tmp_path / "f32.npz"), str(tmp_path / "int8.npz")
    f32 = tcli.main(CLI + ["--steps", "2", "--ckpt", ck])
    with np.load(ck) as f:
        assert not any(k.startswith("opt|e|") for k in f.files)
    got = tcli.main(CLI + ["--wire", "int8", "--steps", "0", "--resume",
                           ck, "--ckpt", ck8])["state"]
    assert set(got["opt"]) == {"m", "psi", "e"}
    assert not bool(got["opt"]["e"].any())
    for s in ("m", "psi"):
        assert torch.equal(got["opt"][s], f32["state"]["opt"][s])
    assert torch.equal(got["params"], f32["state"]["params"])
    # and back: the f32 wire ignores the int8 file's residual
    back = tcli.main(CLI + ["--steps", "0", "--resume", ck8])["state"]
    assert set(back["opt"]) == {"m", "psi"}
    assert torch.equal(back["params"], f32["state"]["params"])


def test_handoff_train_export_serve_on_cpu(tmp_path):
    """Train with ``--ckpt``, export with the port, serve with the serve
    CLI's ``--ckpt``: the served parameters are the export's bits (the
    CLI's digest), and the reference loads the port's export too."""
    ck, ex = str(tmp_path / "state.npz"), str(tmp_path / "consensus.npz")
    tcli.main(CLI + ["--steps", "2", "--ckpt", ck])
    checkpoint.export_consensus(ck, ex)
    want = weights.params_digest(weights.params_from_npz(ex))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "smollm_360m", "--smoke", "--continuous-batching",
         "--prefill-chunk", "8", "--max-step-tokens", "16", "--prompt-dist",
         "exact", "--max-slots", "4", "--page-size", "8", "--requests", "4",
         "--ckpt", ex],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"(sha256 {want})" in out.stdout and "generated" in out.stdout
    jmodel = jbuild_model(get_smoke_config("smollm_360m"))
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jparams = jckpt.load_consensus(ex, like)
    tparams = checkpoint.load_consensus(
        ex, build_model(tget_smoke_config("smollm_360m")).meta(),
        device="cpu")
    flat = weights.params_from_tree(jax.tree.map(np.asarray, jparams))
    assert set(flat) == set(tparams)
    for p, v in tparams.items():
        assert torch.equal(flat[p], v), p
    assert jnp.float32 == next(iter(jax.tree.leaves(jparams))).dtype
