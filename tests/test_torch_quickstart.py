"""``examples/quickstart_torch.py`` against ``examples/quickstart.py``: the
same §E.1 quadratic on ring(32), EDM and DmSGD, 301 steps on the CPU.  The
JAX side runs ``quickstart.py``'s loop (its ``repro.core`` /
``repro.data`` calls) at fewer steps; the mean squared distance to the
optimum agrees at every 100th step within rtol 1e-3 (f32 on both sides,
XLA and PyTorch reduction orders), and EDM is far below DmSGD's floor.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_mixer, make_optimizer, ring
from repro.data import quadratic_problem

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
STEPS, EVERY = 301, 100


def _twin():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(alg):
    """``examples/quickstart.py``'s loop, ``STEPS`` steps."""
    n = 32
    _, full, x_opt, _ = quadratic_problem(n, c=1.0, sigma=0.0, seed=0)
    opt = make_optimizer(alg, alpha=0.05, beta=0.9, mix=make_mixer(ring(n)))
    x = jnp.zeros((n, x_opt.shape[0]))
    state = opt.init(x)
    errs = {}
    for t in range(STEPS):
        x, state = opt.step(x, full(x), state)
        if t % EVERY == 0:
            errs[t] = float(jnp.mean(jnp.sum((x - x_opt[None]) ** 2, -1)))
    return errs


@pytest.mark.parametrize("alg", ["edm", "dmsgd"])
def test_quickstart_twin_matches_reference(alg):
    got = _twin().run(alg, STEPS, EVERY, device="cpu")
    want = _reference(alg)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=1e-3)
    if alg == "edm":
        assert got[STEPS - 1] < 1e-4
    else:
        assert got[STEPS - 1] > 0.5


def test_quickstart_twin_needs_a_device_or_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, str(ROOT / "examples" / "quickstart_torch.py")]
    out = subprocess.run(cmd + ["--steps", "3"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    out = subprocess.run(cmd + ["--steps", "3", "--device", "cpu"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--- edm ---" in out.stdout and "--- dmsgd ---" in out.stdout
