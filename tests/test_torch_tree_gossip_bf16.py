"""The plain (unfused) bf16 gossip payload of the tree path against the JAX
package with XLA's excess precision off.

With ``gossip_dtype="bfloat16"`` and the plain combine, eager PyTorch
rounds the payload to bf16 after every operation.  XLA by default may keep
a jitted bf16 chain in f32 (``--xla_allow_excess_precision``, on by
default), which skips part of that rounding: the reference's consensus at
step 0 is 0.0653 where the port's is 0.0844.  With the flag off, the
reference computes the same chain as the port and gives 0.0844 too, so the
gap is the reference's excess precision, not a fault of the port.

The JAX side (``jax_trajectory`` of ``test_torch_tree_train.py``) runs in a
subprocess, since XLA reads its flags once, before it starts; the port
side runs here, through ``check_trajectory`` at the cast tolerances stated
there (consensus rtol 1e-3, state within 4 bf16 ulps).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch

from test_torch_tree_train import check_trajectory

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
CASE = "edm-gossip-bf16"

_JAX_SIDE = """
import pickle, sys
import test_torch_tree_train as t
pickle.dump(t.jax_trajectory(sys.argv[1]), open(sys.argv[2], "wb"))
"""


def test_plain_bf16_gossip_matches_reference_without_excess_precision(
        tmp_path):
    out = tmp_path / "reference.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    run = subprocess.run([sys.executable, "-c", _JAX_SIDE, CASE, str(out)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    with open(out, "rb") as f:
        reference = pickle.load(f)
    check_trajectory(CASE, reference=reference)
