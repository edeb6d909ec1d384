"""The train CLI across ranks under ``torchrun --standalone`` on the CPU
(gloo): ``--agents 4 --agents-per-device 1`` and ``--agents pod --pods 2
--shards 2``.  Each run's ``--ckpt`` (gathered to rank 0) equals, array by
array, the one-process CLI run's of the same agents, steps and tokens; a
multi-rank ``--resume`` of the one-process file continues as the
one-process resume does.  The JAX side of these paths is held in
``tests/test_torch_dist_train.py``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import train as tcli

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--arch", "smollm_360m", "--smoke", "--gossip-engine", "ppermute",
        "--fused-kernel", "--seq", "16", "--device", "cpu"]


def _torchrun(args, n=4):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
         *BASE, *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def _same_files(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for f in x.files:
            assert np.array_equal(x[f], y[f]), f


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_cli")
    for n in (4, 2):
        tcli.main(BASE + ["--agents", str(n), "--agents-per-device", str(n),
                          "--steps", "2", "--ckpt", str(d / f"one{n}.npz")])
    tcli.main(BASE + ["--agents", "4", "--agents-per-device", "4",
                      "--steps", "1", "--resume", str(d / "one4.npz"),
                      "--ckpt", str(d / "one4_resumed.npz")])
    return d


def test_cli_four_ranks_equals_one_process(one_process):
    d = one_process
    out = _torchrun(["--agents", "4", "--agents-per-device", "1",
                     "--steps", "2", "--ckpt", str(d / "ranks4.npz")])
    assert "ranks=4 grid=(4,) axes=data agents_per_rank=1" in out
    assert out.count("step ") == 2          # rank 0 prints, once a step
    _same_files(d / "ranks4.npz", d / "one4.npz")
    out = _torchrun(["--agents", "4", "--agents-per-device", "1",
                     "--steps", "1", "--resume", str(d / "one4.npz"),
                     "--ckpt", str(d / "ranks4_resumed.npz")])
    assert "resumed <-" in out
    _same_files(d / "ranks4_resumed.npz", d / "one4_resumed.npz")


def test_cli_pod_agents_equal_one_process(one_process):
    d = one_process
    out = _torchrun(["--agents", "pod", "--pods", "2", "--shards", "2",
                     "--steps", "2", "--ckpt", str(d / "pod.npz")])
    assert "agents=2x2shards" in out and "grid=(2, 2) axes=pod,data" in out
    _same_files(d / "pod.npz", d / "one2.npz")


def test_cli_ranked_run_needs_torchrun():
    env_ws = os.environ.pop("WORLD_SIZE", None)
    try:
        with pytest.raises(ValueError, match="torchrun"):
            tcli.main(BASE + ["--agents", "4", "--agents-per-device", "1",
                              "--steps", "1"])
        with pytest.raises(ValueError, match="torchrun"):
            tcli.main(BASE + ["--agents", "pod", "--pods", "2", "--shards",
                              "2", "--steps", "1"])
    finally:
        if env_ws is not None:
            os.environ["WORLD_SIZE"] = env_ws
