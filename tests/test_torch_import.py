"""The port stands alone and never falls back.

* ``repro_torch`` and every submodule import with no ``jax*``, no
  ``repro.*`` and no ``ml_dtypes`` module loaded (checked in a fresh
  interpreter; the machine with the card may not have ml_dtypes), and no
  source of the package, ``chip_smoke.py`` or an example twin
  (``examples/*_torch.py``) holds such an import.
* Without a GPU, the entry points raise unless the caller asks for the
  CPU by name.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import ring
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import build_train_step, init_state

torch.set_num_threads(1)  # xdist workers share the cores

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)\b(?!_)"
    r"|from\s+(jax|repro|ml_dtypes)(\.\S+)?\s+import\b)",
    re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = ["repro_torch"] + _modules()
    for m in ("repro_torch.kernels.edm_update", "repro_torch.core.wire",
              "repro_torch.core.schedule",
              "repro_torch.kernels.paged_attention",
              "repro_torch.kernels.paged_prefill",
              "repro_torch.serve.engine", "repro_torch.serve.paged_cache",
              "repro_torch.serve.scheduler", "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention", "repro_torch.optim",
              "repro_torch.optim.schedules", "repro_torch.core.metrics",
              "repro_torch.data.synthetic", "repro_torch.train.checkpoint",
              "repro_torch.kernels.ring_dma", "repro_torch.train.graphs",
              "repro_torch.models.encdec", "repro_torch.launch.mesh",
              "repro_torch.launch.collectives", "repro_torch.core.comm",
              "repro_torch.kernels.ring_peer"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.') or m.startswith('ml_dtypes'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_source_imports_jax_or_repro():
    twins = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(twins) == 4
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + twins
    assert len(files) > 20
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    assert _FORBIDDEN.search("from repro.core import bus")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("import ml_dtypes")
    assert not _FORBIDDEN.search("from repro_torch.core import bus")


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_device_resolution(no_gpu):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_entry_points_raise_without_gpu(no_gpu):
    model = build_model(get_smoke_config("smollm_360m"))
    run = RunConfig(gossip_engine="ppermute", agents_per_device=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_train_step(model, run, ring(4), use_fused_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(model, run, 4)
    # asked for by name, the CPU works
    build_train_step(model, run, ring(4), use_fused_kernel=True, device="cpu")


def test_cli_without_device_raises_without_gpu(no_gpu):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm_360m", "--smoke", "--steps", "1", "--agents", "4",
         "--gossip-engine", "ppermute", "--agents-per-device", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert "loss=" not in out.stdout


def test_serving_entry_points_raise_without_gpu(no_gpu):
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   PagedCacheConfig, run_fixed_batch)
    model = build_model(get_smoke_config("smollm_360m"))
    params = model.init(torch.Generator().manual_seed(0))
    pcfg = PagedCacheConfig(page_size=8, num_pages=9, max_slots=2,
                            max_context=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatchingEngine(model, params, pcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fixed_batch(model, params, [], batch_size=1)
    # asked for by name, the CPU works
    ContinuousBatchingEngine(model, params, pcfg, device="cpu")


@pytest.mark.parametrize("flags", [
    ["--continuous-batching", "--prefill-chunk", "8"], []])
def test_serve_cli_without_device_raises_without_gpu(no_gpu, flags):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm_360m", "--smoke", "--requests", "2"] + flags,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
    assert "generated" not in out.stdout


def test_unported_levers_raise():
    from repro_torch.core.comm import GossipMesh
    model = build_model(get_smoke_config("smollm_360m"))
    # the tree across ranks splits agents, never an agent's rows: the tree
    # with agents="pod" (shard_axes) is refused, as the reference asserts
    # (a hand-built grid: the refusal comes before any collective)
    grid = GossipMesh((4,), ("data",), 4, 1, 1, 0, (0,), ((0, 1, 2, 3),),
                      (None,), None, None, torch.device("cpu"), "gloo",
                      False, ("h0",) * 4)
    run = RunConfig(gossip_engine="ppermute", agents_per_device=1,
                    packed_bus=False, agents="pod")
    with pytest.raises(ValueError, match="packed bus only"):
        build_train_step(model, run, ring(4), device="cpu", mesh=grid,
                         shard_axes="data")
    # pod agents and the overlapped pipeline over two devices are ported:
    # they run across ranks, so they need a mesh
    for kw in (dict(agents="pod"),
               dict(overlap="delayed", agents_per_device=2)):
        run = RunConfig(**{"gossip_engine": "ppermute", **kw})
        with pytest.raises(ValueError, match="mesh="):
            build_train_step(model, run, ring(4), device="cpu")
    # ported since: the tree path (shifts engine), the gossip_dtype cast,
    # the LR schedule and the overlap pipeline build
    for kw in (dict(gossip_engine="shifts"), dict(gossip_dtype="bfloat16"),
               dict(warmup_steps=10), dict(algorithm="qg"),
               dict(overlap="delayed")):
        run = RunConfig(**{"gossip_engine": "ppermute",
                           "agents_per_device": 4, **kw})
        build_train_step(model, run, ring(4), device="cpu")


def test_expert_parallel_code_imports_torch_only():
    """The expert-parallel MoE layer and its caller (``models/moe.py``,
    ``core/comm.py``, ``launch/mesh.py``, ``launch/serve.py``,
    ``weights.py``, ``core/metrics.py``) import ``torch`` and the port
    only: in a fresh interpreter their new entry points load with no
    ``jax*`` or ``repro.*`` module, and their sources name none."""
    names = {"repro_torch.models.moe": ("set_moe_mesh", "apply_moe_shard_map",
                                        "expert_axis"),
             "repro_torch.core.comm": ("psum", "sum_grads", "gather_rows",
                                       "shard_rows"),
             "repro_torch.launch.mesh": ("make_moe_mesh", "make_sim_mesh"),
             "repro_torch.models.transformer": ("init_lm_rank",),
             "repro_torch.weights": ("expert_block",),
             "repro_torch.core.metrics": ("grad_norm_at_mean",
                                          "heterogeneity_zeta2",
                                          "consensus_distance_from_dev"),
             "repro_torch.launch.serve": ("main",)}
    code = (
        "import importlib, sys\n"
        f"for m, fns in {names!r}.items():\n"
        "    mod = importlib.import_module(m)\n"
        "    assert all(callable(getattr(mod, f)) for f in fns), m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print('BAD', bad, 'TORCH', 'torch' in sys.modules)\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD [] TORCH True" in out.stdout, out.stdout
    for m in names:
        src = PKG.joinpath(*m.split(".")[1:]).with_suffix(".py")
        assert not _FORBIDDEN.findall(src.read_text()), src


def test_package_docstring_states_device_rule():
    assert "device=\"cpu\"" in repro_torch.__doc__
