"""End-to-end driver on the PyTorch port: decentralized EDM training of a
~100M-parameter LM, on a GPU.

The twin of ``examples/decentralized_lm_train.py`` on ``repro_torch``: a
12-layer / d=768 llama-style model (≈108M params, smollm-family at
reduced depth; ``--full``) or its 4-layer / d=256 demo size, across 4
decentralized agents on a ring, on synthetic heterogeneous token streams
(per-agent Dirichlet-tilted unigram over a shared Markov backbone).  The
EDM step runs on the packed bus (per-agent gradients → EDM momentum /
adapt / correct → ring gossip, fused kernels); on the card it is replayed
from CUDA graphs after the first step.  The agents' parameters are then
saved with the port's ``train/checkpoint.py`` and restored.

  PYTHONPATH=src python examples/decentralized_lm_train_torch.py     # cuda
  PYTHONPATH=src python examples/decentralized_lm_train_torch.py \
      --steps 300 --full
  PYTHONPATH=src python examples/decentralized_lm_train_torch.py --device cpu
"""
import argparse
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule,
                               make_topology)
from repro_torch.train.graphs import graph_train_step

CKPT = Path(__file__).resolve().parents[1] / "build" / "edm_lm.npz"


def lm_100m(full: bool) -> ModelConfig:
    """The reference example's two sizes (f32)."""
    return ModelConfig(
        name="edm-lm-108m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab_size=24576, rope_theta=1e4,
        dtype="float32",
    ) if full else ModelConfig(
        name="edm-lm-11m", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=768, vocab_size=8192, rope_theta=1e4, dtype="float32",
    )


def make_run(agents: int, seq: int, batch: int = 1, alpha: float = 0.2,
             beta: float = 0.9, algorithm: str = "edm") -> RunConfig:
    """The example's run: ring, every agent on one device (one-device
    ppermute, so EDM trains on the packed bus), no remat."""
    return RunConfig(global_batch=agents * batch, seq_len=seq,
                     algorithm=algorithm, alpha=alpha, beta=beta,
                     topology="ring", gossip_engine="ppermute",
                     agents_per_device=agents, remat=False)


def train(cfg: ModelConfig, run: RunConfig, agents: int, steps: int,
          sample: Callable[[int], Dict[str, torch.Tensor]], *, device=None,
          state: Optional[dict] = None, log_every: int = 10,
          log: Callable[[str], None] = print
          ) -> Tuple[dict, List[Dict[str, float]]]:
    """``steps`` train steps of ``run`` from ``state`` (default: the seed-0
    init), batch ``t`` from ``sample(t)``; on the card the bus step is
    replayed from CUDA graphs after step 0.  Returns the final state and
    each step's metrics as floats."""
    dev = resolve_device(device)
    model = build_model(cfg)
    if state is None:
        state = init_state(model, run, agents, seed=0, device=dev)
    step_fn = build_train_step(model, run, make_gossip_schedule(run, agents),
                               use_fused_kernel=True, device=dev)
    history = []
    t_start = time.time()
    for t in range(steps):
        batch = sample(t)
        if t == 0 and dev.type == "cuda" and not isinstance(
                state["params"], dict):
            step_fn = graph_train_step(step_fn, state, batch)
        state, metrics = step_fn(state, batch)
        m = {k: float(v) for k, v in metrics.items()}
        history.append(m)
        if t % log_every == 0 or t == steps - 1:
            log(f"step {t:4d}  loss={m['loss']:.4f}  "
                f"consensus={m['consensus']:.3e}  |g|={m['grad_norm']:.3f}  "
                f"({time.time() - t_start:.1f}s)")
    return state, history


def checkpoint_roundtrip(path, cfg: ModelConfig, agents: int,
                         state: dict) -> float:
    """Save the agents' parameters with ``checkpoint.save`` (a bus as its
    parameter leaves), restore them with ``checkpoint.load``, and return
    the largest difference."""
    params = state["params"]
    layout = (None if isinstance(params, dict)
              else bus_layout_for(build_model(cfg), agents))
    checkpoint.save(str(path), params, layout)
    restored = checkpoint.load(str(path), params, layout)
    if layout is None:
        return max(float((restored[p] - v).abs().max())
                   for p, v in params.items())
    return float((restored - params).abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1, help="per-agent batch")
    ap.add_argument("--alpha", type=float, default=0.2)
    ap.add_argument("--beta", type=float, default=0.9)
    ap.add_argument("--algorithm", default="edm")
    ap.add_argument("--full", action="store_true",
                    help="use the ~108M-param config")
    ap.add_argument("--ckpt", default=str(CKPT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_100m(args.full)
    n_p = sum(t.numel() for t in build_model(cfg).meta().values())
    print(f"model {cfg.name}: {n_p / 1e6:.1f}M params, {args.agents} agents "
          f"on a ring, device {dev}")
    run = make_run(args.agents, args.seq, args.batch, args.alpha, args.beta,
                   args.algorithm)
    print(f"topology: ring({args.agents})  "
          f"lambda={make_topology(run, args.agents).lam():.4f}")

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       n_agents=args.agents, phi=0.2)  # heterogeneous
    gen = torch.Generator(device=dev).manual_seed(1)
    state, history = train(cfg, run, args.agents, args.steps,
                           lambda t: data.sample(gen, args.batch),
                           device=dev)

    Path(args.ckpt).parent.mkdir(parents=True, exist_ok=True)
    diff = checkpoint_roundtrip(args.ckpt, cfg, args.agents, state)
    print(f"saved agent-replica params to {args.ckpt}")
    print(f"checkpoint roundtrip max|Δ| = {diff:.1e}")
    return {"state": state, "metrics": history, "roundtrip": diff}


if __name__ == "__main__":
    main()
