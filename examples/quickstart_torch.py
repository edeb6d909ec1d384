"""Quickstart on the PyTorch port — the paper in 60 seconds, on a GPU.

The twin of ``examples/quickstart.py`` on ``repro_torch``: EDM against
DmSGD on the paper's §E.1 quadratic problem over a sparse ring of 32
agents with strong data heterogeneity and full-batch gradients (σ = 0).
EDM (bias-corrected) reaches the exact optimum; DmSGD stalls at the
heterogeneity floor.

  PYTHONPATH=src python examples/quickstart_torch.py            # on cuda
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
from typing import Dict

import torch

from repro_torch.core import make_mixer, make_optimizer, ring
from repro_torch.data import quadratic_problem
from repro_torch.device import resolve_device

N_AGENTS = 32


def run(alg: str, steps: int = 3001, every: int = 500, device=None
        ) -> Dict[int, float]:
    """``alg`` on §E.1's quadratic over ring(32): the mean squared
    distance to the optimum, ``mean_i ||x_i - x*||^2``, at every
    ``every``-th step (step t is after t + 1 updates, as the JAX
    quickstart prints it)."""
    dev = resolve_device(device)
    _, full, x_opt, _ = quadratic_problem(N_AGENTS, c=1.0, sigma=0.0,
                                          seed=0, device=dev)
    opt = make_optimizer(alg, alpha=0.05, beta=0.9,
                         mix=make_mixer(ring(N_AGENTS)))
    x = torch.zeros(N_AGENTS, x_opt.shape[0], device=dev)
    state = opt.init(x)
    errs = {}
    for t in range(steps):
        x, state = opt.step(x, full(x), state)
        if t % every == 0:
            errs[t] = float(((x - x_opt[None]) ** 2).sum(-1).mean())
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=3001)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    lam = ring(N_AGENTS).lam()
    print(f"ring({N_AGENTS}): lambda = {lam:.4f}  spectral gap = "
          f"{1.0 - lam:.4f}")
    _, _, _, zeta2 = quadratic_problem(N_AGENTS, c=1.0, sigma=0.0, seed=0,
                                       device=dev)
    print(f"data heterogeneity  zeta^2 = {zeta2:.2f}\n")
    out = {}
    for alg in ("edm", "dmsgd"):
        print(f"--- {alg} ---")
        out[alg] = run(alg, args.steps, device=dev)
        for t, err in out[alg].items():
            print(f"  step {t:5d}  mean ||x_i - x*||^2 = {err:.3e}")
        print()
    return out


if __name__ == "__main__":
    main()
