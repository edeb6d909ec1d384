"""Paper-figure sweep on the PyTorch port: the Fig. 1-style table of every
algorithm across data heterogeneity, on a GPU.

The twin of ``examples/heterogeneity_sweep.py`` on ``repro_torch``: the
§E.1 quadratic problem over ring(32), stochastic gradients (σ = 0.05),
one row per heterogeneity level ζ², one column per algorithm of
``ALGORITHMS`` (the mean squared distance to the optimum after the last
step).  EDM's and ED's floors stay flat in ζ²; the DmSGD family's grow
with it.

  PYTHONPATH=src python examples/heterogeneity_sweep_torch.py          # cuda
  PYTHONPATH=src python examples/heterogeneity_sweep_torch.py --device cpu
"""
import argparse
from typing import Dict, Sequence

import torch

from repro_torch.core import ALGORITHMS, make_mixer, make_optimizer, ring
from repro_torch.data import quadratic_problem
from repro_torch.device import resolve_device

N_AGENTS = 32
HETEROGENEITY = (100.0, 3.0, 1.0, 0.3)     # c: ζ² grows as c shrinks


def sweep(steps: int = 3000, cs: Sequence[float] = HETEROGENEITY,
          sigma: float = 0.05, algorithms: Sequence[str] = (),
          device=None) -> Dict[float, Dict[str, float]]:
    """``{ζ²: {algorithm: mean_i ||x_i − x*||²}}`` after ``steps`` steps
    of each algorithm (α 0.05, β 0.9, ring(32)) from x = 0, for each
    heterogeneity ``c`` of ``cs``; the gradient noise ``sigma·N(0, 1)``
    draws from one generator seeded 0 per run."""
    dev = resolve_device(device)
    algs = sorted(algorithms or ALGORITHMS)
    table = {}
    for c in cs:
        stoch, _, x_opt, zeta2 = quadratic_problem(N_AGENTS, c=c,
                                                   sigma=sigma, seed=0,
                                                   device=dev)
        row = {}
        for alg in algs:
            opt = make_optimizer(alg, alpha=0.05, beta=0.9,
                                 mix=make_mixer(ring(N_AGENTS)))
            x = torch.zeros(N_AGENTS, x_opt.shape[0], device=dev)
            state = opt.init(x)
            gen = torch.Generator(device=dev).manual_seed(0)
            for _ in range(steps):
                x, state = opt.step(x, stoch(x, gen), state)
            row[alg] = float(((x - x_opt[None]) ** 2).sum(-1).mean())
        table[zeta2] = row
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=3000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"ring({N_AGENTS})  lambda={ring(N_AGENTS).lam():.4f}   "
          "(paper Fig. 1 setup)\n")
    table = sweep(args.steps, device=dev)
    algs = sorted(ALGORITHMS)
    print(f"{'zeta^2':>10s} " + " ".join(f"{a:>10s}" for a in algs))
    for zeta2, row in table.items():
        print(f"{zeta2:10.3f} " + " ".join(f"{row[a]:10.2e}" for a in algs))
    print("\nEDM/ED floors are flat in zeta^2; DmSGD-family floors grow "
          "~ zeta^2.")
    return table


if __name__ == "__main__":
    main()
