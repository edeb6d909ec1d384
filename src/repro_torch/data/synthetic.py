"""Synthetic data: the counterpart of ``repro/data/synthetic.py``.

* :class:`SyntheticLM` — heterogeneous token streams: a shared order-1
  Markov backbone and a per-agent Dirichlet-tilted unigram;
* :func:`dirichlet_partition` — the paper's §E.3 label-skew partitioner;
* :func:`quadratic_problem` / :func:`logistic_problem` — the paper's §E.1
  and §E.2 problems.

Every table comes from ``np.random.default_rng(seed)`` in the same order
as in the JAX package, so it is identical to the reference's.  Random
draws at run time (tokens, gradient noise) come from a
``torch.Generator`` instead of ``jax.random``, so they differ from the
reference's; tests feed the reference's draws to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLM", "dirichlet_partition", "quadratic_problem",
           "logistic_problem"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    n_agents: int
    phi: float = 1.0          # Dirichlet concentration; smaller = more hetero
    mix: float = 0.5          # weight of the agent-specific unigram tilt
    sharpness: float = 4.0    # Markov logit scale: higher = lower entropy
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 256)  # active head of the vocab
        self._V = V
        self.trans_logits = (rng.normal(size=(V, V)).astype(np.float32)
                             * self.sharpness)
        tilt = rng.dirichlet(np.full(V, self.phi), size=self.n_agents)
        self.tilt_logits = np.log(tilt + 1e-8).astype(np.float32)

    def sample(self, generator: torch.Generator,
               per_agent_batch: int) -> Dict[str, torch.Tensor]:
        """Returns ``{"tokens": (A, b, S) int64}`` on ``generator.device``:
        a uniform first token, then Markov steps drawn by Gumbel-max from
        ``trans[tok]·(1 − mix) + tilt[agent]·mix``."""
        A, b, S, V = self.n_agents, per_agent_batch, self.seq_len, self._V
        dev = generator.device
        trans = torch.as_tensor(self.trans_logits, device=dev)
        tilt = torch.as_tensor(self.tilt_logits, device=dev)[:, None, :]
        tok = torch.randint(0, V, (A, b), generator=generator, device=dev)
        toks = [tok]
        for _ in range(S - 1):
            logits = trans[tok] * (1 - self.mix) + tilt * self.mix
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            tok = (logits + gumbel).argmax(dim=-1)
            toks.append(tok)
        return {"tokens": torch.stack(toks, dim=-1)}


def dirichlet_partition(labels: np.ndarray, n_agents: int, phi: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Paper §E.3: a ``Dir(φ)`` fraction of class k's samples goes to each
    agent.  Returns one index array per agent."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    per_agent: list = [[] for _ in range(n_agents)]
    for k in classes:
        idx = np.where(labels == k)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n_agents, phi))
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for i, part in enumerate(np.split(idx, cuts)):
            per_agent[i].append(part)
    return [np.concatenate(parts) for parts in per_agent]


def _noise(x: torch.Tensor, generator: torch.Generator,
           sigma: float) -> torch.Tensor:
    return sigma * torch.randn(x.shape, generator=generator,
                               device=x.device, dtype=x.dtype)


def _quadratic_tables(n: int, d: int = 10, p: int = 20, c: float = 1.0,
                     seed: int = 0):
    """The §E.1 problem's numpy tables ``(A, b, x_star, zeta2)``, drawn as
    the JAX ``quadratic_problem`` draws them."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, p, d)).astype(np.float32)
    u = rng.normal(size=(n, d)).astype(np.float32)
    AtA = np.einsum("npd,npe->nde", A, A)
    x_star = np.linalg.solve(AtA.sum(0), np.einsum("nde,ne->d", AtA, u))
    x_i = x_star[None] + (u - x_star[None]) / c
    b = np.einsum("npd,nd->np", A, x_i)
    g_at_opt = np.einsum(
        "npd,np->nd", A, np.einsum("npd,d->np", A, x_star) - b) / p
    zeta2 = float(np.mean(np.sum(g_at_opt ** 2, -1)))
    return A, b, x_star, zeta2


def quadratic_problem(n: int, d: int = 10, p: int = 20, c: float = 1.0,
                      sigma: float = 0.05, seed: int = 0, *, device=None
                      ) -> Tuple[Callable, Callable, torch.Tensor, float]:
    """Paper §E.1 linear regression, f_i(x) = ½ E‖y_i − A_i x‖², with
    heterogeneity set by c (x_i* = x* + (u_i − x*)/c).

    Returns ``(stoch_grad(x, generator), full_grad(x), x_star, zeta2)``;
    x is ``(n, d)``, the noise ``sigma·N(0, 1)`` draws from the
    generator.  ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    A, b, x_star, zeta2 = _quadratic_tables(n, d, p, c, seed)
    At = torch.as_tensor(A, device=dev)
    bt = torch.as_tensor(b, device=dev)

    def full_grad(x):
        r = torch.einsum("npd,nd->np", At, x) - bt
        return torch.einsum("npd,np->nd", At, r) / p

    def stoch_grad(x, generator):
        return full_grad(x) + _noise(x, generator, sigma)

    return stoch_grad, full_grad, torch.as_tensor(x_star, device=dev), zeta2


def _logistic_tables(n: int, d: int = 20, m: int = 2000,
                    sigma_h: float = 1.0, seed: int = 0):
    """The §E.2 problem's numpy tables ``(U, v)``, drawn as the JAX
    ``logistic_problem`` draws them."""
    rng = np.random.default_rng(seed)
    x0 = np.ones(d, np.float32)
    xi = x0[None] + sigma_h * rng.normal(size=(n, d)).astype(np.float32)
    U = rng.normal(size=(n, m, d)).astype(np.float32)
    z = rng.uniform(size=(n, m)).astype(np.float32)
    pv = 1.0 / (1.0 + np.exp(-np.einsum("nmd,nd->nm", U, xi)))
    v = np.where(z <= pv, 1.0, -1.0).astype(np.float32)
    return U, v


def logistic_problem(n: int, d: int = 20, m: int = 2000,
                     sigma_h: float = 1.0, mu: float = 0.01,
                     sigma_s: float = 0.1, seed: int = 0, *, device=None):
    """Paper §E.2: ℓ₂-regularized logistic regression, heterogeneity via
    x_i = x₀ + ε_i, ε ~ N(0, σ_h² I); full-batch gradients plus
    ``sigma_s·N(0, 1)`` noise from the generator.

    Returns ``(stoch_grad(x, generator), full_grad(x), mean_loss(x̄))``.
    ``device`` defaults to ``cuda``."""
    dev = resolve_device(device)
    U, v = (torch.as_tensor(t, device=dev)
            for t in _logistic_tables(n, d, m, sigma_h, seed))

    def full_grad(x):
        margins = torch.einsum("nmd,nd->nm", U, x) * v
        coef = -v * torch.sigmoid(-margins)
        return torch.einsum("nmd,nm->nd", U, coef) / m + mu * x

    def stoch_grad(x, generator):
        return full_grad(x) + _noise(x, generator, sigma_s)

    def mean_loss(x):
        margins = torch.einsum("nmd,d->nm", U, x) * v
        return (torch.log1p(torch.exp(-margins)).mean()
                + 0.5 * mu * (x * x).sum())

    return stoch_grad, full_grad, mean_loss
