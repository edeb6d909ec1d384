"""Communication topologies (mixing matrices W): a copy of
``repro/core/topology.py``.

The original is numpy-only, but importing it loads the JAX package's
``core`` (and so ``jax``); the port keeps this copy.  W is symmetric,
doubly stochastic, with positive spectrum (the paper's Assumption 1), and
is held two ways:

* ``dense_matrix()`` — the explicit (n, n) matrix (the dense engine, the
  spectral checks);
* ``terms`` — a tuple of :class:`ShiftTerm` writing W as a weighted sum of
  rolls of the agent axis, which is what the shift engines apply.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["ShiftTerm", "Topology", "ring", "exp_graph", "torus2d",
           "fully_connected", "hierarchical", "disconnected", "matrix_lam",
           "spectral_stats"]


def matrix_lam(W: np.ndarray) -> float:
    """Second largest eigenvalue *modulus* of a stochastic matrix.

    Unlike :meth:`Topology.lam` this does not assume symmetry: it is the λ
    of the period products of time-varying schedules
    (``GossipSchedule.period_product``), which are asymmetric whenever a
    round is (the one-peer exp rounds are ½I + ½R).
    """
    if W.shape[0] <= 1:
        return 0.0
    ev = np.sort(np.abs(np.linalg.eigvals(W)))
    return float(ev[-2])


@dataclasses.dataclass(frozen=True)
class ShiftTerm:
    """One ``weight * roll(x, shift)`` term of a circulant-expressible W.

    level:
      "flat"  — roll over the flattened agent axis (all A agents in a ring)
      "intra" — roll within each pod (agent grid reshaped to (P, D), axis=1)
      "inter" — roll across pods  (axis=0 of the (P, D) grid)
    """

    level: str
    shift: int
    weight: float


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    n_agents: int
    terms: Tuple[ShiftTerm, ...]
    # (P, D) factorization of the agent axis for intra/inter terms; None for flat.
    grid: Optional[Tuple[int, int]] = None

    def grid_shape(self) -> Tuple[int, int]:
        """(P, D) factorization of the agent axis (grid, or (1, n) for flat)."""
        if self.grid is None:
            return 1, self.n_agents
        P, D = self.grid
        assert P * D == self.n_agents, (P, D, self.n_agents)
        return P, D

    def term_sources(self, t: ShiftTerm) -> np.ndarray:
        """``src[i]`` = agent whose payload lands on agent ``i`` under term
        ``t`` (roll semantics: ``x_new[i] = x[(i - shift) % n]``, which is
        what ``torch.roll(x, shift, 0)`` gives)."""
        n = self.n_agents
        idx = np.arange(n)
        P, D = self.grid_shape()
        p_idx, d_idx = idx // D, idx % D
        if t.level == "flat":
            return (idx - t.shift) % n
        if t.level == "intra":
            return p_idx * D + (d_idx - t.shift) % D
        if t.level == "inter":
            return ((p_idx - t.shift) % P) * D + d_idx
        raise ValueError(t.level)

    def dense_matrix(self) -> np.ndarray:
        n = self.n_agents
        W = np.zeros((n, n), dtype=np.float64)
        idx = np.arange(n)
        for t in self.terms:
            W[idx, self.term_sources(t)] += t.weight
        return W

    def eigenvalues(self) -> np.ndarray:
        return np.linalg.eigvalsh(self.dense_matrix())

    def lam(self) -> float:
        """Second largest |eigenvalue| — the paper's λ."""
        ev = np.sort(np.abs(self.eigenvalues()))
        return float(ev[-2]) if self.n_agents > 1 else 0.0

    def spectral_gap(self) -> float:
        """1 − λ: how far one mix contracts the disagreement."""
        return 1.0 - self.lam()

    def min_eigenvalue(self) -> float:
        return float(self.eigenvalues().min())

    def check_assumption1(self, atol: float = 1e-10) -> None:
        """Validate the paper's Assumption 1 (symmetric, doubly stochastic,
        positive diagonal, PSD)."""
        W = self.dense_matrix()
        n = self.n_agents
        assert np.allclose(W, W.T, atol=atol), "W must be symmetric"
        assert np.allclose(W @ np.ones(n), np.ones(n), atol=atol), "W 1 = 1"
        assert np.all(np.diag(W) > 0), "w_ii > 0"
        assert self.min_eigenvalue() > -atol, "W must be PSD (Assumption 1(3))"

    def lazify(self) -> "Topology":
        """Return W~ = (W + I)/2 — the paper's Remark 1 transform guaranteeing
        a positive spectrum for any symmetric doubly-stochastic W."""
        new_terms = tuple(
            ShiftTerm(t.level, t.shift, t.weight * 0.5) for t in self.terms
        ) + (ShiftTerm("flat", 0, 0.5),)
        return Topology(f"lazy({self.name})", self.n_agents, new_terms, self.grid)


def ring(n: int) -> Topology:
    """Paper's experimental topology: w_ii=1/2, w_{i,i±1}=1/4."""
    if n == 1:
        return Topology("ring", 1, (ShiftTerm("flat", 0, 1.0),))
    if n == 2:
        return Topology("ring", 2, (ShiftTerm("flat", 0, 0.5), ShiftTerm("flat", 1, 0.5)))
    terms = (
        ShiftTerm("flat", 0, 0.5),
        ShiftTerm("flat", 1, 0.25),
        ShiftTerm("flat", -1, 0.25),
    )
    return Topology("ring", n, terms)


def exp_graph(n: int) -> Topology:
    """Symmetric one-peer-per-power-of-two exponential graph: i ↔ i ± 2^j,
    uniform weights, lazified when not PSD."""
    if n == 1:
        return Topology("exp", 1, (ShiftTerm("flat", 0, 1.0),))
    offsets = []
    j = 1
    while j <= n // 2:
        offsets.append(j)
        j *= 2
    uniq = []
    for o in offsets:
        uniq.append(o)
        if (n - o) % n != o:  # avoid duplicating the antipode
            uniq.append(-o)
    w = 1.0 / (len(uniq) + 1)
    terms = [ShiftTerm("flat", 0, w)] + [ShiftTerm("flat", o, w) for o in uniq]
    topo = Topology("exp", n, tuple(terms))
    if topo.min_eigenvalue() < 0:
        topo = topo.lazify()
    return topo


def torus2d(p: int, d: int) -> Topology:
    """2-D torus over a (p, d) agent grid: self 1/3, each of 4 neighbors 1/6."""
    n = p * d
    terms = [ShiftTerm("flat", 0, 1.0 / 3)]
    for lvl, size in (("inter", p), ("intra", d)):
        if size == 1:
            terms[0] = ShiftTerm("flat", 0, terms[0].weight + 1.0 / 3)
            continue
        if size == 2:
            terms.append(ShiftTerm(lvl, 1, 1.0 / 3))
        else:
            terms.append(ShiftTerm(lvl, 1, 1.0 / 6))
            terms.append(ShiftTerm(lvl, -1, 1.0 / 6))
    topo = Topology("torus2d", n, tuple(terms), grid=(p, d))
    if topo.min_eigenvalue() < 0:
        topo = topo.lazify()
    return topo


def fully_connected(n: int) -> Topology:
    """W = (1/n) 11ᵀ as n flat shifts — exact averaging."""
    terms = tuple(ShiftTerm("flat", s, 1.0 / n) for s in range(n))
    return Topology("full", n, terms)


def hierarchical(pods: int, per_pod: int, c: float = 0.5,
                 intra: str = "full") -> Topology:
    """W = c · (I_P ⊗ W_intra) + (1-c) · (W_ring_pods ⊗ I_D)."""
    n = pods * per_pod
    terms: List[ShiftTerm] = []
    if per_pod == 1:
        terms.append(ShiftTerm("flat", 0, c))
    elif intra == "full":
        for s in range(per_pod):
            terms.append(ShiftTerm("intra", s, c / per_pod))
    else:  # intra ring
        rw = ring(per_pod)
        for t in rw.terms:
            terms.append(ShiftTerm("intra", t.shift, c * t.weight))
    if pods == 1:
        terms.append(ShiftTerm("flat", 0, 1.0 - c))
    else:
        rp = ring(pods)
        for t in rp.terms:
            terms.append(ShiftTerm("inter", t.shift, (1.0 - c) * t.weight))
    return Topology("hier", n, tuple(terms), grid=(pods, per_pod))


def disconnected(n: int) -> Topology:
    """W = I — no communication (local SGD); for ablations."""
    return Topology("disconnected", n, (ShiftTerm("flat", 0, 1.0),))


def spectral_stats(topo: Topology) -> dict:
    """The round's spectrum in brief: name, agent count, λ, the spectral
    gap 1 − λ and the least eigenvalue of W."""
    return {
        "name": topo.name,
        "n": topo.n_agents,
        "lambda": topo.lam(),
        "gap": topo.spectral_gap(),
        "min_eig": float(topo.eigenvalues().min()),
    }
