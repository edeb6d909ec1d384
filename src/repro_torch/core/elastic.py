"""Elastic gossip: liveness masks, degraded rounds, drop and straggler plans.

The counterpart of ``repro/core/elastic.py`` (DESIGN §8), numpy only like
the port's :mod:`~repro_torch.core.topology`.  The paper's Assumption 1
(W doubly stochastic with a positive diagonal) is what a fleet loses when
an agent drops and its row of W(t) stops summing to one; this module keeps
it through churn:

* :class:`LivenessMask` — one alive bit per agent.
* :func:`degrade_round` — one round's :class:`Topology` rewritten for a
  mask by **survivor-rank rewiring**: a term with linearized shift ``s``
  becomes, on the ``m`` survivors ordered by global index, the rank-space
  rotation by ``s mod m``; dead agents map to themselves.  Every degraded
  term is a permutation of the survivors ⊕ the identity on the dead, so
  the round is doubly stochastic by construction with a positive diagonal,
  and terms whose survivor shift is 0 fold into the self term.
* :class:`DropPlan` — a deterministic step-indexed sequence of liveness
  epochs (``--churn``; JSON round-trippable).
* :class:`ElasticSchedule` — a :class:`GossipSchedule` whose rounds are the
  base schedule's rounds degraded per epoch, with the per-epoch
  Assumption-1 check.
* :class:`StragglerPlan` — step-indexed LATE payload slots of the overlap
  pipeline: a late slot degrades its term to self-weight instead of
  blocking (``complete(..., late=)`` of the overlap mixer).

Dead agents freeze: their x, m and ψ rows ride along under weight-1 self
terms, so re-admission is a checkpoint resize
(:func:`repro_torch.train.checkpoint.resize_state`).  Where the reference
traces a step (``DropPlan.epoch_index``, ``StragglerPlan.late_at``), the
port's step is a Python int: the traced branches are not carried over, and
``late_at`` also gives the mask as a tensor on a device.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import json
from typing import Any, Dict, Iterable, Sequence, Tuple

import numpy as np

from .schedule import GossipSchedule
from .topology import ShiftTerm, Topology, matrix_lam

__all__ = ["LivenessMask", "MaskedTopology", "degrade_round", "is_masked",
           "DropPlan", "ElasticSchedule", "StragglerPlan"]


@dataclasses.dataclass(frozen=True)
class LivenessMask:
    """One alive bit per agent.  ``survivors`` are ordered by global index;
    ``rank`` is each survivor's place on the degraded survivor ring — the
    coordinate :func:`degrade_round`'s rewiring rotates."""

    alive: Tuple[bool, ...]

    @classmethod
    def of(cls, alive: Iterable) -> "LivenessMask":
        return cls(tuple(bool(a) for a in alive))

    @property
    def n(self) -> int:
        return len(self.alive)

    @property
    def m(self) -> int:
        return sum(self.alive)

    @property
    def survivors(self) -> np.ndarray:
        return np.flatnonzero(np.asarray(self.alive, dtype=bool))

    def rank(self) -> np.ndarray:
        """Survivor rank per agent (-1 for the dead)."""
        r = np.full(self.n, -1, dtype=np.int64)
        r[self.survivors] = np.arange(self.m)
        return r


@dataclasses.dataclass(frozen=True)
class MaskedTopology(Topology):
    """A degraded gossip round: per-term source maps and per-agent weight
    columns in place of circulant shifts.

    ``terms[k]`` is ``ShiftTerm("masked", sigma_k, w_k)``, ``sigma_k`` the
    survivor-rank rotation (0 = the self term) and ``w_k`` the survivors'
    weight; ``sources[k][i]`` / ``weights[k][i]`` carry the full per-agent
    map (a dead agent: source itself, weight 1 on the self term and 0
    elsewhere).  ``term_sources`` is overridden, so the dense oracle, the
    shifts engine's gather route and the one-device ppermute engine's
    source table all read the same map."""

    sources: Tuple[Tuple[int, ...], ...] = ()
    weights: Tuple[Tuple[float, ...], ...] = ()
    alive: Tuple[bool, ...] = ()

    def _term_index(self, t: ShiftTerm) -> int:
        # degraded terms are deduped by survivor shift, so index by it
        for k, tk in enumerate(self.terms):
            if tk.shift == t.shift:
                return k
        raise KeyError(t)

    def term_sources(self, t: ShiftTerm) -> np.ndarray:
        return np.asarray(self.sources[self._term_index(t)], dtype=np.int64)

    def term_weights(self, t: ShiftTerm) -> np.ndarray:
        """Per-agent weight column of term ``t`` (a dead agent carries its
        frozen self weight here; the engines apply it agent by agent)."""
        return np.asarray(self.weights[self._term_index(t)],
                          dtype=np.float64)

    def dense_matrix(self) -> np.ndarray:
        n = self.n_agents
        W = np.zeros((n, n), dtype=np.float64)
        idx = np.arange(n)
        for src, w in zip(self.sources, self.weights):
            W[idx, np.asarray(src)] += np.asarray(w)
        return W

    def lam(self) -> float:
        # degraded rounds are asymmetric in general: eigvalsh is wrong
        return matrix_lam(self.dense_matrix())

    def wire_rows(self, agents_per_device: int = 1,
                  engine: str = "ppermute") -> int:
        """Agent-rows on the wire for one application, over all devices.

        With one agent per device the ppermute engine ships one row per
        agent whose source is not itself (one permute per nonzero survivor
        shift); blocked masked rounds (B > 1) and the dense engine gather
        the agent axis instead, the JAX package's fallback (DESIGN §8)."""
        A = self.n_agents
        B = agents_per_device
        if engine == "dense" or (engine == "ppermute" and B > 1):
            return (A - B) * (A // B)
        idx = np.arange(A)
        return sum(int(np.sum(np.asarray(src) != idx)) for src in self.sources)


def is_masked(topo) -> bool:
    """A liveness-masked round (per-agent weight columns)?  Duck-typed on
    ``term_weights``, as the reference's engines test it."""
    return hasattr(topo, "term_weights")


def _linear_shift(t: ShiftTerm, grid_shape: Tuple[int, int]) -> int:
    """A term's shift on the flat agent index: flat and intra shifts move
    by ``shift`` agents, inter shifts by whole pods (``shift · D``)."""
    P, D = grid_shape
    if t.level in ("flat", "intra"):
        return t.shift
    if t.level == "inter":
        return t.shift * D
    raise ValueError(t.level)


def degrade_round(topo: Topology, alive) -> Topology:
    """One gossip round rewritten for the liveness mask ``alive``.

    Survivor-rank rewiring: a term with linearized shift ``s`` maps alive
    agent ``i`` to the survivor ``s`` ranks behind it on the survivor ring
    (``sigma = s mod m``); dead agents map to themselves.  Terms with one
    survivor shift merge (their weights add) and ``sigma = 0`` folds into
    the self term.  Returns ``topo`` itself when every agent is alive, so
    the healthy path stays the unmasked engines'."""
    mask = alive if isinstance(alive, LivenessMask) else LivenessMask.of(alive)
    n = topo.n_agents
    if mask.n != n:
        raise ValueError(f"mask of {mask.n} agents for a round of {n}")
    m = mask.m
    if m < 1:
        raise ValueError("degrade_round needs at least one alive agent")
    if m == n:
        return topo
    surv = mask.survivors
    rank = mask.rank()
    gs = topo.grid_shape()
    dead = np.flatnonzero(~np.asarray(mask.alive, dtype=bool))

    sigma_w: Dict[int, float] = {}
    order: list = []
    for t in topo.terms:
        sigma = _linear_shift(t, gs) % m
        if sigma not in sigma_w:
            sigma_w[sigma] = 0.0
            order.append(sigma)
        sigma_w[sigma] += t.weight
    if not sigma_w.get(0, 0.0) > 0:
        raise ValueError(f"{topo.name}: round has no positive self weight to "
                         "degrade onto")

    terms, sources, weights = [], [], []
    for sigma in order:
        w = sigma_w[sigma]
        src = np.arange(n)
        src[surv] = surv[(rank[surv] - sigma) % m]
        wcol = np.zeros(n)
        wcol[surv] = w
        wcol[dead] = 1.0 if sigma == 0 else 0.0
        terms.append(ShiftTerm("masked", int(sigma), float(w)))
        sources.append(tuple(int(s) for s in src))
        weights.append(tuple(float(x) for x in wcol))
    return MaskedTopology(
        name=f"masked({topo.name},m={m})", n_agents=n, terms=tuple(terms),
        grid=None, sources=tuple(sources), weights=tuple(weights),
        alive=tuple(mask.alive))


# ---------------------------------------------------------------------------
# deterministic churn plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DropPlan:
    """A deterministic step-indexed liveness plan: epochs ``(start_step,
    alive mask)`` in order; the mask of the last epoch whose start is ≤ the
    step applies, and the first epoch starts at 0.

    JSON format (``--churn``: a path, an inline string or a dict)::

        {"n_agents": 8,
         "epochs": [{"start": 0, "down": []},
                    {"start": 8, "down": [3, 5]}]}

    (``"alive": [...]`` is taken in place of ``"down"``.)"""

    n_agents: int
    epochs: Tuple[Tuple[int, Tuple[bool, ...]], ...]

    def __post_init__(self):
        if not self.epochs:
            raise ValueError("DropPlan needs at least one epoch")
        starts = [s for s, _ in self.epochs]
        if starts[0] != 0:
            raise ValueError(f"first epoch must start at step 0: {starts}")
        if not all(a < b for a, b in zip(starts, starts[1:])):
            raise ValueError(f"epoch starts must be strictly increasing: "
                             f"{starts}")
        for s, alive in self.epochs:
            if len(alive) != self.n_agents:
                raise ValueError(f"epoch @{s}: {len(alive)} bits for "
                                 f"{self.n_agents} agents")
            if not any(alive):
                raise ValueError(f"epoch @{s} leaves no agent alive")

    @property
    def n_epochs(self) -> int:
        return len(self.epochs)

    @property
    def starts(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in self.epochs)

    def epoch_index(self, step: int) -> int:
        """The epoch that holds ``step``."""
        return bisect.bisect_right(self.starts, int(step)) - 1

    def alive_at(self, step: int) -> np.ndarray:
        return np.asarray(self.epochs[self.epoch_index(step)][1], dtype=bool)

    def always_alive(self) -> np.ndarray:
        """Agents alive in every epoch."""
        acc = np.ones(self.n_agents, dtype=bool)
        for _, alive in self.epochs:
            acc &= np.asarray(alive, dtype=bool)
        return np.flatnonzero(acc)

    # ---- construction / serialization -----------------------------------
    @classmethod
    def from_events(cls, n_agents: int,
                    events: Sequence[Tuple[int, Iterable[int]]]) -> "DropPlan":
        """``events`` = [(start_step, down_agent_ids), ...]."""
        epochs = []
        for start, down in events:
            alive = np.ones(n_agents, dtype=bool)
            alive[list(down)] = False
            epochs.append((int(start), tuple(bool(a) for a in alive)))
        return cls(n_agents, tuple(epochs))

    @classmethod
    def from_json(cls, spec: Any) -> "DropPlan":
        """A dict, an inline JSON string, or the path of a JSON file."""
        if isinstance(spec, str):
            if spec.lstrip().startswith("{"):
                spec = json.loads(spec)
            else:
                with open(spec) as f:
                    spec = json.load(f)
        n = int(spec["n_agents"])
        epochs = []
        for e in spec["epochs"]:
            if "alive" in e:
                alive = tuple(bool(a) for a in e["alive"])
            else:
                mask = np.ones(n, dtype=bool)
                mask[list(e.get("down", []))] = False
                alive = tuple(bool(a) for a in mask)
            epochs.append((int(e["start"]), alive))
        return cls(n, tuple(epochs))

    def to_json(self) -> dict:
        return {"n_agents": self.n_agents,
                "epochs": [{"start": s,
                            "down": [int(i) for i in
                                     np.flatnonzero(~np.asarray(a, bool))]}
                           for s, a in self.epochs]}

    @classmethod
    def random(cls, n_agents: int, drop_rate: float, *, seed: int = 0,
               n_epochs: int = 4, epoch_len: int = 8,
               min_alive: int = 2) -> "DropPlan":
        """Deterministic random churn: each epoch drops each agent past the
        first ``min_alive`` (the anchors, never dropped) with probability
        ``drop_rate``, drawn from numpy's ``default_rng(seed)`` as the
        reference draws."""
        if not 0.0 <= drop_rate < 1.0:
            raise ValueError(f"drop_rate {drop_rate} not in [0, 1)")
        if not 1 <= min_alive <= n_agents:
            raise ValueError(f"min_alive {min_alive} not in [1, {n_agents}]")
        rng = np.random.default_rng(seed)
        epochs = []
        for e in range(n_epochs):
            alive = np.ones(n_agents, dtype=bool)
            if drop_rate > 0.0:
                roll = rng.random(n_agents) < drop_rate
                roll[:min_alive] = False
                alive &= ~roll
            epochs.append((e * epoch_len, tuple(bool(a) for a in alive)))
        return cls(n_agents, tuple(epochs))


# ---------------------------------------------------------------------------
# liveness-masked schedule
# ---------------------------------------------------------------------------

class ElasticSchedule(GossipSchedule):
    """A base :class:`GossipSchedule` degraded per :class:`DropPlan` epoch.

    ``rounds`` is (epoch × base round) flattened: the round of global step
    t is ``epoch_index(t) · base.period + t % base.period``.  Epoch starts
    are multiples of the base period, so the mask is constant across each
    period and Assumption 1 transfers per epoch: the period product on
    that epoch's survivors is doubly stochastic with a spectral gap > 0
    whenever ≥ 2 agents survive."""

    def __init__(self, base: GossipSchedule, plan: DropPlan):
        if plan.n_agents != base.n_agents:
            raise ValueError(f"plan of {plan.n_agents} agents for a "
                             f"schedule of {base.n_agents}")
        p = base.period
        for start, _ in plan.epochs:
            if start % p:
                raise ValueError(
                    f"epoch start {start} must align to the base period {p} "
                    "(the liveness mask must be constant across each period)")
        rounds = tuple(degrade_round(r, alive)
                       for _, alive in plan.epochs for r in base.rounds)
        super().__init__(name=f"elastic({base.name})",
                         n_agents=base.n_agents, rounds=rounds)
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "plan", plan)

    def round_index(self, step: int) -> int:
        p = self.base.period
        return self.plan.epoch_index(step) * p + int(step) % p

    def round(self, step: int) -> Topology:
        return self.rounds[self.round_index(step)]

    # ---- per-epoch Assumption-1 transfer ---------------------------------
    def epoch_rounds(self, e: int) -> Tuple[Topology, ...]:
        p = self.base.period
        return self.rounds[e * p:(e + 1) * p]

    def epoch_product(self, e: int) -> np.ndarray:
        W = np.eye(self.n_agents)
        for topo in self.epoch_rounds(e):
            W = topo.dense_matrix() @ W
        return W

    def epoch_stats(self) -> list:
        """Per-epoch survivor-block spectral stats: the degraded λ with
        which EDM's bounds transfer for that epoch."""
        out = []
        for e, (start, alive) in enumerate(self.plan.epochs):
            surv = np.flatnonzero(np.asarray(alive, bool))
            sub = self.epoch_product(e)[np.ix_(surv, surv)]
            lam = matrix_lam(sub) if len(surv) > 1 else 0.0
            out.append({"epoch": e, "start": start, "alive": len(surv),
                        "lambda": lam, "gap": 1.0 - lam})
        return out

    def product_spectral_stats(self) -> dict:
        stats = self.epoch_stats()
        return {
            "name": self.name,
            "n": self.n_agents,
            "period": self.base.period,
            "epochs": self.plan.n_epochs,
            "lambda": max(s["lambda"] for s in stats),
            "gap": min(s["gap"] for s in stats),
            "permutes_per_step": max(
                sum(1 for t in r.terms if t.shift != 0) for r in self.rounds),
        }

    def check_assumption1(self, atol: float = 1e-10) -> None:
        """Assumption 1 under churn (DESIGN §8): every degraded round is
        doubly stochastic, nonnegative, with a positive diagonal, and the
        identity on its dead rows and columns; each epoch's period product
        on its survivors is doubly stochastic with a spectral gap > 0
        whenever ≥ 2 agents survive it.  Raises ``AssertionError``."""
        n = self.n_agents
        ones = np.ones(n)
        for e, (start, alive) in enumerate(self.plan.epochs):
            surv = np.flatnonzero(np.asarray(alive, bool))
            dead = np.flatnonzero(~np.asarray(alive, bool))
            m = len(surv)
            for r, topo in enumerate(self.epoch_rounds(e)):
                W = topo.dense_matrix()
                tag = f"{self.name} epoch {e} round {r}"
                assert np.allclose(W @ ones, ones, atol=atol), \
                    f"{tag}: W 1 != 1"
                assert np.allclose(ones @ W, ones, atol=atol), \
                    f"{tag}: 1ᵀ W != 1ᵀ"
                assert np.all(W >= -atol), f"{tag}: negative w_ij"
                assert np.all(np.diag(W) > 0), f"{tag}: w_ii = 0"
                if len(dead):
                    eye = np.eye(n)
                    assert np.array_equal(W[dead], eye[dead]), \
                        f"{tag}: dead rows not identity"
                    assert np.array_equal(W[:, dead], eye[:, dead]), \
                        f"{tag}: dead columns not identity"
            if m >= 2:
                sub = self.epoch_product(e)[np.ix_(surv, surv)]
                mo = np.ones(m)
                assert np.allclose(sub @ mo, mo, atol=atol), \
                    f"{self.name} epoch {e}: survivor product not " \
                    "row-stochastic"
                assert np.allclose(mo @ sub, mo, atol=atol), \
                    f"{self.name} epoch {e}: survivor product not " \
                    "col-stochastic"
                gap = 1.0 - matrix_lam(sub)
                assert gap > atol, \
                    f"{self.name} epoch {e}: survivor product not " \
                    f"contracting (gap={gap})"


# ---------------------------------------------------------------------------
# straggler plans (overlap pipeline, DESIGN §8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StragglerPlan:
    """Step-indexed LATE payload slots of the overlap pipeline.

    ``late[(step, (k, ...))]`` marks slots ``k`` of the payload stack late
    at ``step``: the combine takes each late slot from the round's self
    payload under the slot's own weight — the self-weight absorption
    ``W + Σ_late w_k (I − P_k)``, which stays doubly stochastic and never
    multiplies the late buffer, so a straggler degrades the mix instead of
    blocking or poisoning the step.  ``n_terms`` is the overlap mixer's
    stack arity K (``complete.n_terms``)."""

    n_terms: int
    late: Tuple[Tuple[int, Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        for step, ks in self.late:
            if step < 0 or not all(0 <= k < self.n_terms for k in ks):
                raise ValueError(f"late slots {ks} at step {step} outside "
                                 f"[0, {self.n_terms})")

    @functools.cached_property
    def _table(self) -> np.ndarray:
        """(T+1, K) bool; row T (all False) is every later step's."""
        T = 1 + max((s for s, _ in self.late), default=-1)
        tab = np.zeros((T + 1, self.n_terms), dtype=bool)
        for step, ks in self.late:
            tab[step, list(ks)] = True
        return tab

    @classmethod
    def from_json(cls, spec: Any, n_terms: int) -> "StragglerPlan":
        """A dict, an inline JSON string, or the path of a JSON file:
        ``{"late": [[step, [slot, ...]], ...]}`` (an ``n_terms`` key, if
        present, must equal ``n_terms``, the overlap stack's arity K)."""
        if isinstance(spec, str):
            if spec.lstrip().startswith("{"):
                spec = json.loads(spec)
            else:
                with open(spec) as f:
                    spec = json.load(f)
        if int(spec.get("n_terms", n_terms)) != n_terms:
            raise ValueError(f"straggler plan for {spec['n_terms']} slots, "
                             f"the overlap stack has K = {n_terms}")
        return cls(n_terms, tuple((int(step), tuple(int(k) for k in ks))
                                  for step, ks in spec["late"]))

    def late_at(self, step: int, device=None):
        """(K,) bool late mask of ``step``: a numpy array, or a bool tensor
        on ``device`` when one is given."""
        tab = self._table
        row = tab[min(int(step), tab.shape[0] - 1)].copy()
        if device is None:
            return row
        import torch
        return torch.as_tensor(row, device=device)
