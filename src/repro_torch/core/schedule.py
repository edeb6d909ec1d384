"""Step-indexed gossip schedules: time-varying mixing matrices W(t).

A copy of ``repro/core/schedule.py`` (numpy only, but importing it loads
the JAX package's ``core`` and so ``jax``).  A schedule maps ``step ->
round``, where each round is a :class:`~repro_torch.core.topology.Topology`
with its own ``ShiftTerm`` set, dense oracle matrix and permute plan, so
every mixing engine consumes a round unchanged (DESIGN §4).

Schedules:

* :class:`StaticSchedule` — period 1, wraps one topology.
* :class:`RoundRobinExp` — one-peer-per-round exponential graph: round j
  gossips only over offset 2^j, ONE permute per step, and for n = 2^k the
  period product is exact averaging.
* :class:`AlternatingHierarchical` — intra-pod rounds interleaved with
  one inter-pod round.

Assumption-1 transfer: every round is doubly stochastic with a positive
diagonal, and the **period product** ``W(p-1) ... W(0)`` has a spectral
gap > 0, which :meth:`GossipSchedule.check_assumption1` checks.
:func:`wire_bytes_per_step` models the bytes one gossip round puts on the
wire, per engine and wire codec; :func:`group_wire_bytes_per_step` the
bytes of each policy group of a grouped bus (DESIGN §12).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .topology import (ShiftTerm, Topology, exp_graph, matrix_lam, ring)

__all__ = [
    "GossipSchedule", "StaticSchedule", "RoundRobinExp",
    "AlternatingHierarchical", "make_schedule", "SCHEDULES",
    "term_wire_rows", "wire_bytes_per_step", "group_wire_bytes_per_step",
]


@dataclasses.dataclass(frozen=True)
class GossipSchedule:
    """A periodic sequence of gossip rounds; ``round(step)`` indexes it.

    ``rounds[r]`` is a full :class:`Topology`, so the dense oracle, the
    shift engine and the ppermute plan of round r all derive from the same
    ``ShiftTerm`` set — the engines cannot drift from the oracle at any
    round index.
    """

    name: str
    n_agents: int
    rounds: Tuple[Topology, ...]

    @property
    def period(self) -> int:
        return len(self.rounds)

    def round_index(self, step: int):
        """Round index for global step ``step``."""
        return step % self.period

    def round(self, step: int) -> Topology:
        """The mixing topology W(t) applied at global step ``step``."""
        return self.rounds[int(step) % self.period]

    # ---- period-product spectral properties ------------------------------
    def period_product(self) -> np.ndarray:
        """Dense product W(p-1) @ ... @ W(0) — the per-period mixing map."""
        W = np.eye(self.n_agents)
        for topo in self.rounds:
            W = topo.dense_matrix() @ W
        return W

    def product_lam(self) -> float:
        """Second largest eigenvalue modulus of the period product (the
        product is not symmetric in general, so moduli — not eigvalsh)."""
        return matrix_lam(self.period_product())

    def product_spectral_gap(self) -> float:
        return 1.0 - self.product_lam()

    def product_spectral_stats(self) -> dict:
        W = self.period_product()
        return {
            "name": self.name,
            "n": self.n_agents,
            "period": self.period,
            "lambda": matrix_lam(W),
            "gap": 1.0 - matrix_lam(W),
            "permutes_per_step": max(
                sum(1 for t in r.terms if t.shift != 0) for r in self.rounds),
        }

    # ---- Assumption 1 transfer -------------------------------------------
    def check_assumption1(self, atol: float = 1e-10) -> None:
        """Schedule form of the paper's Assumption 1: every round is doubly
        stochastic with nonnegative entries and positive diagonal, and the
        period product has spectral gap > 0 (so consensus contracts every
        period and EDM's bounds apply with λ = product λ^(1/p))."""
        n = self.n_agents
        ones = np.ones(n)
        for r, topo in enumerate(self.rounds):
            W = topo.dense_matrix()
            assert np.allclose(W @ ones, ones, atol=atol), \
                f"{self.name} round {r}: W 1 != 1"
            assert np.allclose(ones @ W, ones, atol=atol), \
                f"{self.name} round {r}: 1ᵀ W != 1ᵀ"
            assert np.all(W >= -atol), f"{self.name} round {r}: negative w_ij"
            assert np.all(np.diag(W) > 0), f"{self.name} round {r}: w_ii = 0"
        if n > 1:
            gap = self.product_spectral_gap()
            assert gap > atol, \
                f"{self.name}: period product not contracting (gap={gap})"


class StaticSchedule(GossipSchedule):
    """Period-1 schedule wrapping one fixed topology (today's behavior)."""

    def __init__(self, topo: Topology):
        super().__init__(name=f"static({topo.name})", n_agents=topo.n_agents,
                         rounds=(topo,))


class RoundRobinExp(GossipSchedule):
    """One-peer round-robin exponential schedule.

    Round j applies  W_j = ½ I + ½ R_{o_j}  with the offsets o_j cycling
    through the powers of two {1, 2, 4, ..., 2^(L-1)}, L = ⌈log₂ n⌉: one
    nonzero-shift term — one collective-permute — per step, an O(log n)×
    per-step wire-byte cut over the static exp graph.  The rounds are
    circulant and therefore commute, so the period product is independent
    of the offset order; for n a power of two it equals (1/n)·11ᵀ — exact
    averaging every L steps.  ``seed`` shuffles the offset order (a wire-
    schedule knob: it changes which link is hot when, never the product).
    """

    def __init__(self, n: int, seed: Optional[int] = None):
        offsets = []
        j = 1
        while j < n:
            offsets.append(j)
            j *= 2
        if not offsets:
            offsets = [0]
        if seed is not None:
            offsets = list(np.random.default_rng(seed).permutation(offsets))
        rounds = []
        for o in offsets:
            if o == 0:
                terms: Tuple[ShiftTerm, ...] = (ShiftTerm("flat", 0, 1.0),)
            else:
                terms = (ShiftTerm("flat", 0, 0.5), ShiftTerm("flat", o, 0.5))
            rounds.append(Topology(f"exp1peer[{o}]", n, terms))
        super().__init__(name=f"round_robin_exp({n})", n_agents=n,
                         rounds=tuple(rounds))


class AlternatingHierarchical(GossipSchedule):
    """``intra_every`` intra-pod rounds followed by one inter-pod round.

    Intra rounds mix only inside each pod (I_P ⊗ W_intra — pure ICI,
    zero DCI bytes); the closing inter round mixes the pod ring
    (W_ring(P) ⊗ I_D — the only DCI traffic of the period).  Every round is
    symmetric doubly stochastic PSD, so the product is doubly stochastic;
    connectivity over the period gives it a positive spectral gap.
    """

    def __init__(self, pods: int, per_pod: int, intra_every: int = 1,
                 intra: str = "ring"):
        assert pods >= 1 and per_pod >= 1 and intra_every >= 1
        n = pods * per_pod
        grid = (pods, per_pod)

        if per_pod == 1:
            intra_terms: Tuple[ShiftTerm, ...] = (ShiftTerm("flat", 0, 1.0),)
        elif intra == "full":
            intra_terms = tuple(ShiftTerm("intra", s, 1.0 / per_pod)
                                for s in range(per_pod))
        else:
            intra_terms = tuple(ShiftTerm("intra", t.shift, t.weight)
                                for t in ring(per_pod).terms)
        intra_round = Topology("alt_intra", n, intra_terms, grid=grid)

        if pods == 1:
            inter_terms: Tuple[ShiftTerm, ...] = (ShiftTerm("flat", 0, 1.0),)
        else:
            inter_terms = tuple(ShiftTerm("inter", t.shift, t.weight)
                                for t in ring(pods).terms)
        inter_round = Topology("alt_inter", n, inter_terms, grid=grid)

        super().__init__(name=f"alt_hier({pods}x{per_pod})", n_agents=n,
                         rounds=(intra_round,) * intra_every + (inter_round,))


# ---------------------------------------------------------------------------
# registry / config-level constructor
# ---------------------------------------------------------------------------

SCHEDULES = ("static", "round_robin", "alt_hier")


def make_schedule(name: str, n_agents: int, *, topo: Optional[Topology] = None,
                  pods: int = 1, period: int = 0,
                  seed: int = 0) -> GossipSchedule:
    """Config-level schedule constructor (``RunConfig.gossip_schedule``).

    ``static`` wraps ``topo`` (falls back to the static exp graph);
    ``round_robin`` builds :class:`RoundRobinExp` (``seed`` != 0 shuffles the
    offset order); ``alt_hier`` builds :class:`AlternatingHierarchical` with
    ``period`` intra rounds per inter round (0 → 1).
    """
    if name in ("static", "", None):
        return StaticSchedule(topo if topo is not None else exp_graph(n_agents))
    if name == "round_robin":
        return RoundRobinExp(n_agents, seed=seed or None)
    if name == "alt_hier":
        assert pods >= 1 and n_agents % pods == 0, (n_agents, pods)
        return AlternatingHierarchical(pods, n_agents // pods,
                                       intra_every=period or 1)
    raise ValueError(f"unknown gossip schedule {name!r}; have {SCHEDULES}")


# ---------------------------------------------------------------------------
# wire-byte model (ppermute engine; DESIGN §4 table)
# ---------------------------------------------------------------------------

def term_wire_rows(topo: Topology, t: ShiftTerm,
                   agents_per_device: int = 1) -> int:
    """Agent-rows each device transmits for one gossip term under the
    ppermute engine.

    Unblocked (one agent per device) every nonzero-shift term ships the full
    one-agent payload.  Blocked (B agents per device) a flat roll by s
    decomposes as s = qB + r: the B−r rows bound for device d−q plus the r
    boundary rows bound for d−q−1, with whichever part is device-local
    (q ≡ 0 or q+1 ≡ 0 mod ring) costing nothing — so sub-block shifts
    (|s| < B, e.g. the ring's ±1) ship only the r boundary rows.  Intra
    terms that fit whole pods on a device are free.
    """
    if t.shift == 0 or topo.n_agents == 1:
        return 0
    B = agents_per_device
    if B == 1:
        return 1
    P, D = topo.grid_shape()
    A = topo.n_agents
    assert A % B == 0, (A, B)
    if t.level == "intra":
        if B % D == 0:          # whole pods per device: local roll
            return 0
        assert D % B == 0, (D, B)
        n_ring, shift = D // B, t.shift % D
    elif t.level == "inter":
        n_ring, shift = A // B, (t.shift * D) % A
    else:
        n_ring, shift = A // B, t.shift % A
    q, r = divmod(shift, B)
    rows = 0
    if q % n_ring:
        rows += B - r
    if r and (q + 1) % n_ring:
        rows += r
    return rows


def wire_bytes_per_step(sched: GossipSchedule, step: int, *,
                        elems_per_agent: int, itemsize: int = 4,
                        agents_per_device: int = 1,
                        engine: str = "ppermute", codec=None) -> int:
    """Total bytes on the wire (summed over devices) for one gossip
    application at ``step``.

    Model: ``ppermute`` counts the rows each device actually ships
    (:func:`term_wire_rows`); ``shifts`` lowers every nonzero roll to a
    full-payload collective-permute (GSPMD; equals ppermute at B = 1);
    ``dense`` needs every remote row — an all-gather.

    ``codec`` (a :class:`repro_torch.core.wire.WireCodec`, DESIGN §9)
    derives the per-agent payload bytes from the wire dtype plus the int8
    per-block scale sidecar instead of the uncompressed ``elems_per_agent
    × itemsize``; the engines permute the encoded components through the
    same row plan, so the row counts are unchanged — only the
    bytes-per-row factor shrinks.
    """
    topo = sched.round(step)
    A = topo.n_agents
    B = agents_per_device
    n_dev = A // B
    bytes_per_agent = (codec.payload_bytes(elems_per_agent)
                       if codec is not None else elems_per_agent * itemsize)
    wire_rows = getattr(topo, "wire_rows", None)
    if wire_rows is not None:
        # liveness-masked rounds (core.elastic.MaskedTopology) carry their
        # own per-agent source maps and count their own rows
        return wire_rows(B, engine) * bytes_per_agent
    if engine == "dense":
        rows = (A - B) * n_dev          # every device gathers all remote rows
    elif engine == "shifts":
        rows = sum(1 for t in topo.terms if t.shift != 0) * A
    else:
        rows = sum(term_wire_rows(topo, t, B) for t in topo.terms) * n_dev
    return rows * bytes_per_agent


def group_wire_bytes_per_step(groups, scheds, step: int, *,
                              itemsize: int = 4, agents_per_device: int = 1,
                              engine: str = "ppermute", codecs=None) -> dict:
    """Per-group wire bytes of a policy-group bus at ``step`` (DESIGN §12).

    ``groups``: :class:`repro_torch.core.bus.BusGroup` objects (anything with
    ``name`` / ``rows`` / ``elems`` / ``gossip_every``); ``scheds`` maps a
    group's name to its :class:`GossipSchedule` (opt-out groups need
    none); ``codecs`` optionally maps a name to its
    :class:`repro_torch.core.wire.WireCodec`.  A group ships only on its
    own gossip steps: never with ``gossip_every == 0``, else on the steps
    with ``step % k == k − 1``, on its round clock ``step // k``.  Returns
    ``{name: bytes, ..., "total": bytes}``."""
    out = {}
    total = 0
    for g in groups:
        k = g.gossip_every
        if k == 0 or g.rows == 0 or (k > 1 and step % k != k - 1):
            out[g.name] = 0
            continue
        gstep = step // k if k > 1 else step
        b = wire_bytes_per_step(
            scheds[g.name], gstep, elems_per_agent=g.elems,
            itemsize=itemsize, agents_per_device=agents_per_device,
            engine=engine, codec=(codecs or {}).get(g.name))
        out[g.name] = b
        total += b
    out["total"] = total
    return out
