"""The ring gossip combine with the rolls fused in: the counterpart of
``repro/kernels/ring_dma.py``.

The JAX module's kernel ships each device's bus shard to both ring
neighbours by remote DMA and combines the chunks as they land, so the
neighbours' payloads never exist in HBM.  With every agent on one card the
agents are row blocks of one ``(A, rows, 128)`` bus and a neighbour's shard
is an address in the same memory: :func:`ring_combine_flat`
(``csrc/ring_combine.cu``) reads each element once and writes each output
once, where the one-device ppermute engine rolls the bus twice and then
combines three buses.

* :func:`ring_plan` — the JAX module's: a flat ±1 ring's weights
  ``(w_center, w_from_left, w_from_right)``, or ``None``;
* :func:`ring_unfit` / :func:`ring_dma_supported` — the one rule for
  what the ring transport carries: a flat ±1 ring, every agent on this
  one device, ``(A, rows, 128)`` f32 payloads (the CPU runs the plain
  version);
* :func:`ring_sources` / :func:`ring_operands` — a ring's terms as the
  kernel's operand codes, and the checks every device makes;
* :func:`ring_combine_flat` — the launch.  It takes the topology's terms as
  ``(shift, weight)`` pairs in ``topo.terms`` order, not the collapsed
  plan, so it rounds exactly as the rolls plus ``gossip_axpy`` do.

The plain version is :func:`repro_torch.kernels.ref.ring_combine_ref`; the
device dispatch is :func:`repro_torch.kernels.ops.ring_combine`.
"""
from __future__ import annotations

import ctypes
from typing import List, Mapping, Optional, Sequence, Tuple

import torch

from ._ffi import (agent_stride, check, count_launch, launcher, overlaps,
                   raise_on, stream)
from .edm_update import LANE

__all__ = ["MAX_TERMS", "ring_plan", "ring_unfit", "ring_dma_supported",
           "bus_payload", "ring_sources", "ring_operands", "ring_combine_flat"]

MAX_TERMS = 8


def ring_plan(topo) -> Optional[Tuple[float, float, float]]:
    """Collapse ``topo``'s shift terms into ring-combine weights
    ``(w_center, w_from_left, w_from_right)`` — or None when the topology
    is not a flat ±1 ring (any grid-level term or a longer-range shift
    disqualifies it; the shifts are normalized mod n, so n−1 ≡ −1).

    Roll semantics map shifts to directions: a ``+1`` term is
    ``x_new[i] = x[i−1]`` — agent i *receives from its left neighbour* —
    and ``−1`` receives from the right."""
    n = topo.n_agents
    w = {0: 0.0, 1: 0.0, -1: 0.0}
    for t in topo.terms:
        if t.level != "flat":
            return None
        s = t.shift % n
        if s == 0:
            w[0] += t.weight
        elif s == 1:
            w[1] += t.weight
        elif s == n - 1:
            w[-1] += t.weight
        else:
            return None
    return (float(w[0]), float(w[1]), float(w[-1]))


def bus_payload(x, n_agents: int) -> bool:
    """True iff ``x`` is an ``(n_agents, rows, 128)`` f32 tensor: the bus
    layout the kernel walks."""
    return (isinstance(x, torch.Tensor) and x.dim() == 3
            and x.shape[0] == n_agents and x.shape[-1] == LANE
            and x.dtype == torch.float32)


def ring_unfit(topo, *, agents_per_device: int,
               payload=None) -> str:
    """Why the ring transport cannot carry ``topo``'s gossip, or '' when
    it can: a flat ±1 ring (:func:`ring_plan`), every agent on this one
    device (``agents_per_device == A``; one agent a rank is the multi-rank
    form, :mod:`repro_torch.kernels.ring_peer`) and, where
    ``payload`` (a tensor or a tree of them) is given, ``(A, rows, 128)``
    f32 buses.  The device is no condition: on the card the kernel runs,
    on the CPU its plain version, as for every op of the port."""
    A = topo.n_agents
    if ring_plan(topo) is None:
        return f"needs a flat ±1 ring, got the {topo.name} topology"
    if agents_per_device != A:
        return (f"needs all {A} agents on one device, got "
                f"agents_per_device={agents_per_device}")
    if payload is None:
        return ""
    leaves = (list(payload.values()) if isinstance(payload, Mapping)
              else [payload])
    if all(bus_payload(leaf, A) for leaf in leaves):
        return ""
    return (f"needs ({A}, rows, {LANE}) f32 payloads, got "
            + ", ".join(f"{getattr(leaf, 'dtype', type(leaf).__name__)} "
                        f"{tuple(getattr(leaf, 'shape', ()))}"
                        for leaf in leaves[:3]))


def ring_dma_supported(topo, *, agents_per_device: int,
                       payload=None) -> bool:
    """True iff the ring transport carries ``topo``'s gossip
    (:func:`ring_unfit` gives the reason when not)."""
    return not ring_unfit(topo, agents_per_device=agents_per_device,
                          payload=payload)


def ring_sources(terms: Sequence[Tuple[int, float]], n_agents: int
                 ) -> List[int]:
    """The kernel's operand code of each ``(shift, weight)`` term: 0 for
    the agent's own row block (shift ≡ 0, or one agent), 1 for block
    ``a − 1`` (shift ≡ +1), 2 for block ``a + 1`` (shift ≡ −1).  With two
    agents both neighbours are the other agent (code 1).  Raises for a
    shift that is not a ±1 ring term."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"the ring combine takes 1..{MAX_TERMS} terms, got "
                         f"{len(terms)}")
    codes = []
    for shift, _ in terms:
        s = int(shift) % n_agents
        if n_agents == 1 or s == 0:
            codes.append(0)
        elif s == 1:
            codes.append(1)
        elif s == n_agents - 1:
            codes.append(2)
        else:
            raise ValueError(f"shift {shift} is not a term of a ±1 ring of "
                             f"{n_agents} agents")
    return codes


def ring_operands(x: torch.Tensor, terms: Sequence[Tuple[int, float]],
                  out: Optional[torch.Tensor] = None) -> List[int]:
    """Check a ring combine's operands on any device and return the terms'
    operand codes (:func:`ring_sources`): ``x`` an ``(A, rows, 128)`` f32
    bus (or a group's rows of one), ``±1`` ring terms, ``out`` (if given)
    like ``x`` and its agent blocks' span apart from x's — every output
    row block reads its neighbours'."""
    if x.dim() != 3 or not bus_payload(x, x.shape[0]):
        raise ValueError(f"the ring combine takes (A, rows, {LANE}) f32 "
                         f"buses, got {x.dtype} {tuple(x.shape)}")
    src = ring_sources(terms, x.shape[0])
    if out is not None:
        if (out.shape != x.shape or out.dtype != x.dtype
                or out.device != x.device):
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)} on "
                             f"{out.device}, expected x's")
        if overlaps(x, out):
            raise ValueError("out overlaps x: the ring combine reads "
                             "neighbour row blocks, so it cannot run in "
                             "place")
    return src


def ring_combine_flat(x: torch.Tensor, terms: Sequence[Tuple[int, float]],
                      *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[a] = Σₖ wₖ · x[(a − shiftₖ) mod A]`` on the card, one launch.

    ``x``: an ``(A, rows, 128)`` f32 CUDA bus, contiguous or a policy
    group's rows ``bus[:, r0:r1]`` of a larger one (read in place: each
    agent block dense, the blocks a 16-byte multiple apart); ``terms``:
    ``(shift, weight)`` pairs of a ±1 ring in topology order (weights are
    runtime arguments).  ``out`` (default: a new bus; strided as ``x`` may
    be) may alias no byte of ``x`` (:func:`ring_operands`).  Bit-equal to
    :func:`repro_torch.kernels.ref.ring_combine_ref`."""
    src = ring_operands(x, terms, out)
    check(x, "x", x, agent_strided=True)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    check(out, "out", x, agent_strided=True)
    n = len(src)
    fn = launcher("ring_combine", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), (ctypes.c_int * n)(*src),
                 (ctypes.c_float * n)(*(float(w) for _, w in terms)), n,
                 x.shape[0], x[0].numel() // 4, agent_stride(x) // 4,
                 agent_stride(out) // 4, stream(x))
    raise_on(err, "ring_combine")
    count_launch(ring_combine_flat)
    return out


ring_combine_flat.launches = 0
