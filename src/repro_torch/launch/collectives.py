"""Counting a step's collectives: the counterpart of
``repro/launch/hlo_analysis.py``'s ``count_collectives`` /
``collective_bytes``.

The JAX package counts the collectives of a step in its compiled HLO.  The
port has no compiled program: its collectives are calls
(:mod:`repro_torch.core.comm`), recorded where they are made inside
:func:`repro_torch.core.comm.recording`.  These functions read such a
record as the reference's read HLO text: per-device counts, and
per-device bytes with the same factors (:class:`~repro_torch.core.comm.
Collective`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.comm import KINDS, Collective

__all__ = ["count_collectives", "collective_bytes"]


def count_collectives(records: Sequence[Collective],
                      tag: Optional[str] = None) -> Dict[str, int]:
    """Collectives of each kind in ``records`` (of one tag, if given)."""
    out: Dict[str, int] = {}
    for r in records:
        if tag is None or r.tag == tag:
            out[r.kind] = out.get(r.kind, 0) + 1
    return out


def collective_bytes(records: Sequence[Collective],
                     tag: Optional[str] = None) -> Dict[str, float]:
    """Bytes this rank moved, per kind (of one tag, if given), with the
    reference's factors."""
    out = {k: 0.0 for k in KINDS}
    for r in records:
        if tag is None or r.tag == tag:
            out[r.kind] += r.nbytes
    return out
