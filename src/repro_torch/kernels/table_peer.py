"""The source-table combine across ranks through peer pointers: the
multi-rank form of :mod:`repro_torch.kernels.table_combine`
(``csrc/table_peer.cu``), as :mod:`repro_torch.kernels.ring_peer` is the
ring's.

Each rank holds one agent's ``(1, rows, 128)`` f32 payload in a device
allocation of its own with two payload slots (epoch e's payload in slot
e mod 2, so that writing the next payload never waits on a reader of the
current one); the ranks of a round exchange the allocations' CUDA IPC
handles once (the caller's collective: ``core/mixing.py`` sends them over
the mesh's control group) and every rank maps every other's, so that a
round may read any rank: an exponential graph's hops, a time-varying
schedule's rounds, a churn round's masked columns, the overlap pipeline's
late slots (which read the rank itself).

* :class:`PeerTable` — one rank's allocation (:attr:`PeerTable.handle`),
  every rank's mapped slots (:meth:`PeerTable.open`,
  :meth:`PeerTable.view`) and the protocol, split as the overlapped
  pipeline needs it: :meth:`PeerTable.publish` (issue: the payload into
  the next slot, once the ranks that read that slot's last payload are
  done with it, then its READY epoch) and :meth:`PeerTable.combine`
  (complete: wait for the READY epoch of the sources it reads — never of
  a late one —, one combine launch, then this rank's DONE epoch; raises if
  a wait timed out).  The combine is the table kernel, or the ring kernel
  (:func:`repro_torch.kernels.ring_peer.ring_peer_flat`) on a ±1 ring
  round with no late slot;
* :func:`table_peer_flat` — the combine's launch alone, on given payloads
  (peer views or not): what the protocol runs between its flag kernels,
  and what a check times and holds against the plain version.

The plain version is :func:`repro_torch.kernels.ref.table_peer_ref`; on
the CPU the multi-rank engine permutes with gloo and combines with it.
There is no fallback: a failed build, allocation, handle or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import build
from ._ffi import count_launch, raise_on, stream
from .edm_update import LANE
from .ring_peer import FLAG_BYTES, _tensor_at, ring_peer_flat

__all__ = ["MAX_SOURCES", "MAX_TERMS", "PeerTable", "table_peer_flat",
           "table_peer_operands"]

MAX_SOURCES = 16      # distinct payloads one combine reads (and ranks a table)
MAX_TERMS = 16
SLOTS = 2
_READY, _DONE, _ERR = 0, 4, 8


def _lib():
    lib = build.library("table_peer")
    if lib.table_peer_alloc.argtypes is None:
        vp = ctypes.c_void_p
        for name, args in (
                ("table_peer_alloc", [ctypes.c_ulonglong,
                                      ctypes.POINTER(vp), vp]),
                ("table_peer_open", [vp, ctypes.POINTER(vp)]),
                ("table_peer_close", [vp]), ("table_peer_free", [vp]),
                ("table_peer_handle_bytes", []),
                ("table_peer_launch", [ctypes.POINTER(vp), ctypes.c_int, vp,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int, ctypes.c_longlong, vp]),
                ("table_peer_wait_launch", [ctypes.POINTER(vp), ctypes.c_int,
                                            ctypes.c_uint, vp,
                                            ctypes.c_ulonglong, vp]),
                ("table_peer_signal_launch", [vp, ctypes.c_uint, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def table_peer_operands(payloads: Sequence[torch.Tensor],
                        src: Sequence[int], weights: Sequence[float],
                        out: Optional[torch.Tensor] = None
                        ) -> Tuple[List[int], List[int]]:
    """Check a peer table combine's operands on any device and return
    ``(distinct, index)``: the distinct ranks the terms read, in first-use
    order, and each term's place among them.  ``payloads[j]`` is rank j's
    ``(1, rows, 128)`` f32 payload (all of one shape), ``src`` the terms'
    ranks, ``weights`` their weights (1 ≤ K ≤ 16, at most 16 distinct
    ranks); ``out`` (if given) like the payloads and none of the ones
    read."""
    K = len(src)
    if not 1 <= K <= MAX_TERMS or len(weights) != K:
        raise ValueError(f"the peer table combine takes 1..{MAX_TERMS} terms "
                         f"with one weight each, got {K} sources and "
                         f"{len(weights)} weights")
    first = payloads[0]
    if (first.dim() != 3 or first.shape[0] != 1 or first.shape[-1] != LANE
            or first.dtype != torch.float32):
        raise ValueError(f"the peer table combine takes (1, rows, {LANE}) f32 "
                         f"payloads, got {first.dtype} {tuple(first.shape)}")
    distinct: List[int] = []
    index: List[int] = []
    for s in src:
        s = int(s)
        if not 0 <= s < len(payloads):
            raise ValueError(f"source {s} is not one of the {len(payloads)} "
                             "ranks")
        if s not in distinct:
            distinct.append(s)
        index.append(distinct.index(s))
    if len(distinct) > MAX_SOURCES:
        raise ValueError(f"{len(distinct)} distinct sources, at most "
                         f"{MAX_SOURCES}")
    for s in distinct:
        t = payloads[s]
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"payload {s} is {t.dtype} {tuple(t.shape)}, "
                             f"payload 0 {first.dtype} {tuple(first.shape)}")
    if out is not None:
        if out.shape != first.shape or out.dtype != first.dtype:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, "
                             "expected the payloads'")
        if any(out.data_ptr() == payloads[s].data_ptr() for s in distinct):
            raise ValueError("out is one of the payloads the combine reads")
    return distinct, index


def table_peer_flat(payloads: Sequence[torch.Tensor], src: Sequence[int],
                    weights: Sequence[float], *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = Σₖ wₖ · payloads[srcₖ]`` on the card, one launch, terms in
    table order; ``payloads`` may be views of peers' memory
    (:class:`PeerTable`), and only those the table names are read.
    Bit-equal to :func:`repro_torch.kernels.ref.table_peer_ref`."""
    distinct, index = table_peer_operands(payloads, src, weights, out)
    ptrs = []
    for s in distinct:
        t = payloads[s]
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"payload {s}: the CUDA kernel takes contiguous, "
                             "16-byte aligned CUDA tensors")
        ptrs.append(t.data_ptr())
    first = payloads[distinct[0]]
    if out is None:
        out = torch.empty_like(first)
    if out.device.type != "cuda" or not out.is_contiguous() \
            or out.data_ptr() % 16:
        raise ValueError("out: the CUDA kernel takes a contiguous, 16-byte "
                         "aligned CUDA tensor")
    K, n = len(index), len(ptrs)
    with torch.cuda.device(first.device):
        err = _lib().table_peer_launch(
            (ctypes.c_void_p * n)(*ptrs), n, out.data_ptr(),
            (ctypes.c_int * K)(*index),
            (ctypes.c_float * K)(*(float(w) for w in weights)), K,
            first.numel() // 4, stream(first))
    raise_on(err, "table_peer")
    count_launch(table_peer_flat)
    return out


table_peer_flat.launches = 0


class PeerTable:
    """One rank's place among ``n`` ranks that read each other's payloads
    through a source table.

    ``shape``: the ``(1, rows, 128)`` f32 payload; ``index``: this rank's
    place among the ``n`` ranks; ``timeout_s`` bounds every flag wait.
    Making it allocates the two shared slots and the flags and its IPC
    :attr:`handle`; :meth:`open` takes every rank's handle (in rank order)
    and maps the others' allocations.  :attr:`epoch` counts the payloads
    published, :attr:`done` the combines run (the two alternate),
    :attr:`waits` the flag waits queued."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device,
                 index: int, n: int, timeout_s: float = 60.0):
        shape = tuple(shape)
        if len(shape) != 3 or shape[0] != 1 or shape[-1] != LANE:
            raise ValueError(f"a peer table payload is (1, rows, {LANE}), got "
                             f"{shape}")
        if not 0 <= index < n or n > MAX_SOURCES:
            raise ValueError(f"rank index {index} of {n} ranks (at most "
                             f"{MAX_SOURCES})")
        self.shape, self.device = shape, torch.device(device)
        self.me, self.n = index, n
        self.timeout_ns = int(timeout_s * 1e9)
        self.epoch = self.done = self.waits = 0
        self._lib = lib = _lib()
        self._slot_bytes = -(-shape[1] * LANE * 4 // FLAG_BYTES) * FLAG_BYTES
        self._flag_off = SLOTS * self._slot_bytes
        handle = ctypes.create_string_buffer(lib.table_peer_handle_bytes())
        ptr = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            raise_on(lib.table_peer_alloc(self._flag_off + FLAG_BYTES,
                                          ctypes.byref(ptr), handle),
                     "table_peer allocation")
            self._own = ptr.value
            self._err = _tensor_at(self._own + self._flag_off + _ERR, (1,),
                                   torch.int32)
        self.handle: bytes = handle.raw
        self._bases: List[Optional[int]] = [None] * n
        self._bases[index] = self._own
        self._views: Dict[Tuple[int, int], torch.Tensor] = {}
        self._readers: Dict[int, Tuple[int, ...]] = {}

    def open(self, handles: Sequence[bytes]) -> None:
        """Map every other rank's allocation from ``handles`` (every rank's
        :attr:`handle`, in rank order)."""
        if len(handles) != self.n:
            raise ValueError(f"{len(handles)} handles for {self.n} ranks")
        for j in range(self.n):
            if self._bases[j] is None:
                p = ctypes.c_void_p()
                with torch.cuda.device(self.device):
                    raise_on(self._lib.table_peer_open(handles[j],
                                                       ctypes.byref(p)),
                             f"table_peer open of rank {j}'s handle")
                self._bases[j] = p.value

    def view(self, j: int, slot: int) -> torch.Tensor:
        """Rank ``j``'s payload slot ``slot`` (a view of its memory)."""
        key = (j, slot)
        if key not in self._views:
            if self._bases[j] is None:
                raise RuntimeError("PeerTable: open() the ranks' handles "
                                   "before reading them")
            with torch.cuda.device(self.device):
                self._views[key] = _tensor_at(
                    self._bases[j] + slot * self._slot_bytes, self.shape,
                    torch.float32)
        return self._views[key]

    def views(self, epoch: Optional[int] = None) -> List[torch.Tensor]:
        """Every rank's payload of ``epoch`` (default: the last published)."""
        slot = (self.epoch if epoch is None else epoch) % SLOTS
        return [self.view(j, slot) for j in range(self.n)]

    # -- the protocol -------------------------------------------------------
    def _flag(self, j: int, which: int) -> int:
        return self._bases[j] + self._flag_off + which

    def _wait(self, ranks: Sequence[int], which: int, target: int) -> None:
        ranks = [j for j in ranks if j != self.me]
        if not ranks or target <= 0:
            return
        self.waits += 1
        flags = (ctypes.c_void_p * len(ranks))(
            *(self._flag(j, which) for j in ranks))
        raise_on(self._lib.table_peer_wait_launch(
            flags, len(ranks), target,
            ctypes.c_void_p(self._own + self._flag_off + _ERR),
            self.timeout_ns, stream(self._err)), "table_peer wait")

    def _signal(self, which: int, value: int) -> None:
        raise_on(self._lib.table_peer_signal_launch(
            ctypes.c_void_p(self._flag(self.me, which)), value,
            stream(self._err)), "table_peer signal")

    def slot_for_write(self, readers: Sequence[int]) -> torch.Tensor:
        """The slot the next payload goes into, once the ranks that read
        its previous payload are done (a wait queued on the current
        stream); ``readers``: the ranks that will read the next payload."""
        e = self.epoch + 1
        self._readers[e] = tuple(readers)
        with torch.cuda.device(self.device):
            self._wait(self._readers.pop(e - SLOTS, ()), _DONE, e - SLOTS)
        return self.view(self.me, e % SLOTS)

    def publish(self, payload: Optional[torch.Tensor],
                readers: Sequence[int]) -> int:
        """Write ``payload`` (None: already written into
        :meth:`slot_for_write`'s slot) as the next epoch's and publish its
        READY epoch; ``readers`` are the ranks whose combine reads it (a
        superset is safe).  Returns the epoch."""
        e = self.epoch + 1
        if e not in self._readers:
            slot = self.slot_for_write(readers)
        else:
            slot = self.view(self.me, e % SLOTS)
        with torch.cuda.device(self.device):
            if payload is not None and payload.data_ptr() != slot.data_ptr():
                slot.copy_(payload)
            self._signal(_READY, e)
        self.epoch = e
        return e

    def combine(self, src: Sequence[int], weights: Sequence[float],
                out: Optional[torch.Tensor] = None,
                ring_terms: Optional[Sequence[Tuple[int, float]]] = None
                ) -> torch.Tensor:
        """Wait for the READY epoch of the ranks ``src`` names (the last
        published epoch), run the combine ``Σₖ wₖ · payload[srcₖ]`` into
        ``out`` — the ring kernel with ``ring_terms`` (a ±1 ring round's
        ``(shift, weight)`` pairs, read from the left and right ranks), the
        table kernel else —, publish this rank's DONE epoch and raise if a
        wait timed out."""
        e = self.epoch
        if e == self.done:
            raise RuntimeError("PeerTable.combine: publish() this epoch's "
                               "payload first")
        pays = self.views(e)
        with torch.cuda.device(self.device):
            self._wait(sorted({int(s) for s in src}), _READY, e)
            if ring_terms is not None:
                res = ring_peer_flat(pays[self.me],
                                     pays[(self.me - 1) % self.n],
                                     pays[(self.me + 1) % self.n],
                                     ring_terms, self.n, out=out)
            else:
                res = table_peer_flat(pays, src, weights, out=out)
            self._signal(_DONE, e)
            self.done = e
            self.raise_on_timeout()
        return res

    def raise_on_timeout(self) -> None:
        """Raise if a flag wait of this rank timed out (reads the error
        word: synchronises the stream)."""
        code = int(self._err.item())
        if code:
            raise RuntimeError(
                f"table_peer: rank {self.me} waited more than "
                f"{self.timeout_ns / 1e9:g} s for a flag (wait list index "
                f"{code - 1}) by epoch {self.epoch} (a rank did not arrive)")

    def close(self) -> None:
        """Unmap the others' allocations and free this rank's.  Call it once
        no rank reads this one's payloads any more (the caller's barrier
        after every rank synchronised its card)."""
        if self._own is None:
            return
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            self._views.clear()
            for j, p in enumerate(self._bases):
                if j != self.me and p is not None:
                    raise_on(self._lib.table_peer_close(ctypes.c_void_p(p)),
                             "table_peer close")
            self._err = None
            raise_on(self._lib.table_peer_free(ctypes.c_void_p(self._own)),
                     "table_peer free")
        self._own = None
        self._bases = [None] * self.n
