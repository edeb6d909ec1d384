"""The source-table combine across ranks through peer pointers: the
multi-rank form of :mod:`repro_torch.kernels.table_combine`
(``csrc/table_peer.cu``) and, on the int8 wire, of the q8 combine
(``csrc/table_peer_q8.cu``), as :mod:`repro_torch.kernels.ring_peer` is
the ring's.

Each rank holds its agents' payload in a device allocation of its own
with two payload slots (epoch e's payload in slot e mod 2, so that writing
the next payload never waits on a reader of the current one).  A payload
is B agents' ``(B, rows, 128)`` block of f32, bf16 (the bf16 wire) or int8
(the int8 wire, its ``(B, rows // block_rows)`` f32 scales beside it in
the same slot, 16-byte aligned).  The ranks of a round exchange the
allocations' CUDA IPC handles once (the caller's collective:
``core/mixing.py`` sends them over the mesh's control group) and every
rank maps every other's, so that a round may read any (rank, agent)
block: an exponential graph's hops, a time-varying schedule's rounds, a
blocked ring's neighbours, a churn round's masked columns, the overlap
pipeline's late slots (which read the agent itself).

* :class:`PeerTable` — one rank's allocation (:attr:`PeerTable.handle`),
  every rank's mapped slots (:meth:`PeerTable.open`,
  :meth:`PeerTable.view`, :meth:`PeerTable.payload`) and the protocol,
  split as the overlapped pipeline needs it: :meth:`PeerTable.publish`
  (issue: the payload into the next slot, once the ranks that read that
  slot's last payload are done with it, then its READY epoch) and
  :meth:`PeerTable.combine` (complete: wait for the READY epoch of the
  ranks it reads — never of a late one —, one combine launch, then this
  rank's DONE epoch; raises if a wait timed out).  The combine is the
  table kernel (f32 or bf16), the q8 kernel (int8), or the ring kernel
  (:func:`repro_torch.kernels.ring_peer.ring_peer_flat`) on a ±1 ring
  round of one f32 agent with no late slot;
* :func:`table_peer_flat` / :func:`table_peer_q8_flat` — the combine's
  launch alone, on given payloads (peer views or not): what the protocol
  runs between its flag kernels, and what a check times and holds against
  the plain version.

A table is ``(K, B)``: ``src[k, b]`` the global agent index
(``rank · B + agent``) whose block term k brings to this rank's agent b,
``w[k, b]`` its weight; with one agent a rank a ``(K,)`` list of ranks.
The plain versions are :func:`repro_torch.kernels.ref.table_peer_ref` and
:func:`repro_torch.kernels.ref.table_peer_q8_ref`; on the CPU the
multi-rank engine permutes with gloo and combines with the one-device
kernels' plain versions.  There is no fallback: a failed build,
allocation, handle or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from ._ffi import DTYPE_CODE, agent_stride, check, count_launch, raise_on, \
    stream
from .edm_update import LANE
from .ring_peer import FLAG_BYTES, _CudaArray, _tensor_at, ring_peer_flat

__all__ = ["MAX_SOURCES", "MAX_TERMS", "MAX_BLOCK", "PAYLOAD_DTYPES",
           "PeerTable", "table_columns", "table_peer_flat",
           "table_peer_q8_flat", "table_peer_operands"]

MAX_SOURCES = 16      # distinct blocks one combine reads (and ranks a table)
MAX_TERMS = 16
MAX_BLOCK = 8         # agents a rank
PAYLOAD_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
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
                ("table_peer_block_launch", [
                    ctypes.POINTER(vp), ctypes.c_int, vp, ctypes.c_longlong,
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, vp]),
                ("table_peer_wait_launch", [ctypes.POINTER(vp), ctypes.c_int,
                                            ctypes.c_uint, vp,
                                            ctypes.c_ulonglong, vp]),
                ("table_peer_signal_launch", [vp, ctypes.c_uint, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _q8_lib():
    lib = build.library("table_peer_q8")
    fn = lib.table_peer_q8_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.c_int,
                       vp, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong, vp]
    return fn


def table_columns(src, weights, B: int) -> Tuple[np.ndarray, np.ndarray]:
    """A combine's table as ``(K, B)`` int64 / float64 arrays: ``src`` and
    ``weights`` ``(K, B)``, or ``(K,)`` with one agent a rank."""
    src = np.asarray(src, dtype=np.int64)
    w = np.asarray(weights, dtype=np.float64)
    if src.ndim == 1:
        src = src.reshape(-1, 1)
    if w.ndim == 1:
        w = w.reshape(-1, 1)
    if src.ndim != 2 or src.shape[1] != B or w.shape != src.shape:
        raise ValueError(f"a table of {B} agents a rank is (K, {B}) sources "
                         f"and weights, got {src.shape} and {w.shape}")
    return src, w


def table_peer_operands(payloads: Sequence, src, weights,
                        out: Optional[torch.Tensor] = None,
                        scales: Optional[Sequence[torch.Tensor]] = None,
                        block_rows: Optional[int] = None
                        ) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """Check a peer table combine's operands on any device and return
    ``(blocks, index, w)``: the distinct global agent indices the terms
    read, in first-use order, each term's place among them as a ``(B, K)``
    array, and the ``(B, K)`` weights.  ``payloads[j]`` is rank j's ``(B,
    rows, 128)`` payload (all of one shape and dtype: f32 or bf16, or int8
    with ``scales[j]`` its ``(B, rows // block_rows)`` f32 scales), ``src``
    / ``weights`` the ``(K, B)`` table (:func:`table_columns`; 1 ≤ K ≤ 16,
    B ≤ 8, at most 16 distinct blocks); ``out`` (if given) f32 of the
    payloads' shape, apart from every block read."""
    first = payloads[0]
    q8 = scales is not None
    want = (torch.int8,) if q8 else (torch.float32, torch.bfloat16)
    if (first.dim() != 3 or not 1 <= first.shape[0] <= MAX_BLOCK
            or first.shape[-1] != LANE or first.dtype not in want):
        raise ValueError(f"the peer table combine takes (B ≤ {MAX_BLOCK}, "
                         f"rows, {LANE}) payloads of {want}, got "
                         f"{first.dtype} {tuple(first.shape)}")
    B, rows = first.shape[0], first.shape[1]
    if q8 and (not block_rows or block_rows % 8 or rows % block_rows):
        raise ValueError(f"rows {rows} must be a multiple of block_rows="
                         f"{block_rows} (a positive multiple of 8)")
    src, w = table_columns(src, weights, B)
    K = src.shape[0]
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f"the peer table combine takes 1..{MAX_TERMS} terms, "
                         f"got {K}")
    n = len(payloads) * B
    blocks: List[int] = []
    index = np.zeros((B, K), np.int64)
    for b in range(B):
        for k in range(K):
            g = int(src[k, b])
            if not 0 <= g < n:
                raise ValueError(f"source {g} is not one of the {n} agents "
                                 f"of {len(payloads)} ranks")
            if g not in blocks:
                blocks.append(g)
            index[b, k] = blocks.index(g)
    if len(blocks) > MAX_SOURCES:
        raise ValueError(f"{len(blocks)} distinct source blocks, at most "
                         f"{MAX_SOURCES}")
    for j in sorted({g // B for g in blocks}):
        t = payloads[j]
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"payload {j} is {t.dtype} {tuple(t.shape)}, "
                             f"payload 0 {first.dtype} {tuple(first.shape)}")
        if q8 and tuple(scales[j].shape) != (B, rows // block_rows):
            raise ValueError(f"scales {j} are {tuple(scales[j].shape)}, "
                             f"expected {(B, rows // block_rows)}")
    if out is not None:
        if out.shape != first.shape or out.dtype != torch.float32:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, "
                             f"expected float32 {tuple(first.shape)}")
        o0 = out.data_ptr()
        o1 = o0 + ((B - 1) * agent_stride(out) + out[0].numel()) * 4
        for g in blocks:
            t = payloads[g // B][g % B]
            p0 = t.data_ptr()
            if p0 < o1 and o0 < p0 + t.numel() * t.element_size():
                raise ValueError("out overlaps a payload the combine reads")
    return blocks, index, w.T


def _block_ptrs(payloads, blocks: List[int], B: int, what: str) -> List[int]:
    ptrs = []
    for g in blocks:
        t = payloads[g // B]
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what} {g // B}: the CUDA kernel takes "
                             "contiguous, 16-byte aligned CUDA tensors")
        ptrs.append(t[g % B].data_ptr())
    return ptrs


def _out_for(first: torch.Tensor, out: Optional[torch.Tensor]
             ) -> torch.Tensor:
    if out is None:
        out = torch.empty(first.shape, dtype=torch.float32,
                          device=first.device)
    check(out, "out", first, dtypes=(torch.float32,), shape=first.shape,
          agent_strided=True)
    return out


def _terms(index: np.ndarray, w: np.ndarray):
    n = index.size
    return ((ctypes.c_int * n)(*(int(v) for v in index.reshape(-1))),
            (ctypes.c_float * n)(*(float(v) for v in w.reshape(-1))))


def table_peer_flat(payloads: Sequence[torch.Tensor], src, weights, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[b] = Σₖ w[k, b] · block[src[k, b]]`` on the card, one launch,
    terms in table order, f32 out (the f32 payload's mix, or the bf16
    wire's decode-combine); ``payloads[j]`` is rank j's ``(B, rows, 128)``
    f32 or bf16 payload (peer views or not: :class:`PeerTable`), and only
    the blocks the table names are read.  ``out`` may hold each agent's
    block apart (a policy group's rows of a larger bus).  Bit-equal to
    :func:`repro_torch.kernels.ref.table_peer_ref`."""
    blocks, index, w = table_peer_operands(payloads, src, weights, out)
    first = payloads[blocks[0] // payloads[0].shape[0]]
    B = first.shape[0]
    ptrs = _block_ptrs(payloads, blocks, B, "payload")
    out = _out_for(first, out)
    u, wt = _terms(index, w)
    n = len(ptrs)
    with torch.cuda.device(first.device):
        err = _lib().table_peer_block_launch(
            (ctypes.c_void_p * n)(*ptrs), n, out.data_ptr(),
            agent_stride(out), u, wt, index.shape[1], B, first[0].numel(),
            DTYPE_CODE[first.dtype], stream(first))
    raise_on(err, "table_peer")
    count_launch(table_peer_flat)
    return out


table_peer_flat.launches = 0


def table_peer_q8_flat(qs: Sequence[torch.Tensor],
                       scales: Sequence[torch.Tensor], src, weights, *,
                       block_rows: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 wire's dequantize-and-combine across ranks on the card, one
    launch: ``out[b] = Σₖ (w[k, b] · scale[src[k, b]][tile]) ·
    f32(q[src[k, b]])``, each coefficient one f32 product, f32 sums in
    term order.  ``qs[j]`` is rank j's ``(B, rows, 128)`` int8 payload,
    ``scales[j]`` its ``(B, rows // block_rows)`` f32 scales (peer views or
    not); only the blocks the table names are read.  Bit-equal to
    :func:`repro_torch.kernels.ref.table_peer_q8_ref`."""
    blocks, index, w = table_peer_operands(qs, src, weights, out,
                                           scales=scales,
                                           block_rows=block_rows)
    first = qs[blocks[0] // qs[0].shape[0]]
    B = first.shape[0]
    qp = _block_ptrs(qs, blocks, B, "q")
    sp = _block_ptrs(scales, blocks, B, "scales")
    out = _out_for(first, out)
    u, wt = _terms(index, w)
    n = len(qp)
    with torch.cuda.device(first.device):
        err = _q8_lib()(
            (ctypes.c_void_p * n)(*qp), (ctypes.c_void_p * n)(*sp), n,
            out.data_ptr(), agent_stride(out), u, wt, index.shape[1], B,
            block_rows, first[0].numel(), stream(first))
    raise_on(err, "table_peer_q8")
    count_launch(table_peer_q8_flat)
    return out


table_peer_q8_flat.launches = 0


def _view_at(ptr: int, shape, dtype: torch.dtype) -> torch.Tensor:
    """A tensor over raw device memory of ``dtype`` (bf16 through its
    16-bit words)."""
    if dtype in (torch.float32, torch.int32):
        return _tensor_at(ptr, shape, dtype)
    typestr = {torch.int8: "|i1", torch.bfloat16: "<i2"}[dtype]
    t = torch.as_tensor(_CudaArray(ptr, shape, typestr), device="cuda")
    return t.view(dtype)


def _round_up(n: int) -> int:
    return -(-n // FLAG_BYTES) * FLAG_BYTES


class PeerTable:
    """One rank's place among ``n`` ranks that read each other's payloads
    through a source table.

    ``shape``: the ``(B, rows, 128)`` payload of this rank's B agents, of
    ``dtype`` (f32, bf16 or int8; int8 carries ``(B, rows // block_rows)``
    f32 scales beside it); ``index``: this rank's place among the ``n``
    ranks; ``timeout_s`` bounds every flag wait.  Making it allocates the
    two shared slots and the flags and its IPC :attr:`handle`;
    :meth:`open` takes every rank's handle (in rank order) and maps the
    others' allocations.  :attr:`epoch` counts the payloads published,
    :attr:`done` the combines run (the two alternate), :attr:`waits` the
    flag waits queued."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device,
                 index: int, n: int, timeout_s: float = 60.0,
                 dtype: torch.dtype = torch.float32,
                 block_rows: Optional[int] = None):
        shape = tuple(shape)
        if len(shape) != 3 or not 1 <= shape[0] <= MAX_BLOCK \
                or shape[-1] != LANE:
            raise ValueError(f"a peer table payload is (B ≤ {MAX_BLOCK}, "
                             f"rows, {LANE}), got {shape}")
        if dtype not in PAYLOAD_DTYPES:
            raise ValueError(f"a peer table payload is one of "
                             f"{PAYLOAD_DTYPES}, got {dtype}")
        if dtype == torch.int8 and (not block_rows or block_rows % 8
                                    or shape[1] % block_rows):
            raise ValueError(f"an int8 payload's rows {shape[1]} must be a "
                             f"multiple of block_rows={block_rows}")
        if not 0 <= index < n or n > MAX_SOURCES:
            raise ValueError(f"rank index {index} of {n} ranks (at most "
                             f"{MAX_SOURCES})")
        self.shape, self.device, self.dtype = shape, torch.device(device), \
            dtype
        self.block_rows = block_rows if dtype == torch.int8 else None
        self.B = shape[0]
        self.me, self.n = index, n
        self.timeout_ns = int(timeout_s * 1e9)
        self.epoch = self.done = self.waits = 0
        self._lib = lib = _lib()
        data = _round_up(shape[0] * shape[1] * LANE * dtype.itemsize)
        self._scale_shape = ((shape[0], shape[1] // block_rows)
                             if self.block_rows else None)
        self._scale_off = data
        self._slot_bytes = data + (_round_up(4 * shape[0] * self._scale_shape[1])
                                   if self.block_rows else 0)
        self._flag_off = SLOTS * self._slot_bytes
        handle = ctypes.create_string_buffer(lib.table_peer_handle_bytes())
        ptr = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            # cudaMalloc, outside torch's caching allocator: hand it the
            # blocks torch holds cached but unused (a full-width step's
            # freed temporaries) first
            torch.cuda.empty_cache()
            raise_on(lib.table_peer_alloc(self._flag_off + FLAG_BYTES,
                                          ctypes.byref(ptr), handle),
                     "table_peer allocation")
            self._own = ptr.value
            self._err = _tensor_at(self._own + self._flag_off + _ERR, (1,),
                                   torch.int32)
        self.handle: bytes = handle.raw
        self._bases: List[Optional[int]] = [None] * n
        self._bases[index] = self._own
        self._views: Dict[Tuple[int, int, bool], torch.Tensor] = {}
        self._readers: Dict[int, Tuple[int, ...]] = {}

    @property
    def spec(self) -> Tuple:
        """``(shape, dtype, block_rows)``: the payload this table carries."""
        return self.shape, self.dtype, self.block_rows

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

    def _at(self, j: int, slot: int, scale: bool) -> torch.Tensor:
        key = (j, slot, scale)
        if key not in self._views:
            if self._bases[j] is None:
                raise RuntimeError("PeerTable: open() the ranks' handles "
                                   "before reading them")
            base = self._bases[j] + slot * self._slot_bytes
            with torch.cuda.device(self.device):
                self._views[key] = (
                    _view_at(base + self._scale_off, self._scale_shape,
                             torch.float32) if scale
                    else _view_at(base, self.shape, self.dtype))
        return self._views[key]

    def view(self, j: int, slot: int) -> torch.Tensor:
        """Rank ``j``'s payload data in slot ``slot`` (a view of its
        memory)."""
        return self._at(j, slot, False)

    def scale_view(self, j: int, slot: int) -> torch.Tensor:
        """Rank ``j``'s int8 scales in slot ``slot``."""
        if self.block_rows is None:
            raise ValueError(f"a {self.dtype} payload has no scales")
        return self._at(j, slot, True)

    def payload(self, j: int, slot: int):
        """Rank ``j``'s payload in slot ``slot`` as the wire carries it: the
        tensor, or int8's ``(q, scale)``."""
        if self.block_rows is None:
            return self.view(j, slot)
        return self.view(j, slot), self.scale_view(j, slot)

    def views(self, epoch: Optional[int] = None) -> List:
        """Every rank's payload of ``epoch`` (default: the last
        published)."""
        slot = (self.epoch if epoch is None else epoch) % SLOTS
        return [self.payload(j, slot) for j in range(self.n)]

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

    def slot_for_write(self, readers: Sequence[int]):
        """The slot the next payload goes into (:meth:`payload`'s form),
        once the ranks that read its previous payload are done (a wait
        queued on the current stream); ``readers``: the ranks that will
        read the next payload."""
        e = self.epoch + 1
        self._readers[e] = tuple(readers)
        with torch.cuda.device(self.device):
            self._wait(self._readers.pop(e - SLOTS, ()), _DONE, e - SLOTS)
        return self.payload(self.me, e % SLOTS)

    def publish(self, payload, readers: Sequence[int]) -> int:
        """Write ``payload`` (a tensor, or int8's ``(q, scale)``; None:
        already written into :meth:`slot_for_write`'s slot) as the next
        epoch's and publish its READY epoch; ``readers`` are the ranks
        whose combine reads it (a superset is safe).  Returns the epoch."""
        e = self.epoch + 1
        if e not in self._readers:
            slot = self.slot_for_write(readers)
        else:
            slot = self.payload(self.me, e % SLOTS)
        with torch.cuda.device(self.device):
            if payload is not None:
                pairs = (zip(payload, slot) if self.block_rows
                         else [(payload, slot)])
                for src, dst in pairs:
                    if src.data_ptr() != dst.data_ptr():
                        dst.copy_(src)
            self._signal(_READY, e)
        self.epoch = e
        return e

    def combine(self, src, weights, out: Optional[torch.Tensor] = None,
                ring_terms: Optional[Sequence[Tuple[int, float]]] = None
                ) -> torch.Tensor:
        """Wait for the READY epoch of the ranks whose blocks ``src`` names
        (the last published epoch), run the combine ``out[b] = Σₖ w[k, b] ·
        block[src[k, b]]`` (``src`` / ``weights`` ``(K, B)`` of global
        agent indices, or ``(K,)`` ranks at one agent a rank) into ``out``
        — the ring kernel with ``ring_terms`` (a ±1 ring round's ``(shift,
        weight)`` pairs over one f32 agent, read from the left and right
        ranks), the q8 kernel on an int8 payload, the table kernel else —,
        publish this rank's DONE epoch and raise if a wait timed out."""
        e = self.epoch
        if e == self.done:
            raise RuntimeError("PeerTable.combine: publish() this epoch's "
                               "payload first")
        src, w = table_columns(src, weights, self.B)
        pays = self.views(e)
        with torch.cuda.device(self.device):
            self._wait(sorted({int(g) // self.B for g in src.reshape(-1)}),
                       _READY, e)
            if ring_terms is not None:
                if self.dtype != torch.float32 or self.B != 1:
                    raise ValueError("the ring kernel takes one f32 agent a "
                                     f"rank, not {self.B} of {self.dtype}")
                res = ring_peer_flat(pays[self.me],
                                     pays[(self.me - 1) % self.n],
                                     pays[(self.me + 1) % self.n],
                                     ring_terms, self.n, out=out)
            elif self.block_rows is not None:
                qs, scales = zip(*pays)
                res = table_peer_q8_flat(qs, scales, src, w,
                                         block_rows=self.block_rows, out=out)
            else:
                res = table_peer_flat(pays, src, w, out=out)
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
