"""The ring combine across ranks through peer pointers: the multi-rank form
of :mod:`repro_torch.kernels.ring_dma` (``csrc/ring_peer.cu``).

The JAX package's ``_ring_kernel`` ships each device's bus shard to both
ring neighbours by remote DMA, behind an entry barrier and per-chunk acks.
Here each rank holds one agent's ``(1, rows, 128)`` f32 payload in a
device allocation of its own whose CUDA IPC handle the ring's ranks
exchange once (the caller's collective: the multi-rank engine's
``core/mixing.py`` sends them over the control group); each rank opens
its two neighbours' allocations and the combine reads their payloads in
place.
Ranks on one card (the H100 case) and ranks on the cards of one node
(NVLink, ``cudaIpcMemLazyEnablePeerAccess``) take the same path.

* :class:`PeerRing` — one rank's shared allocation (its payload, then two
  monotonic epoch flags and an error word; :attr:`PeerRing.handle`), its
  neighbours' mapped payloads and flags (:meth:`PeerRing.open` with every
  rank's handle), and the step protocol (``csrc/ring_peer.cu``'s
  header): :meth:`PeerRing.payload_for_write` before the payload is
  written (waits until both neighbours finished reading the last one),
  :meth:`PeerRing.combine` after (publishes it, waits for the
  neighbours', combines, publishes that it read them, and raises if a
  wait timed out);
* :func:`ring_peer_flat` — the combine's launch alone, on three payloads
  (peer views or not): what the protocol runs between its flag kernels,
  and what a check times and holds against the plain version.

The plain version is :func:`repro_torch.kernels.ref.ring_peer_ref`; on the
CPU the multi-rank engine permutes with gloo and combines with it.  There
is no fallback: a failed build, allocation, handle or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from . import build
from ._ffi import check, count_launch, launcher, raise_on, stream
from .edm_update import LANE
from .ring_dma import ring_sources

__all__ = ["PeerRing", "ring_peer_flat", "peer_operands", "FLAG_BYTES"]

FLAG_BYTES = 256       # ready (u32), done (u32), error word (i32), pad
_READY, _DONE, _ERR = 0, 4, 8


class _CudaArray:
    """A raw device pointer as ``__cuda_array_interface__`` (no owner)."""

    def __init__(self, ptr: int, shape, typestr: str):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": typestr, "data": (ptr, False),
            "version": 3, "strides": None}


def _tensor_at(ptr: int, shape, dtype: torch.dtype) -> torch.Tensor:
    typestr = {torch.float32: "<f4", torch.int32: "<i4"}[dtype]
    return torch.as_tensor(_CudaArray(ptr, shape, typestr), device="cuda")


def _lib():
    lib = build.library("ring_peer")
    if lib.ring_peer_alloc.argtypes is None:
        vp = ctypes.c_void_p
        for name, args in (
                ("ring_peer_alloc", [ctypes.c_ulonglong,
                                     ctypes.POINTER(vp), vp]),
                ("ring_peer_open", [vp, ctypes.POINTER(vp)]),
                ("ring_peer_close", [vp]), ("ring_peer_free", [vp]),
                ("ring_peer_handle_bytes", []),
                ("ring_peer_wait_launch", [vp, vp, ctypes.c_int,
                                           ctypes.c_uint, vp,
                                           ctypes.c_ulonglong, vp]),
                ("ring_peer_signal_launch", [vp, ctypes.c_uint, vp])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def peer_operands(self_t: torch.Tensor, left: torch.Tensor,
                  right: torch.Tensor, terms: Sequence[Tuple[int, float]],
                  n_ranks: int, out: Optional[torch.Tensor] = None
                  ) -> List[int]:
    """Check a peer combine's operands on any device and return the terms'
    operand codes (:func:`~repro_torch.kernels.ring_dma.ring_sources` over
    ``n_ranks``): three ``(1, rows, 128)`` f32 payloads of one shape, ``out``
    (if given) like them and none of them."""
    for name, t in (("left", left), ("right", right)):
        if t.shape != self_t.shape or t.dtype != self_t.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, self "
                             f"{self_t.dtype} {tuple(self_t.shape)}")
    if (self_t.dim() != 3 or self_t.shape[0] != 1
            or self_t.shape[-1] != LANE or self_t.dtype != torch.float32):
        raise ValueError(f"the peer ring combine takes (1, rows, {LANE}) f32 "
                         f"payloads, got {self_t.dtype} "
                         f"{tuple(self_t.shape)}")
    if out is not None:
        if out.shape != self_t.shape or out.dtype != self_t.dtype:
            raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, "
                             "expected the payloads'")
        if any(out.data_ptr() == t.data_ptr() for t in (self_t, left, right)):
            raise ValueError("out is one of the payloads the combine reads")
    return ring_sources(terms, n_ranks)


def ring_peer_flat(self_t: torch.Tensor, left: torch.Tensor,
                   right: torch.Tensor, terms: Sequence[Tuple[int, float]],
                   n_ranks: int, *, out: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``out = Σₖ wₖ · x_srcₖ`` on the card, one launch: ``terms`` are the
    ring's ``(shift, weight)`` pairs in topology order over ``n_ranks``
    ranks (shift +1 reads ``left``, the payload of agent a − 1; −1 reads
    ``right``); ``left`` / ``right`` may be views of a peer's memory
    (:class:`PeerRing`).  Bit-equal to
    :func:`repro_torch.kernels.ref.ring_peer_ref`."""
    src = peer_operands(self_t, left, right, terms, n_ranks, out)
    for name, t in (("self", self_t), ("left", left), ("right", right)):
        if t.device.type != "cuda" or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel takes contiguous, "
                             "16-byte aligned CUDA tensors")
    if out is None:
        out = torch.empty_like(self_t)
    check(out, "out", self_t)
    n = len(src)
    fn = launcher("ring_peer", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(self_t.device):
        err = fn(self_t.data_ptr(), left.data_ptr(), right.data_ptr(),
                 out.data_ptr(), (ctypes.c_int * n)(*src),
                 (ctypes.c_float * n)(*(float(w) for _, w in terms)), n,
                 self_t.numel() // 4, stream(self_t))
    raise_on(err, "ring_peer")
    count_launch(ring_peer_flat)
    return out


ring_peer_flat.launches = 0


class PeerRing:
    """One rank's place in a ring of ranks that read each other's payloads.

    ``shape``: the ``(1, rows, 128)`` f32 payload; ``index``: this rank's
    place among the ring's ``n`` ranks (ring order); ``timeout_s`` bounds
    every flag wait.  Making it allocates the shared payload
    (:attr:`payload`) and its IPC :attr:`handle`; :meth:`open` takes every
    rank's handle, in ring order, and maps the neighbours' payloads
    (:attr:`left`, :attr:`right`: views of their memory).  :attr:`epoch`
    counts the combines done."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device,
                 index: int, n: int, timeout_s: float = 60.0):
        shape = tuple(shape)
        if len(shape) != 3 or shape[0] != 1 or shape[-1] != LANE:
            raise ValueError(f"a peer ring payload is (1, rows, {LANE}), got "
                             f"{shape}")
        if not 0 <= index < n:
            raise ValueError(f"ring index {index} is not in [0, {n})")
        self.shape, self.device = shape, torch.device(device)
        self.me, self.n = index, n
        self.timeout_ns = int(timeout_s * 1e9)
        self.epoch = 0
        self._lib = lib = _lib()
        payload_bytes = -(-shape[1] * LANE * 4 // FLAG_BYTES) * FLAG_BYTES
        self._flag_off = payload_bytes
        handle = ctypes.create_string_buffer(lib.ring_peer_handle_bytes())
        ptr = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            raise_on(lib.ring_peer_alloc(payload_bytes + FLAG_BYTES,
                                         ctypes.byref(ptr), handle),
                     "ring_peer allocation")
            self._own = ptr.value
            self.payload = _tensor_at(self._own, shape, torch.float32)
            self._err = _tensor_at(self._own + payload_bytes + _ERR, (1,),
                                   torch.int32)
        self.handle: bytes = handle.raw
        self._opened = {}
        self._left = self._right = None

    def open(self, handles: Sequence[bytes]) -> None:
        """Map the neighbours' payloads from ``handles`` (every ring rank's
        :attr:`handle`, in ring order)."""
        if len(handles) != self.n:
            raise ValueError(f"{len(handles)} handles for a ring of {self.n}")
        peers = {}
        for j in ((self.me - 1) % self.n, (self.me + 1) % self.n):
            if j == self.me:
                peers[j] = self._own
            elif j not in self._opened:
                p = ctypes.c_void_p()
                with torch.cuda.device(self.device):
                    raise_on(self._lib.ring_peer_open(handles[j],
                                                      ctypes.byref(p)),
                             f"ring_peer open of ring rank {j}'s handle")
                self._opened[j] = p.value
                peers[j] = p.value
            else:
                peers[j] = self._opened[j]
        self._left = peers[(self.me - 1) % self.n]
        self._right = peers[(self.me + 1) % self.n]
        with torch.cuda.device(self.device):
            self.left = _tensor_at(self._left, self.shape, torch.float32)
            self.right = _tensor_at(self._right, self.shape, torch.float32)

    # -- the protocol -------------------------------------------------------
    def _flag(self, base: int, which: int) -> ctypes.c_void_p:
        return ctypes.c_void_p(base + self._flag_off + which)

    def _wait(self, which: int, target: int) -> None:
        if self._left is None:
            raise RuntimeError("PeerRing: open() the neighbours' handles "
                               "before the protocol")
        if self.n == 1 or target == 0:
            return
        left, right = self._left, self._right
        raise_on(self._lib.ring_peer_wait_launch(
            self._flag(left, which), self._flag(right, which),
            1 if left == right else 2, target,
            ctypes.c_void_p(self._own + self._flag_off + _ERR),
            self.timeout_ns, stream(self.payload)), "ring_peer wait")

    def _signal(self, which: int, value: int) -> None:
        raise_on(self._lib.ring_peer_signal_launch(
            self._flag(self._own, which), value, stream(self.payload)),
            "ring_peer signal")

    def payload_for_write(self) -> torch.Tensor:
        """The shared payload, once both neighbours have read the one it
        holds (a wait queued on the current stream): write this step's
        payload into it, then call :meth:`combine`."""
        with torch.cuda.device(self.device):
            self._wait(_DONE, self.epoch)
        return self.payload

    def combine(self, terms: Sequence[Tuple[int, float]],
                out: Optional[torch.Tensor] = None,
                payload: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Publish the payload (copied in first when ``payload`` is another
        tensor), wait for the neighbours', run the combine into ``out``,
        publish that their payloads were read, and raise if a wait timed
        out.  ``terms``: the ring's ``(shift, weight)`` pairs in topology
        order."""
        with torch.cuda.device(self.device):
            if payload is not None and \
                    payload.data_ptr() != self.payload.data_ptr():
                self._wait(_DONE, self.epoch)
                self.payload.copy_(payload)
            t = self.epoch + 1
            self._signal(_READY, t)
            self._wait(_READY, t)
            res = ring_peer_flat(self.payload, self.left, self.right, terms,
                                 self.n, out=out)
            self._signal(_DONE, t)
            self.epoch = t
            self.raise_on_timeout()
        return res

    def raise_on_timeout(self) -> None:
        """Raise if a flag wait of this rank timed out (reads the error
        word: synchronises the stream)."""
        code = int(self._err.item())
        if code:
            side = "left" if code == 1 else "right"
            raise RuntimeError(
                f"ring_peer: ring rank {self.me} waited more than "
                f"{self.timeout_ns / 1e9:g} s for its {side} neighbour's "
                f"flag at epoch {self.epoch} (a rank did not arrive)")

    def close(self) -> None:
        """Unmap the neighbours' payloads and free this rank's.  Call it
        once no rank of the ring reads this one's payload any more (the
        caller's barrier after every rank synchronised its card)."""
        if self._own is None:
            return
        with torch.cuda.device(self.device):
            torch.cuda.synchronize(self.device)
            for p in self._opened.values():
                raise_on(self._lib.ring_peer_close(ctypes.c_void_p(p)),
                         "ring_peer close")
            self.payload = self.left = self.right = self._err = None
            raise_on(self._lib.ring_peer_free(ctypes.c_void_p(self._own)),
                     "ring_peer free")
        self._own = None

