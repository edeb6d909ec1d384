"""Quantized gossip wire: bf16 / int8 per-block-scaled bus payloads.

The counterpart of ``repro/core/wire.py`` (DESIGN §9), which imports jax;
the port keeps this copy.  A :class:`WireCodec` encodes the f32 ``(...,
rows, 128)`` bus payload of a gossip round into one of three wire formats
and decodes it in the combine, so the payload shrinks while every iterate,
accumulator and combine stays f32.

Wire formats (``WIRE_FORMATS``):

* ``f32``  — identity; the uncompressed wire.
* ``bf16`` — round-to-nearest-even bf16 payload; 2 bytes/elem.
* ``int8`` — symmetric per-block int8 with one f32 scale per
  ``(block_rows, 128)`` bus block; 1 byte/elem + 4/(block_rows·128).  The
  scale blocks are the bus layout's ``block_rows`` tiles, a data format
  independent of any CUDA block shape.

int8 block math::

    absmax = max(|x|) over the (block_rows, 128) block (non-finite → 0)
    scale  = absmax / 127
    q      = clip(round(x * 127 / absmax), -127, 127)   int8
    deq    = q * scale

``round`` is round-half-to-even (``torch.round``, as ``jnp.round``).  An
all-zero block (the bus pad tail) gets ``scale == 0`` and ``q == 0`` with
no 0/0, so pads decode to exact zero.  NaN encodes to 0 and ±Inf
saturates to ±127 of the finite absmax.  A NaN ``q`` (±Inf in a block
whose finite values are all 0, where ``x · inv`` is ``Inf · 0``) is set
to 0 explicitly before the int8 cast, which is what JAX's cast gives on
the CPU; PyTorch's cast of NaN to int8 is not relied on.

The absmax, scale and reciprocal are the fused kernel's plain version's
(:mod:`repro_torch.kernels.ref`), so codec and kernel agree on them bit
for bit.

Error feedback: the bus-resident EF step sends ``Q(φ + e)`` and carries
the residual ``e`` (:func:`repro_torch.core.optimizers.make_edm_bus_ef`,
:func:`encode_ef`).  The residual is sender-local and carries across
rounds, so a schedule round that skips a peer cannot orphan it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels.edm_update import LANE
from repro_torch.kernels.ref import finite_absmax, int8_scale_inv

__all__ = ["WIRE_FORMATS", "WireCodec", "make_codec", "encode_ef"]

WIRE_FORMATS = ("f32", "bf16", "int8")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Encode/decode one wire format for ``(..., rows, 128)`` f32 buses.

    The encoded *payload* is what the mixing engines permute component by
    component:

    * ``f32``  — the input tensor, untouched;
    * ``bf16`` — one bf16 tensor of the input shape;
    * ``int8`` — ``(q, scale)``: int8 data of the input shape and f32
      scales of shape ``(*batch, rows // block_rows)``, one per tile in
      tile order, so permuting both along the agent axis with the same
      plan keeps every block next to its scale.
    """

    fmt: str
    block_rows: int

    def __post_init__(self):
        if self.fmt not in WIRE_FORMATS:
            raise ValueError(f"wire format {self.fmt!r} not in "
                             f"{WIRE_FORMATS}")
        if self.block_rows <= 0 or self.block_rows % 8:
            raise ValueError(f"block_rows must be a positive multiple of 8, "
                             f"got {self.block_rows}")

    # ---- wire facts ------------------------------------------------------
    @property
    def wire_dtype(self) -> torch.dtype:
        return _DTYPES[self.fmt]

    def payload_bytes(self, n_elems: int) -> int:
        """Modeled wire bytes of an ``n_elems``-element payload (data plus
        the int8 per-block scales)."""
        if self.fmt == "f32":
            return 4 * n_elems
        if self.fmt == "bf16":
            return 2 * n_elems
        n_blocks = math.ceil(n_elems / (self.block_rows * LANE))
        return n_elems + 4 * n_blocks

    def compression_ratio(self, n_elems: int) -> float:
        """f32 bytes / this format's bytes for the same payload."""
        return 4.0 * n_elems / self.payload_bytes(n_elems)

    # ---- codec -----------------------------------------------------------
    def _blocked(self, x: torch.Tensor) -> torch.Tensor:
        *batch, rows, lane = x.shape
        if rows % self.block_rows:
            raise ValueError(f"rows {rows} of {tuple(x.shape)} not a "
                             f"multiple of block_rows={self.block_rows}")
        return x.reshape(*batch, rows // self.block_rows,
                         self.block_rows * lane)

    def encode(self, x: torch.Tensor):
        """f32 ``(..., rows, 128)`` bus → wire payload (plain PyTorch; the
        fused path is :func:`repro_torch.kernels.ops.edm_update_bus_ef`)."""
        if self.fmt == "f32":
            return x
        if self.fmt == "bf16":
            return x.to(torch.bfloat16)
        blocks = self._blocked(x)
        scale, inv = int8_scale_inv(finite_absmax(blocks))
        q = blocks * inv[..., None]
        q = q.round_().clamp_(-127.0, 127.0)
        q.masked_fill_(torch.isnan(blocks), 0.0)     # NaN → 0, ±Inf → ±127
        q.masked_fill_(torch.isnan(q), 0.0)          # Inf·0 → 0 before the cast
        return q.to(torch.int8).reshape(x.shape), scale

    def decode(self, payload) -> torch.Tensor:
        """Wire payload → f32 bus."""
        if self.fmt == "f32":
            return payload
        if self.fmt == "bf16":
            return payload.float()
        q, scale = payload
        return (self._blocked(q.float()) * scale[..., None]).reshape(q.shape)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """The quantization operator Q = decode ∘ encode (the oracle: the
        wire-coded engines equal the f32 engines applied to
        ``quantize(x)``)."""
        return self.decode(self.encode(x))

    # ---- payload components ---------------------------------------------
    def payload_leaves(self, payload) -> tuple:
        """The payload's tensors in canonical order (data first)."""
        return tuple(payload) if self.fmt == "int8" else (payload,)

    def payload_from_leaves(self, leaves):
        leaves = tuple(leaves)
        return leaves if self.fmt == "int8" else leaves[0]

    def map_payload(self, fn: Callable, payload):
        """Apply a tensor op (a permute) to every payload component."""
        return self.payload_from_leaves(
            fn(l) for l in self.payload_leaves(payload))


def make_codec(fmt: str, block_rows: int) -> WireCodec:
    """Wire codec for ``fmt`` ∈ WIRE_FORMATS with the bus layout's
    ``block_rows`` as the int8 scale-block height."""
    return WireCodec(fmt=fmt, block_rows=block_rows)


def encode_ef(codec: WireCodec, c: torch.Tensor):
    """Error-feedback encode: ``(payload, residual)`` of the corrected
    payload ``c = φ + e``, residual ``c − decode(payload)`` — the plain
    path of the EF step.  On the tile that holds ±Inf and otherwise only
    zeros this gives a residual of ±Inf where the fused kernel gives NaN,
    as the JAX package's codec and Pallas kernel do (ROADMAP.md §3)."""
    payload = codec.encode(c)
    if codec.fmt == "f32":
        return payload, torch.zeros_like(c)
    return payload, c - codec.decode(payload)
