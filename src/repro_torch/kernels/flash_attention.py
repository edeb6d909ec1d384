"""CUDA kernel of flash GQA attention (forward only).

:func:`flash_attention_flat` wraps ``csrc/flash_attention.cu``, the
counterpart of the Pallas kernel
``repro/kernels/flash_attention.py::_flash_kernel``: q ``(B, H, Sq, hd)``
against k, v ``(B, K, Sk, hd)``, query head h reading KV head
``h // (H/K)``, causal and sliding-window masks on absolute positions from
0 on both axes, an online softmax in f32 and one rounding to q's dtype; a
row with no live key outputs 0.

In bf16 it runs a tensor-core kernel (wgmma fed by TMA, one block per
128 query positions of one query head); in f32 a SIMT kernel, one block
per query tile of a KV head's G query heads.  It takes CUDA tensors
only, checks them through :func:`repro_torch.kernels._ffi.check`,
launches on PyTorch's current stream and raises on a non-zero CUDA
status.
``flash_attention_flat.launches`` counts its launches, incremented where
the kernel is launched and nowhere else.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; the device dispatch
and the JAX shape contract are
:func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._ffi import (DTYPE_CODE, check, check_head, count_launch, launcher,
                   raise_on, stream)

__all__ = ["MAX_GROUP", "flash_attention_flat"]

MAX_GROUP = 64      # query heads per KV head: the f32 kernel's block rows


def flash_attention_flat(q, k, v, *, causal: bool, window: int = 0,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash GQA attention on the card.  q: (B, H, Sq, hd); k, v:
    (B, K, Sk, hd); one dtype (f32 or bf16), contiguous.  ``window = 0``
    is no window.  Returns (B, H, Sq, hd) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention_flat takes (B, H, S, hd) q and "
                         f"k, got {tuple(q.shape)} and {tuple(k.shape)}")
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    check_head(q, hd)
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"{H} query heads over {K} KV heads: H must be a "
                         f"multiple of K with H/K <= {MAX_GROUP}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    check(q, "q", q, dtypes=(q.dtype,))
    for name, t in (("k", k), ("v", v)):
        check(t, name, q, dtypes=(q.dtype,), shape=(B, K, Sk, hd))
    if out is None:
        out = torch.empty_like(q)
    check(out, "out", q, dtypes=(q.dtype,))
    fn = launcher("flash_attention", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 DTYPE_CODE[q.dtype], B, H, K, Sq, Sk, hd, int(bool(causal)),
                 int(window), hd ** -0.5, stream(q))
    raise_on(err, "flash_attention")
    count_launch(flash_attention_flat)
    return out


flash_attention_flat.launches = 0
