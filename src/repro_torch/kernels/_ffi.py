"""What every kernel wrapper shares: the ctypes entry point of a built
library, the operand checks made before raw pointers leave Python, the
launch stream and the CUDA status check.

Each ``csrc/<name>.cu`` exports one plain-C ``<name>_launch(...)`` that
returns ``cudaGetLastError()``; dtypes cross as ``DTYPE_CODE`` integers.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from . import build

__all__ = ["DTYPE_CODE", "FLOAT_DTYPES", "MAX_HEAD_DIM", "agent_blocks",
           "agent_stride", "check", "check_head", "launcher", "overlaps",
           "raise_on", "sm_count", "stream"]

# dtype codes of the C launchers; int8 is the quantized gossip wire's
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOAT_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256      # the attention kernels' shared-memory tiles

_sm_counts: Dict[torch.device, int] = {}


def launcher(name: str, argtypes: Sequence):
    """``<name>_launch`` of the library built from ``csrc/<name>.cu``,
    with its ctypes signature set (``int`` result)."""
    fn = getattr(build.library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def agent_stride(t: torch.Tensor) -> int:
    """Elements from agent ``a``'s block of ``t`` to agent ``a + 1``'s
    (the numel of a block for a contiguous tensor)."""
    if t.dim() == 0 or t.shape[0] == 0:
        return t.numel()
    return t.stride(0) if t.shape[0] > 1 else t[0].numel()


def agent_blocks(ts: Sequence[torch.Tensor]) -> Tuple[int, int, list]:
    """``(blocks, elements a block, each tensor's elements between blocks)``
    for a combine's tensors ``ts`` of one shape: one block of every element
    when all are contiguous (a leaf of any shape: its leading dim need not
    be an agent axis, nor a row of it 16-byte aligned), else the agent
    blocks ``t[a]``, as a policy group's rows ``bus[:, r0:r1]`` are."""
    if all(t.is_contiguous() for t in ts):
        size = ts[0].numel()
        return 1, size, [size] * len(ts)
    n_agents = ts[0].shape[0]
    return n_agents, ts[0].numel() // n_agents, [agent_stride(t) for t in ts]


def _blocks_dense(t: torch.Tensor) -> bool:
    """Are ``t``'s agent blocks ``t[a]`` each dense, and apart?  True for a
    contiguous tensor and for the rows ``bus[:, r0:r1]`` of a larger one."""
    if t.is_contiguous():
        return True
    return (t.dim() >= 2 and t[0].is_contiguous()
            and agent_stride(t) >= t[0].numel())


def extent(t: torch.Tensor) -> Tuple[int, int]:
    """``[start, end)`` byte addresses that ``t``'s agent blocks span."""
    if t.numel() == 0:
        return t.data_ptr(), t.data_ptr()
    n = t.numel() // t.shape[0] if t.dim() else 1
    last = (t.shape[0] - 1) * agent_stride(t) if t.dim() else 0
    return t.data_ptr(), t.data_ptr() + (last + n) * t.element_size()


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Do the byte spans of ``a``'s and ``b``'s agent blocks meet?  (Two
    row slices of one bus interleave, so they count as meeting.)"""
    a0, a1 = extent(a)
    b0, b1 = extent(b)
    return a0 < b1 and b0 < a1


def check(t: torch.Tensor, name: str, like: torch.Tensor,
          dtypes=(torch.float32,), shape=None,
          agent_strided: bool = False) -> None:
    """Raise unless ``t`` is a 16-byte aligned CUDA tensor on ``like``'s
    device, of a dtype in ``dtypes`` and of shape ``shape`` (default:
    ``like``'s), and contiguous — or, with ``agent_strided``, with dense
    agent blocks ``t[a]`` (a policy group's rows of a larger bus) whose
    stride keeps every block 16-byte aligned."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    want = tuple(like.shape if shape is None else shape)
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {want}")
    if not t.is_contiguous():
        if not agent_strided:
            raise ValueError(f"{name} must be contiguous")
        if not _blocks_dense(t):
            raise ValueError(f"{name}: every agent block {name}[a] must be "
                             f"dense (the trailing dims contiguous) and the "
                             f"blocks apart, got strides {t.stride()}")
        if agent_stride(t) * t.element_size() % 16:
            raise ValueError(f"{name}: agent stride {agent_stride(t)} "
                             f"elements is not a multiple of 16 bytes")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_head(q: torch.Tensor, hd: int) -> None:
    """Raise unless the attention kernels take ``q``'s dtype and head dim
    ``hd`` (a multiple of 8 up to :data:`MAX_HEAD_DIM`)."""
    if q.dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype {q.dtype} not in {FLOAT_DTYPES}")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (read once, then cached):
    what the attention kernels' split plans fill."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device]


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` for a kernel the wrapper ran.  Under
    CUDA graph capture a launch only records the kernel into the graph,
    and the graph's replays run it with no wrapper call, so neither is
    counted here: a replay's launches are read from a device trace."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
