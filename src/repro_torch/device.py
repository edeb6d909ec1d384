"""Device resolution for the port's entry points.

The port runs on the card.  ``device=None`` means ``cuda``; the CPU is used
only when the caller asks for it by name, and nothing falls back to it.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  Raises if a CUDA device is asked for (or
    implied) and none is available; ``"cpu"`` must be requested explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run the "
                "plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected cuda or cpu")
    return dev
