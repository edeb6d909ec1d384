"""PyTorch/CUDA port of the EDM decentralized trainer.

The package mirrors :mod:`repro`'s module names (``configs``, ``core``,
``kernels``, ``models``, ``data``, ``train``, ``launch``) so a reader finds
each counterpart beside the JAX reference.  It imports ``torch`` and
numpy only: never ``jax`` and nothing of ``repro``.

Every entry point runs on the GPU unless the caller passes
``device="cpu"`` (``--device cpu`` on the CLI); without a GPU and without
that explicit request it raises (:func:`repro_torch.device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
