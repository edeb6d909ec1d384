"""Architecture registry of the port.

The port covers the dense family so far: ``smollm_360m``.  The other
architectures of ``repro.configs`` are listed in ``ROADMAP.md`` as still to
be ported.  ``get_config(name)`` returns the full-size config,
``get_smoke_config(name)`` the reduced same-family variant the CPU tests
use (2 layers, d_model 256, vocab 512, f32).
"""
from __future__ import annotations

import importlib
from typing import List

from .base import (  # noqa: F401
    ModelConfig, RunConfig, block_period, layer_kinds, reduced,
)

ARCH_IDS: List[str] = ["smollm_360m"]

_ALIASES = {"smollm-360m": "smollm_360m"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {ARCH_IDS}; "
            "see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))
