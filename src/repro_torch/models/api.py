"""Public model API: the counterpart of ``repro/models/api.py`` for the
training path of the dense family.

``Model`` bundles ``init`` (a ``torch.Generator`` → parameter dict on the
generator's device), ``loss`` (``(params, batch) → scalar``) and ``meta``
(shape-only parameters, for layouts).  Serving entry points come with the
serving slice (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from . import transformer as tf

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable        # generator -> {path: tensor}
    loss: Callable        # (params, batch) -> scalar
    meta: Callable        # () -> {path: meta tensor}


def build_model(cfg: ModelConfig) -> Model:
    tf.param_specs(cfg)   # raises for families not ported yet
    return Model(cfg,
                 lambda generator: tf.init_lm(cfg, generator),
                 lambda params, batch: tf.lm_loss(cfg, params, batch),
                 lambda: tf.param_meta(cfg))
