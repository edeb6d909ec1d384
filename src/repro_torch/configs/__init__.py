"""Architecture registry of the port.

The port covers the dense family (``smollm_360m``, and the variants
``qwen3_14b`` with QK norm, ``qwen1_5_110b`` with QKV bias,
``starcoder2_7b`` with QKV bias and an ungated GELU MLP), the MoE family
(``deepseek_moe_16b``, ``qwen3_moe_235b_a22b``), the SSM family
(``falcon_mamba_7b``, Mamba-1), the hybrid family
(``jamba_1_5_large_398b``: Mamba, attention and MoE layers in one block
period), the VLM family (``pixtral_12b``: frontend embeddings before
the tokens of a dense decoder) and the encoder-decoder family
(``whisper_small``: a bidirectional encoder over frame embeddings, a
causal decoder with cross attention), every architecture of
``repro.configs``.
``get_config(name)`` returns the full-size config, ``get_smoke_config(name)``
the reduced same-family variant the CPU tests use (2 layers, d_model 256,
vocab 512, f32), ``all_configs()`` every full-size config by name.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (  # noqa: F401
    ModelConfig, RunConfig, block_period, layer_kinds, reduced,
)

ARCH_IDS: List[str] = ["smollm_360m", "qwen3_14b", "qwen1_5_110b",
                       "starcoder2_7b", "deepseek_moe_16b",
                       "qwen3_moe_235b_a22b", "falcon_mamba_7b",
                       "jamba_1_5_large_398b", "pixtral_12b",
                       "whisper_small"]

_ALIASES = {"smollm-360m": "smollm_360m", "qwen3-14b": "qwen3_14b",
            "qwen1.5-110b": "qwen1_5_110b", "starcoder2-7b": "starcoder2_7b",
            "deepseek-moe-16b": "deepseek_moe_16b",
            "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
            "falcon-mamba-7b": "falcon_mamba_7b",
            "jamba-1.5-large-398b": "jamba_1_5_large_398b",
            "pixtral-12b": "pixtral_12b",
            "whisper-small": "whisper_small"}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCH_IDS:
        raise NotImplementedError(
            f"unknown architecture {name!r} (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
