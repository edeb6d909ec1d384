"""Qwen3-14B — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B family]

A copy of ``repro/configs/qwen3_14b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, rope_theta=1e6, qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
