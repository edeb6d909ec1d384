"""Qwen3-MoE-235B-A22B — 128 experts, top-8, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-30B-A3B family, scaled per assignment]

A copy of ``repro/configs/qwen3_moe_235b_a22b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, rope_theta=1e6, qk_norm=True,
    n_experts=128, experts_per_token=8,
    source="hf:Qwen/Qwen3-30B-A3B",
)
