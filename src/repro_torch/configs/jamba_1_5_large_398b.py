"""Jamba-1.5-Large-398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]

A copy of ``repro/configs/jamba_1_5_large_398b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, experts_per_token=2, moe_every=2, moe_offset=1,
    dense_d_ff=24576,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    attn_every=8, attn_offset=4,   # 1 attention per 8 layers (1:7)
    source="arXiv:2403.19887",
)
