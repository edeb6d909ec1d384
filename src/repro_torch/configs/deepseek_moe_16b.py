"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6, MHA.
[arXiv:2401.06066]

A copy of ``repro/configs/deepseek_moe_16b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, rope_theta=1e4,
    n_experts=64, experts_per_token=6, n_shared_experts=2,
    source="arXiv:2401.06066",
)
