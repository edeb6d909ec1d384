"""StarCoder2-7B — dense GQA + RoPE, non-gated GELU MLP. [arXiv:2402.19173]

A copy of ``repro/configs/starcoder2_7b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18432, vocab_size=49152, rope_theta=1e5, mlp_gated=False,
    qkv_bias=True,
    source="arXiv:2402.19173",
)
