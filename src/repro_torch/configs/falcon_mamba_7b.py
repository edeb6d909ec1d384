"""Falcon-Mamba-7B — pure Mamba-1 SSM, attention-free. [arXiv:2410.05355]

A copy of ``repro/configs/falcon_mamba_7b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355",
)
