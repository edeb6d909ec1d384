"""Pixtral-12B — VLM: Pixtral ViT frontend (stub) + Mistral-Nemo-style LM.
[hf:mistralai/Pixtral-12B-2409]

A copy of ``repro/configs/pixtral_12b.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072, rope_theta=1e9,
    n_frontend_tokens=256,   # ViT patch embeddings supplied by the stub
    source="hf:mistralai/Pixtral-12B-2409",
)
