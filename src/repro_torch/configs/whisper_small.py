"""Whisper-small — enc-dec audio; conv/mel frontend is a stub supplying
1500 frame embeddings. [arXiv:2212.04356]

A copy of ``repro/configs/whisper_small.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, mlp_gated=False, pos_emb="sinusoidal",
    n_frontend_tokens=1500,
    source="arXiv:2212.04356",
)
