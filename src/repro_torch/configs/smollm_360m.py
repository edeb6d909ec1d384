"""SmolLM-360M — llama-arch small dense. [hf:HuggingFaceTB/SmolLM-135M family]

A copy of ``repro/configs/smollm_360m.py``."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49152, rope_theta=1e4,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
