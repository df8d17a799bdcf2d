"""Qwen3-4B — dense, qk_norm, GQA [hf:Qwen/Qwen3-4B; hf].

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,              # Qwen3 uses explicit head_dim=128
    block_pattern=(LayerSpec(),),
    qk_norm=True,
    rope_theta=1_000_000.0,
    citation="hf:Qwen/Qwen3-4B",
))
