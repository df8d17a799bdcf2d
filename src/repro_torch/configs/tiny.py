"""Tiny configs for CPU tests and examples (~100M-class and below)."""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG_100M = register(ModelConfig(
    name="tiny-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    block_pattern=(LayerSpec(),),
    citation="n/a (example)",
))

CONFIG_TOY = register(ModelConfig(
    name="tiny-toy",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab_size=512,
    block_pattern=(LayerSpec(),),
    citation="n/a (example)",
))
