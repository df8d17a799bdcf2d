"""StarCoder2-7B — GQA, RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=(LayerSpec(),),
    ffn_gated=False,          # StarCoder2 uses a plain GELU MLP
    rope_theta=1_000_000.0,
    citation="arXiv:2402.19173",
))
