"""LLaMA-2-70B — the paper's own evaluation model [arXiv:2307.09288].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=32000.  The model of the
paper's cost-model case study (Table 2) and optimal-throughput numbers.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    block_pattern=(LayerSpec(),),
    citation="arXiv:2307.09288",
))
