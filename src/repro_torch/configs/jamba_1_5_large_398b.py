"""Jamba-1.5-Large (398B) — hybrid Mamba+attention 1:7 interleave, MoE 16e
top-2 [arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; Mamba d_state 16,
d_conv 4, expand 2.  Pattern: 9 groups of 8 layers; attention at in-group
index 4, Mamba elsewhere; MoE on every odd in-group index, dense FFN
otherwise.
"""
from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, MAMBA,
                                      LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig, register)

_pattern = tuple(
    LayerSpec(
        mixer=ATTN if i == 4 else MAMBA,
        ffn=FFN_MOE if i % 2 == 1 else FFN_DENSE,
    )
    for i in range(8)
)

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=_pattern,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    citation="arXiv:2403.19887",
))
