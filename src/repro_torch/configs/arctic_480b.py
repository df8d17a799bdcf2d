"""Snowflake Arctic (480B) — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8, group 7) d_ff=4864 vocab=32000, MoE 128e
top-2.  Arctic is a dense-MoE *hybrid residual*: each layer runs a dense
FFN in parallel with the routed MoE and sums the outputs (FFN_MOE_DENSE).
"""
from repro_torch.configs.base import (FFN_MOE_DENSE, LayerSpec, ModelConfig,
                                      MoEConfig, register)

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=(LayerSpec(ffn=FFN_MOE_DENSE),),
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864),
    citation="hf:Snowflake/snowflake-arctic-base",
))
