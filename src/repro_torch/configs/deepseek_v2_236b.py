"""DeepSeek-V2 (236B) — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H (MLA: per-head keys and values are up-projected from
a 512-d latent, which is all the cache holds) vocab=102400.  Layer 0 has a
dense FFN of 12288; layers 1-59 are MoE with 160 routed experts top-6 of
width 1536 and 2 shared experts (1536 each, fused to 3072).
"""
from repro_torch.configs.base import (ATTN, FFN_DENSE, FFN_MOE, LayerSpec,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,                     # dense layer-0 FFN dim
    vocab_size=102400,
    first_layers=(LayerSpec(mixer=ATTN, ffn=FFN_DENSE),),
    block_pattern=(LayerSpec(mixer=ATTN, ffn=FFN_MOE),),
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  num_shared_experts=2, shared_d_ff=3072),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    citation="arXiv:2405.04434",
))
