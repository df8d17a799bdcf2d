"""LLaVA-NeXT-34B — VLM, anyres tiling [hf:llava-hf/llava-v1.6; unverified].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Backbone-only per assignment: the vision tower is a STUB — ``input_specs()``
provides precomputed patch embeddings (anyres tiling → 1024 patch tokens for
the 32k shapes, scaled for smaller sequences) which the model projects with a
single learned matrix and prepends to the text-token embeddings.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=(LayerSpec(),),
    frontend="vision",
    num_patch_tokens=1024,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
