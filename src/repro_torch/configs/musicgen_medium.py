"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
Audio frontend is a STUB: inputs are 4 parallel EnCodec codebook token streams
(delay pattern applied upstream); embeddings of the 4 codebooks are summed and
the model emits 4 parallel LM heads of vocab 2048 each.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    block_pattern=(LayerSpec(),),
    ffn_gated=False,          # MusicGen uses a plain GELU MLP
    frontend="audio",
    num_codebooks=4,
    citation="arXiv:2306.05284",
))
