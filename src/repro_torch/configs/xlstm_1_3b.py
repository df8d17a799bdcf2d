"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H d_ff=0 (xLSTM blocks embed their own up/down projections;
no separate FFN). 7:1 mLSTM:sLSTM interleave (sLSTM at in-group index 7).
"""
from repro_torch.configs.base import (
    MLSTM, SLSTM, FFN_NONE, LayerSpec, XLSTMConfig, ModelConfig, register,
)

_pattern = tuple(
    LayerSpec(mixer=SLSTM if i == 7 else MLSTM, ffn=FFN_NONE)
    for i in range(8)
)

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_pattern,
    xlstm=XLSTMConfig(proj_factor=2.0, conv_kernel=4),
    citation="arXiv:2405.04517",
))
