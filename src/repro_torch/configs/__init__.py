from repro_torch.configs.base import (  # noqa: F401
    ATTN, FFN_DENSE, FFN_MOE, FFN_MOE_DENSE, FFN_NONE, MAMBA, MLSTM, SLSTM,
    LayerSpec, MambaConfig, MLAConfig, ModelConfig, MoEConfig, XLSTMConfig,
    get_config, register, scale_down,
)
