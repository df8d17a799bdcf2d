from repro_torch.configs.base import (  # noqa: F401
    ATTN, FFN_DENSE, FFN_MOE, FFN_MOE_DENSE, MAMBA, LayerSpec, MambaConfig,
    MLAConfig, ModelConfig, MoEConfig, get_config, register, scale_down,
)
