from repro_torch.configs.base import (  # noqa: F401
    ATTN, FFN_DENSE, LayerSpec, ModelConfig, get_config, register,
    scale_down,
)
