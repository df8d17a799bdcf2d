"""Model configuration: the port's copy of ``repro.configs.base``.

Only the fields and helpers the port's serving paths read are kept
(``ModelConfig``, ``LayerSpec``, ``MambaConfig``, ``XLSTMConfig``,
``MoEConfig``, ``MLAConfig``, ``layer_groups``, ``scale_down`` and the
registry with ``list_configs``).  Layer and FFN kinds keep the JAX names.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

ATTN = "attn"          # softmax attention (GQA or MLA)
MAMBA = "mamba"        # Mamba-1 selective SSM
MLSTM = "mlstm"        # xLSTM matrix-LSTM
SLSTM = "slstm"        # xLSTM scalar-LSTM
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_MOE_DENSE = "moe+dense"   # Arctic-style parallel dense residual + MoE
FFN_NONE = "none"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence-mixing op plus an FFN kind."""
    mixer: str = ATTN
    ffn: str = FFN_DENSE


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    num_shared_experts: int = 0      # DeepSeek-style always-on experts
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    # tokens per dispatch group of the GShard dispatch; capacity scales
    # with it (the JAX package's REPRO_MOE_GROUP override is not kept)
    dispatch_group: int = 512
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0   # mLSTM up-projection factor
    conv_kernel: int = 4
    slstm_conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    block_pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    first_layers: tuple[LayerSpec, ...] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    qk_norm: bool = False
    ffn_gated: bool = True           # SwiGLU (3 mats) vs plain MLP (2 mats)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # modality frontends (stubs): the vision stub's patch-embedding
    # positions and the audio stub's codebook count
    frontend: str = "none"           # none | vision | audio
    num_patch_tokens: int = 0
    num_codebooks: int = 1
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def gqa_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_specs(self) -> list[LayerSpec]:
        """Expand first_layers + block_pattern to n_layers LayerSpecs."""
        rest = self.n_layers - len(self.first_layers)
        if rest < 0:
            raise ValueError("first_layers longer than n_layers")
        pat = self.block_pattern
        reps = math.ceil(rest / len(pat))
        return list(self.first_layers) + (list(pat) * reps)[:rest]

    def layer_groups(self) -> list[tuple[tuple[LayerSpec, ...], int]]:
        """Group layers into (pattern, repeat_count), in the order the JAX
        package stacks them (``group{gi}`` leaves carry a leading ``reps``
        axis); ``models.convert`` unstacks in this order."""
        groups: list[tuple[tuple[LayerSpec, ...], int]] = []
        for spec in self.first_layers:
            groups.append(((spec,), 1))
        rest = self.n_layers - len(self.first_layers)
        pat = self.block_pattern
        full, rem = divmod(rest, len(pat))
        if full:
            groups.append((tuple(pat), full))
        if rem:
            groups.append((tuple(pat[:rem]), 1))
        return groups


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import each config module for its register() side effect
    from repro_torch.configs import (  # noqa: F401
        arctic_480b, deepseek_v2_236b, jamba_1_5_large_398b, llama2_70b,
        llava_next_34b, minitron_4b, musicgen_medium, qwen3_4b, qwen3_8b,
        starcoder2_7b, tiny, xlstm_1_3b)


def scale_down(cfg: ModelConfig, *, n_layers: int = 0, d_model: int = 128,
               n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Reduced same-family config for CPU tests (same rule as the JAX
    package's ``scale_down``, restricted to the fields kept here): the
    block pattern, the Mamba and xLSTM settings and the frontend stay, the
    widths shrink; at most 4 experts, top-2, expert and shared widths
    2·d_model, dispatch groups of 64 tokens; MLA at latent rank 32, q rank
    48, nope and value dims = the head dim, rope dim 8; at most 8 patch
    tokens."""
    pat_len = min(len(cfg.block_pattern), 8)
    layers = n_layers or (len(cfg.first_layers) + pat_len)
    kv = max(1, min(cfg.n_kv_heads, n_heads))
    hd = max(8, d_model // n_heads)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), expert_d_ff=d_model * 2,
            shared_d_ff=d_model * 2 if cfg.moe.num_shared_experts else 0,
            dispatch_group=64)
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=hd,
                        qk_rope_dim=8, v_head_dim=hd)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=kv, head_dim=hd,
        d_ff=0 if cfg.d_ff == 0 else d_model * 3, vocab_size=vocab, moe=moe,
        mla=mla,
        num_patch_tokens=min(cfg.num_patch_tokens, 8)
        if cfg.num_patch_tokens else 0)
