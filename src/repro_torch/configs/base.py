"""Model configuration: the port's copy of ``repro.configs.base``.

Only the fields and helpers the packed dense-GQA serving path reads are
kept (``ModelConfig``, ``LayerSpec``, ``layer_groups``, ``scale_down`` and
the registry).  Layer and FFN kinds keep the JAX names; the kinds of later
slices (MLA, MoE, recurrent mixers) come with them.
"""
from __future__ import annotations

import dataclasses
import math

ATTN = "attn"          # softmax attention (GQA)
FFN_DENSE = "dense"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence-mixing op plus an FFN kind."""
    mixer: str = ATTN
    ffn: str = FFN_DENSE


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
    qk_norm: bool = False
    ffn_gated: bool = True           # SwiGLU (3 mats) vs plain MLP (2 mats)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "none"
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


def _load_all() -> None:
    # import each config module for its register() side effect
    from repro_torch.configs import qwen3_8b, tiny  # noqa: F401


def scale_down(cfg: ModelConfig, *, n_layers: int = 0, d_model: int = 128,
               n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """Reduced same-family config for CPU tests (same rule as the JAX
    package's ``scale_down``, restricted to the fields kept here)."""
    pat_len = min(len(cfg.block_pattern), 8)
    layers = n_layers or (len(cfg.first_layers) + pat_len)
    kv = max(1, min(cfg.n_kv_heads, n_heads))
    hd = max(8, d_model // n_heads)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=kv, head_dim=hd,
        d_ff=0 if cfg.d_ff == 0 else d_model * 3, vocab_size=vocab)
