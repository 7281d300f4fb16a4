"""Model configuration dataclasses + the architecture registry.

The fields of ``repro/configs/base.py`` that serving and training read, plus the
architecture switches ``models.model.check_supported`` rejects until
their slice is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["MoECfg", "ModelConfig", "register", "get_config", "ARCHS"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1  # MoE FFN on layers where (idx % every == every-1)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize gates over the selected top-k
    # dispatch fabric by name; on one device every name runs the virtual
    # dense fabric, which still enforces a ScheduleTable row's admission
    dispatch: str = "dense"
    # wire codec of the dispatched slots: "bf16" (identity), "fp8" or "int8" (parallel/fabric/codec.py)
    wire_dtype: str = "bf16"
    schedule_strategy: Literal["maxweight", "shift"] = "maxweight"
    # accepted so configs build as the JAX package's do; the port's expert
    # FFN always runs its grouped kernel on a CUDA tensor, whatever this says
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    sliding_window: int | None = None
    pos_embedding: Literal["rope", "sinusoidal"] = "rope"
    block: Literal["attn", "rwkv6"] = "attn"
    moe: MoECfg | None = None
    hybrid: object | None = None
    frontend: Literal["none", "patch", "frames"] = "none"
    ffn_gelu: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rwkv_head_dim: int = 64
    # training activation checkpointing: "block" recomputes each layer's
    # forward in the backward (torch.utils.checkpoint), "none" keeps it
    remat: Literal["none", "block"] = "block"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'rwkv6' for layer idx (the port has no hybrid interleave;
        ``models.model.check_supported`` rejects ``hybrid``)."""
        return self.block

    def ffn_kind(self, idx: int) -> str:
        """'dense' | 'moe' for layer idx (rwkv6 uses its own channel mix)."""
        if self.moe is not None and idx % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    @property
    def n_moe_layers(self) -> int:
        return sum(self.ffn_kind(l) == "moe" for l in range(self.n_layers))


ARCHS: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
