"""Model configuration dataclasses + the architecture registry.

The fields of ``repro/configs/base.py`` that serving and training read;
``models.model.check_supported`` names the combinations the port does
not run.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["MoECfg", "HybridCfg", "ModelConfig", "register", "get_config", "ARCHS"]


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
    # ranks per pod for the hierarchical fabric (must divide the EP size;
    # core.check_pod_size names the valid divisors); the flat fabrics ignore it
    pod_size: int = 2
    # wire codec of the dispatched slots: "bf16" (identity), "fp8" or "int8" (parallel/fabric/codec.py)
    wire_dtype: str = "bf16"
    schedule_strategy: Literal["maxweight", "shift"] = "maxweight"
    # JAX's 2D expert sharding (expert FFN width over 'data'): no effect on one device, as in JAX; refused under
    # a world (models/moe.py)
    expert_2d: bool = False
    # accepted so configs build as the JAX package's do; the port's expert
    # FFN always runs its grouped kernel on a CUDA tensor, whatever this says
    use_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """Jamba-style interleave: one attention layer per ``period`` layers,
    the rest Mamba."""

    period: int = 8
    attn_index: int = 0  # which layer within the period is attention
    d_state: int = 16
    conv_width: int = 4
    expand: int = 2  # d_inner = expand * d_model


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
    hybrid: HybridCfg | None = None
    # modality frontend stub: ``frontend_tokens`` precomputed embeddings prepended to the tokens
    frontend: Literal["none", "patch", "frames"] = "none"
    frontend_tokens: int = 0
    ffn_gelu: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    rwkv_head_dim: int = 64
    # long-context policy: does the arch run the 500k-token decode cell (launch/shapes.py)?
    subquadratic: bool = False
    # training activation checkpointing: "block" recomputes each layer's
    # forward in the backward (torch.utils.checkpoint), "none" keeps it
    remat: Literal["none", "block"] = "block"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'mamba' | 'rwkv6' for layer idx."""
        if self.hybrid is not None:
            return "attn" if idx % self.hybrid.period == self.hybrid.attn_index else "mamba"
        return self.block

    def ffn_kind(self, idx: int) -> str:
        """'dense' | 'moe' for layer idx (rwkv6 uses its own channel mix)."""
        if self.moe is not None and idx % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    @property
    def period(self) -> int:
        """The repeating layer pattern's length: the JAX package stacks each
        period position's parameters over ``n_periods``."""
        if self.hybrid is not None:
            return self.hybrid.period
        return self.moe.every if self.moe is not None else 1

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.period)
        return self.n_layers // self.period

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
