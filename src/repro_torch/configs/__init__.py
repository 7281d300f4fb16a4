"""Architecture registry: importing this package registers the configs,
all eleven of the JAX package's; ``smoke_config`` gives the reduced
same-family variant the CPU tests run (same rule as ``repro.configs``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ARCHS, HybridCfg, ModelConfig, MoECfg, get_config, register
from repro_torch.configs import (  # noqa: F401  (registers)
    dbrx_132b,
    granite_3_8b,
    granite_34b,
    h2o_danube_3_4b,
    internvl2_26b,
    jamba_1_5_large,
    mixtral_8x7b,
    musicgen_large,
    qwen2_1_5b,
    qwen3_moe_235b,
    rwkv6_7b,
)


def smoke_config(cfg: ModelConfig | str) -> ModelConfig:
    """Tiny widths and depth (two periods), same layer pattern, GQA ratio,
    window, top-k, hybrid interleave and frontend (4 prefix tokens)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    kv = max(1, cfg.n_kv_heads * 4 // cfg.n_heads)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe,
            n_experts=min(moe.n_experts, 8),
            top_k=min(moe.top_k, 2),
            d_ff_expert=64,
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2 * cfg.period,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=8 if cfg.sliding_window else None,
        moe=moe,
        rwkv_head_dim=16,
        frontend_tokens=4 if cfg.frontend != "none" else 0,
        remat="none",
    )


__all__ = ["ARCHS", "HybridCfg", "ModelConfig", "MoECfg", "get_config", "register", "smoke_config"]
