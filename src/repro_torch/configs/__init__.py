"""Architecture registry: importing this package registers the configs.

Mixtral-8x7B and RWKV6-7B are ported so far; ``smoke_config`` gives the reduced
same-family variant the CPU tests run (same rule as ``repro.configs``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ARCHS, ModelConfig, MoECfg, get_config, register
from repro_torch.configs import mixtral_8x7b, rwkv6_7b  # noqa: F401  (registers)


def smoke_config(cfg: ModelConfig | str) -> ModelConfig:
    """Tiny widths and depth, same layer pattern, GQA ratio and top-k."""
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
    period = cfg.moe.every if cfg.moe is not None else 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2 * period,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=8 if cfg.sliding_window else None,
        moe=moe,
        rwkv_head_dim=16,
        remat="none",
    )


__all__ = ["ARCHS", "ModelConfig", "MoECfg", "get_config", "register", "smoke_config"]
