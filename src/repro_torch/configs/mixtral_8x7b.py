"""Mixtral-8x7B at its published widths [arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=14336, every=1),
    )
)
