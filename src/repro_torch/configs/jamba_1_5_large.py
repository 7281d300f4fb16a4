"""Jamba-1.5-Large 398B at its published widths: Mamba and attention in a
7:1 interleave (attention at period index 4 of 8), an MoE FFN of 16
experts top-2 on every second layer [arXiv:2403.19887]."""

from repro_torch.configs.base import HybridCfg, ModelConfig, MoECfg, register

CONFIG = register(
    ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        hybrid=HybridCfg(period=8, attn_index=4, d_state=16, conv_width=4, expand=2),
        moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576, every=2),
        subquadratic=True,  # mamba O(1) state + only 9 attention layers
    )
)
