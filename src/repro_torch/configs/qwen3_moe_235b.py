"""Qwen3-MoE-235B-A22B at its published widths: 128 experts top-8
[arXiv:2505.09388].  The paper's primary integration target; an explicit
head_dim of 128 makes the q/k/v width 8192 over d_model 4096."""

from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,  # explicit head_dim 128 (q width 8192)
        d_ff=1536,  # per-expert FFN width
        vocab_size=151936,
        moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=1536, every=1),
    )
)
