"""DBRX-132B at its published widths: 16 experts top-4, fine-grained MoE
[hf:databricks/dbrx-base]."""

from repro_torch.configs.base import ModelConfig, MoECfg, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        moe=MoECfg(n_experts=16, top_k=4, d_ff_expert=10752, every=1),
    )
)
