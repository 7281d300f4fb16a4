"""RWKV6 "Finch" 7B at its published widths: attention-free, data-dependent
decay [arXiv:2404.05892]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # wkv heads = d_model / rwkv_head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        block="rwkv6",
        rwkv_head_dim=64,
        subquadratic=True,  # O(1) decode state -> long_500k runs
        tie_embeddings=False,
    )
)
