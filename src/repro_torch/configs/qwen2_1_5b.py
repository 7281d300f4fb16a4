"""Qwen2-1.5B at its published widths: GQA with QKV bias and tied
embeddings [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
    )
)
