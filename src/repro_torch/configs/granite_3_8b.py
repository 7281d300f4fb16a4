"""Granite-3.0-8B at its published widths: GQA, SwiGLU
[hf:ibm-granite/granite-3.0-2b-base family]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-3-8b",
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
    )
)
