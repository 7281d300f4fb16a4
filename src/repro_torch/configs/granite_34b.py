"""Granite-34B-Code at its published widths: llama-arch with MQA (kv=1) and
the GPT-BigCode 2-matrix GELU MLP [arXiv:2405.04324]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        ffn_gelu=True,
    )
)
