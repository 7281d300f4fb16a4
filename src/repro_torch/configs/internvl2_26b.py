"""InternVL2-26B at its published widths: an InternLM2 backbone behind a
vision frontend stub, 256 precomputed patch embeddings prepended to the
text [arXiv:2404.16821]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        frontend="patch",
        frontend_tokens=256,
    )
)
