"""MusicGen-Large at its published widths: decoder-only over EnCodec tokens
(vocab 2048) with sinusoidal positions, full MHA and no RoPE; the
conditioning frames arrive as 256 precomputed embeddings
[arXiv:2306.05284]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        pos_embedding="sinusoidal",
        frontend="frames",
        frontend_tokens=256,
    )
)
