"""H2O-Danube3-4B at its published widths: llama+mistral mix with a 4096-token
sliding window, head dim 120 [arXiv:2401.16818]."""

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,  # head_dim 120
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        sliding_window=4096,
        subquadratic=True,  # window-bounded KV cache -> long_500k runs
    )
)
