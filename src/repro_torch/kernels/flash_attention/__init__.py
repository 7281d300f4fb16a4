"""Kernel K4: flash attention forward (prefill)."""

from repro_torch.kernels.flash_attention.ops import (
    NEG,
    attention_mask,
    flash_attention,
    flash_attention_plain,
    kernel_readable,
)

__all__ = ["NEG", "attention_mask", "flash_attention", "flash_attention_plain", "kernel_readable"]
