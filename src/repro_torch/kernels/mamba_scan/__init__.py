"""Kernels K6 (the Mamba selective scan) and K6b (its backward)."""

from repro_torch.kernels.mamba_scan.ops import (
    selective_scan,
    selective_scan_bwd,
    selective_scan_bwd_plain,
    selective_scan_plain,
)

__all__ = ["selective_scan", "selective_scan_bwd", "selective_scan_bwd_plain", "selective_scan_plain"]
