"""Kernel K6: the Mamba selective scan."""

from repro_torch.kernels.mamba_scan.ops import selective_scan, selective_scan_plain

__all__ = ["selective_scan", "selective_scan_plain"]
