"""Kernel K5: the RWKV6 WKV recurrence."""

from repro_torch.kernels.rwkv_wkv.ops import wkv6, wkv6_plain

__all__ = ["wkv6", "wkv6_plain"]
