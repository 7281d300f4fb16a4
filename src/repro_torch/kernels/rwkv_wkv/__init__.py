"""Kernel K5: the RWKV6 WKV recurrence, and K5b, its backward."""

from repro_torch.kernels.rwkv_wkv.ops import wkv6, wkv6_bwd, wkv6_bwd_plain, wkv6_plain

__all__ = ["wkv6", "wkv6_bwd", "wkv6_bwd_plain", "wkv6_plain"]
