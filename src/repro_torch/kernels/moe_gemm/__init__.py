"""Kernels K1 (grouped SwiGLU expert GEMM with the occupancy skip), K2/K3
(its dgrad and wgrad) and K3b (the ungrouped forward)."""

from repro_torch.kernels.moe_gemm.ops import (
    ROW_TILE,
    moe_gemm,
    moe_gemm_bwd,
    moe_gemm_bwd_plain,
    moe_gemm_dgrad,
    moe_gemm_dgrad_plain,
    moe_gemm_plain,
    moe_gemm_ungrouped,
    moe_gemm_wgrad,
    moe_gemm_wgrad_plain,
    tile_occupancy,
)

__all__ = [
    "ROW_TILE",
    "moe_gemm",
    "moe_gemm_bwd",
    "moe_gemm_bwd_plain",
    "moe_gemm_dgrad",
    "moe_gemm_dgrad_plain",
    "moe_gemm_plain",
    "moe_gemm_ungrouped",
    "moe_gemm_wgrad",
    "moe_gemm_wgrad_plain",
    "tile_occupancy",
]
