"""Kernel K1: grouped SwiGLU expert GEMM with the occupancy skip."""

from repro_torch.kernels.moe_gemm.ops import ROW_TILE, moe_gemm, moe_gemm_plain, tile_occupancy

__all__ = ["ROW_TILE", "moe_gemm", "moe_gemm_plain", "tile_occupancy"]
