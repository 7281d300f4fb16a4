"""Grouped SwiGLU expert GEMM: the CUDA kernel's wrapper and its plain version.

``moe_gemm(x, w_gate, w_up, w_down, row_valid)`` computes, per expert e,
``out[e] = cast(silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]``
with f32 accumulation and the output in ``x.dtype``.  Row tiles of
``ROW_TILE`` slots holding no live row (``row_valid`` [E, C]) are exact
zeros; a tile with a live row computes all its rows.  On a CUDA tensor
the wrapper launches ``csrc/moe_gemm.cu`` (bf16 only) or raises; on a
CPU tensor it runs ``moe_gemm_plain``, which rounds where the kernel
does: ``h`` once to ``x.dtype`` from f32 ``g`` and ``u``.
Counterpart of ``repro.kernels.moe_gemm.moe_gemm(..., row_valid=...)``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["ROW_TILE", "moe_gemm", "moe_gemm_plain", "tile_occupancy"]

ROW_TILE = 64  # BM in csrc/moe_gemm.cu; the kernel reports its own at launch


def tile_occupancy(row_valid: torch.Tensor) -> torch.Tensor:
    """[E, C] bool: True on every row of a ``ROW_TILE``-row tile that holds
    a live row (the rows the kernel computes)."""
    e, c = row_valid.shape
    n_tiles = -(-c // ROW_TILE)
    pad = torch.zeros((e, n_tiles * ROW_TILE - c), dtype=torch.bool, device=row_valid.device)
    occ = torch.cat([row_valid.bool(), pad], dim=1).reshape(e, n_tiles, ROW_TILE).any(-1)
    return occ.repeat_interleave(ROW_TILE, dim=1)[:, :c]


def moe_gemm_plain(x, w_gate, w_up, w_down, row_valid):
    """The kernel's function in plain PyTorch (f32 products, one rounding
    of ``h``, zeros on dark tiles)."""
    xf = x.float()
    g = torch.bmm(xf, w_gate.float())
    u = torch.bmm(xf, w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    out = torch.bmm(h.float(), w_down.float()).to(x.dtype)
    occupied = tile_occupancy(row_valid)[..., None]
    return torch.where(occupied, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gemm")
    if lib.moe_gemm_grouped.argtypes is None:
        lib.moe_gemm_grouped.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.moe_gemm_grouped.restype = ctypes.c_int
        lib.moe_gemm_row_tile.argtypes = []
        lib.moe_gemm_row_tile.restype = ctypes.c_int
        if lib.moe_gemm_row_tile() != ROW_TILE:
            raise RuntimeError(f"csrc/moe_gemm.cu tiles {lib.moe_gemm_row_tile()} rows, wrapper {ROW_TILE}")
    return lib


def _launch(x, w_gate, w_up, w_down, row_valid):
    e, c, d = x.shape
    f = w_gate.shape[-1]
    for name, t, shape in (
        ("x", x, (e, c, d)), ("w_gate", w_gate, (e, d, f)), ("w_up", w_up, (e, d, f)),
        ("w_down", w_down, (e, f, d)),
    ):
        if t.dtype != torch.bfloat16 or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"moe_gemm kernel: {name} must be bf16 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_gemm kernel: {name} must be contiguous and 16-byte aligned")
    if row_valid.shape != (e, c) or row_valid.device != x.device:
        raise ValueError(f"moe_gemm kernel: row_valid must be [{e}, {c}] on {x.device}")
    if d % 64 or f % 64:
        raise ValueError(f"moe_gemm kernel: d ({d}) and F ({f}) must be multiples of 64")
    lib = _lib()
    rv = row_valid.to(torch.bool).contiguous().view(torch.uint8)
    h = torch.empty((e, c, f), dtype=torch.bfloat16, device=x.device)  # scratch
    out = torch.empty_like(x)
    err = lib.moe_gemm_grouped(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        rv.data_ptr(), h.data_ptr(), out.data_ptr(), e, c, d, f,
        build.stream_handle(x.device),
    )
    build.check(err, "moe_gemm_grouped")
    return out


def moe_gemm(x, w_gate, w_up, w_down, row_valid):
    """Grouped SwiGLU over [E, C, d] (see module doc).  Each call on a
    CUDA tensor is one launch of the kernel (its gate/up and down
    passes), counted in ``moe_gemm.launches``."""
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w_gate, w_up, w_down, row_valid)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for device {x.device}")
    out = _launch(x, w_gate, w_up, w_down, row_valid)
    moe_gemm.launches += 1
    return out


moe_gemm.launches = 0
