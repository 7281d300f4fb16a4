"""Grouped SwiGLU expert GEMM and its backward: the CUDA kernels' wrappers
and their plain versions.

``moe_gemm(x, w_gate, w_up, w_down, row_valid)`` computes, per expert e,
``out[e] = cast(silu(x[e] @ w_gate[e]) * (x[e] @ w_up[e])) @ w_down[e]``
with f32 accumulation and the output in ``x.dtype``.  Row tiles of
``ROW_TILE`` slots holding no live row (``row_valid`` [E, C]) are exact
zeros; a tile with a live row computes all its rows.  ``row_valid=None``
computes every row (the ungrouped kernel, K3b).  The call is
differentiable: its backward (``moe_gemm_bwd``) runs the dgrad (K2) and
wgrad (K3) kernels at the forward's row tile, with the cotangent cast to
``x.dtype`` and the gradients in the inputs' dtypes; ``row_valid`` gets
none.

On a CUDA tensor each wrapper launches its kernel (bf16 only) or raises;
on a CPU tensor it runs the plain version, which rounds where the kernel
does: ``h`` once to ``x.dtype`` in the forward; ``da``, ``du`` and ``h``
to ``x.dtype`` before the backward's products (the identity in f32).
Counterpart of ``repro.kernels.moe_gemm.moe_gemm(..., row_valid=...)``
and its Pallas backward (``_pallas_bwd``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = [
    "ROW_TILE",
    "moe_gemm",
    "moe_gemm_ungrouped",
    "moe_gemm_plain",
    "moe_gemm_dgrad",
    "moe_gemm_wgrad",
    "moe_gemm_bwd",
    "moe_gemm_dgrad_plain",
    "moe_gemm_wgrad_plain",
    "moe_gemm_bwd_plain",
    "tile_occupancy",
]

ROW_TILE = 64  # BM in csrc/moe_gemm*.cu; the kernels report their own at launch
# csrc/moe_gemm_bwd.cu: row tiles per expert; wgrad lists the live ones of every expert in shared memory
MAX_ROW_TILES, MAX_EXPERTS, MAX_LISTED = 256, 256, 4096


def tile_occupancy(row_valid: torch.Tensor) -> torch.Tensor:
    """[E, C] bool: True on every row of a ``ROW_TILE``-row tile that holds
    a live row (the rows the kernels compute)."""
    e, c = row_valid.shape
    n_tiles = -(-c // ROW_TILE)
    pad = torch.zeros((e, n_tiles * ROW_TILE - c), dtype=torch.bool, device=row_valid.device)
    occ = torch.cat([row_valid.bool(), pad], dim=1).reshape(e, n_tiles, ROW_TILE).any(-1)
    return occ.repeat_interleave(ROW_TILE, dim=1)[:, :c]


def _all_live(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)


def _zero_dark(t: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    occupied = tile_occupancy(row_valid)[..., None]
    return torch.where(occupied, t, torch.zeros((), dtype=t.dtype, device=t.device))


# ------------------------------------------------------------ plain versions
def moe_gemm_plain(x, w_gate, w_up, w_down, row_valid=None):
    """The forward kernel's function in plain PyTorch (f32 products, one
    rounding of ``h``, zeros on dark tiles; ``row_valid=None``: all live)."""
    xf = x.float()
    g = torch.bmm(xf, w_gate.float())
    u = torch.bmm(xf, w_up.float())
    h = (F.silu(g) * u).to(x.dtype)
    out = torch.bmm(h.float(), w_down.float()).to(x.dtype)
    return out if row_valid is None else _zero_dark(out, row_valid)


def _silu_grads_plain(go, x, w_gate, w_up, w_down):
    """Recompute the SwiGLU activations and backprop through them (f32);
    returns ``(da, du, h)`` rounded to ``x.dtype``, as the kernels store
    them.  silu'(a) = s + a·s·(1 − s)."""
    xf = x.float()
    a = torch.bmm(xf, w_gate.float())
    u = torch.bmm(xf, w_up.float())
    s = torch.sigmoid(a)
    dh = torch.bmm(go.float(), w_down.float().transpose(1, 2))
    da = dh * u * s * (1.0 + a * (1.0 - s))
    du = dh * s * a
    return da.to(x.dtype), du.to(x.dtype), (s * a * u).to(x.dtype)


def _dgrad_from(da, du, w_gate, w_up, row_valid, dtype):
    dx = torch.bmm(da.float(), w_gate.float().transpose(1, 2)) + torch.bmm(du.float(), w_up.float().transpose(1, 2))
    return _zero_dark(dx.to(dtype), row_valid)


def _wgrad_from(go, x, da, du, h, row_valid, dtypes):
    occupied = tile_occupancy(row_valid)[..., None]  # dark tiles add nothing
    xt = torch.where(occupied, x.float(), 0.0).transpose(1, 2)
    dwg = torch.bmm(xt, da.float())
    dwu = torch.bmm(xt, du.float())
    dwd = torch.bmm(torch.where(occupied, h.float(), 0.0).transpose(1, 2), go.float())
    return tuple(g.to(dt) for g, dt in zip((dwg, dwu, dwd), dtypes))


def moe_gemm_dgrad_plain(go, x, w_gate, w_up, w_down, row_valid):
    """dx = da @ w_gateᵀ + du @ w_upᵀ (f32 accumulation, ``x.dtype`` out);
    dark tiles exactly zero.  ``go`` is already in ``x.dtype``."""
    da, du, _ = _silu_grads_plain(go, x, w_gate, w_up, w_down)
    return _dgrad_from(da, du, w_gate, w_up, row_valid, x.dtype)


def moe_gemm_wgrad_plain(go, x, w_gate, w_up, w_down, row_valid):
    """(dwg, dwu, dwd) = (xᵀda, xᵀdu, hᵀgo) over live tiles, each in its
    weight's dtype; an expert with no live tile gets exact zeros."""
    da, du, h = _silu_grads_plain(go, x, w_gate, w_up, w_down)
    return _wgrad_from(go, x, da, du, h, row_valid, (w_gate.dtype, w_up.dtype, w_down.dtype))


def moe_gemm_bwd_plain(go, x, w_gate, w_up, w_down, row_valid):
    """(dx, dwg, dwu, dwd): both plain versions sharing one recompute."""
    da, du, h = _silu_grads_plain(go, x, w_gate, w_up, w_down)
    dx = _dgrad_from(da, du, w_gate, w_up, row_valid, x.dtype)
    return (dx, *_wgrad_from(go, x, da, du, h, row_valid, (w_gate.dtype, w_up.dtype, w_down.dtype)))


# ------------------------------------------------------------------ launches
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


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("moe_gemm_bwd")
    if lib.moe_gemm_silu_grads.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gemm_silu_grads.argtypes = [ptr] * 9 + [i] * 4 + [ptr]
        lib.moe_gemm_dgrad_from.argtypes = [ptr] * 6 + [i] * 4 + [ptr]
        lib.moe_gemm_wgrad_from.argtypes = [ptr] * 9 + [i] * 4 + [ptr]
        for fn in (lib.moe_gemm_silu_grads, lib.moe_gemm_dgrad_from, lib.moe_gemm_wgrad_from):
            fn.restype = ctypes.c_int
        lib.moe_gemm_bwd_row_tile.argtypes = []
        lib.moe_gemm_bwd_row_tile.restype = ctypes.c_int
        if lib.moe_gemm_bwd_row_tile() != ROW_TILE:
            raise RuntimeError(f"csrc/moe_gemm_bwd.cu tiles {lib.moe_gemm_bwd_row_tile()} rows, wrapper {ROW_TILE}")
    return lib


def _check_args(what, x, w_gate, w_up, w_down, row_valid, go=None):
    e, c, d = x.shape
    f = w_gate.shape[-1]
    named = [("x", x, (e, c, d)), ("w_gate", w_gate, (e, d, f)), ("w_up", w_up, (e, d, f)), ("w_down", w_down, (e, f, d))]
    if go is not None:
        named.append(("go", go, (e, c, d)))
    for name, t, shape in named:
        if t.dtype != torch.bfloat16 or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"{what} kernel: {name} must be bf16 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must be contiguous and 16-byte aligned")
    if row_valid.shape != (e, c) or row_valid.device != x.device:
        raise ValueError(f"{what} kernel: row_valid must be [{e}, {c}] on {x.device}")
    if d % 64 or f % 64:
        raise ValueError(f"{what} kernel: d ({d}) and F ({f}) must be multiples of 64")
    return e, c, d, f, row_valid.to(torch.bool).contiguous().view(torch.uint8)


def _launch(x, w_gate, w_up, w_down, row_valid):
    e, c, d, f, rv = _check_args("moe_gemm", x, w_gate, w_up, w_down, row_valid)
    h = torch.empty((e, c, f), dtype=torch.bfloat16, device=x.device)  # scratch
    out = torch.empty_like(x)
    err = _lib().moe_gemm_grouped(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        rv.data_ptr(), h.data_ptr(), out.data_ptr(), e, c, d, f,
        build.stream_handle(x.device),
    )
    build.check(err, "moe_gemm_grouped")
    return out


def _launch_silu_grads(go, x, w_gate, w_up, w_down, row_valid):
    """Launch 1 of the backward: ``(da, du, h)`` bf16 ``[E, C, F]`` on live
    tiles (dark tiles left unwritten; nothing reads them)."""
    e, c, d, f, rv = _check_args("moe_gemm backward", x, w_gate, w_up, w_down, row_valid, go)
    tiles = -(-c // ROW_TILE)
    if tiles > MAX_ROW_TILES or e > MAX_EXPERTS or e * tiles > MAX_LISTED:
        raise ValueError(f"moe_gemm backward kernel: E={e}, C={c} gives {tiles} row tiles per expert "
                         f"(at most {MAX_ROW_TILES}, {MAX_LISTED} in all, {MAX_EXPERTS} experts)")
    da, du, h = (torch.empty((e, c, f), dtype=torch.bfloat16, device=x.device) for _ in range(3))
    err = _bwd_lib().moe_gemm_silu_grads(
        go.data_ptr(), x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        rv.data_ptr(), da.data_ptr(), du.data_ptr(), h.data_ptr(), e, c, d, f,
        build.stream_handle(x.device),
    )
    build.check(err, "moe_gemm_silu_grads")
    return rv, (da, du, h)


def _launch_dgrad(x, w_gate, w_up, rv, da, du):
    """Launch 2: dx = [da | du] @ [w_gateᵀ ; w_upᵀ], zeros on dark tiles."""
    e, c, d = x.shape
    dx = torch.empty_like(x)
    err = _bwd_lib().moe_gemm_dgrad_from(
        da.data_ptr(), du.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), rv.data_ptr(),
        dx.data_ptr(), e, c, d, w_gate.shape[-1], build.stream_handle(x.device),
    )
    build.check(err, "moe_gemm_dgrad_from")
    return dx


def _launch_wgrad(go, x, w_gate, rv, da, du, h):
    """Launch 3: (xᵀda, xᵀdu, hᵀgo) over live tiles, bf16."""
    e, c, d = x.shape
    f = w_gate.shape[-1]
    dwg = torch.empty((e, d, f), dtype=torch.bfloat16, device=x.device)
    dwu = torch.empty_like(dwg)
    dwd = torch.empty((e, f, d), dtype=torch.bfloat16, device=x.device)
    err = _bwd_lib().moe_gemm_wgrad_from(
        x.data_ptr(), go.data_ptr(), da.data_ptr(), du.data_ptr(), h.data_ptr(), rv.data_ptr(),
        dwg.data_ptr(), dwu.data_ptr(), dwd.data_ptr(), e, c, d, f, build.stream_handle(x.device),
    )
    build.check(err, "moe_gemm_wgrad_from")
    return dwg, dwu, dwd


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")


# ------------------------------------------------------------------ wrappers
def moe_gemm_dgrad(go, x, w_gate, w_up, w_down, row_valid):
    """K2: dx of the grouped GEMM (see ``moe_gemm_dgrad_plain``).  On a
    CUDA tensor it launches the recompute and dgrad kernels, counted once
    in ``moe_gemm_dgrad.launches``."""
    if x.device.type == "cpu":
        return moe_gemm_dgrad_plain(go, x, w_gate, w_up, w_down, row_valid)
    _on_card(x, "moe_gemm_dgrad")
    rv, (da, du, _) = _launch_silu_grads(go, x, w_gate, w_up, w_down, row_valid)
    dx = _launch_dgrad(x, w_gate, w_up, rv, da, du)
    moe_gemm_dgrad.launches += 1
    return dx


def moe_gemm_wgrad(go, x, w_gate, w_up, w_down, row_valid):
    """K3: (dwg, dwu, dwd) of the grouped GEMM (see ``moe_gemm_wgrad_plain``).
    On a CUDA tensor it launches the recompute and wgrad kernels, counted
    once in ``moe_gemm_wgrad.launches``."""
    if x.device.type == "cpu":
        return moe_gemm_wgrad_plain(go, x, w_gate, w_up, w_down, row_valid)
    _on_card(x, "moe_gemm_wgrad")
    rv, (da, du, h) = _launch_silu_grads(go, x, w_gate, w_up, w_down, row_valid)
    grads = _launch_wgrad(go, x, w_gate, rv, da, du, h)
    moe_gemm_wgrad.launches += 1
    return grads


def moe_gemm_bwd(go, x, w_gate, w_up, w_down, row_valid):
    """(dx, dwg, dwu, dwd): K2 and K3 sharing one recompute launch, as the
    autograd backward runs them (one launch counted for each)."""
    if x.device.type == "cpu":
        return moe_gemm_bwd_plain(go, x, w_gate, w_up, w_down, row_valid)
    _on_card(x, "moe_gemm_bwd")
    rv, (da, du, h) = _launch_silu_grads(go, x, w_gate, w_up, w_down, row_valid)
    dx = _launch_dgrad(x, w_gate, w_up, rv, da, du)
    moe_gemm_dgrad.launches += 1
    grads = _launch_wgrad(go, x, w_gate, rv, da, du, h)
    moe_gemm_wgrad.launches += 1
    return (dx, *grads)


def _forward(x, w_gate, w_up, w_down, row_valid):
    """K1 (``row_valid`` given) or K3b (None: every row) on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return moe_gemm_plain(x, w_gate, w_up, w_down, row_valid)
    _on_card(x, "moe_gemm")
    if row_valid is None:
        out = _launch(x, w_gate, w_up, w_down, _all_live(x))
        moe_gemm_ungrouped.launches += 1
    else:
        out = _launch(x, w_gate, w_up, w_down, row_valid)
        moe_gemm.launches += 1
    return out


# the functions the autograd Function calls (module globals, so a run can
# swap in the plain versions on the card to compare paths)
_backward = moe_gemm_bwd


class _MoEGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, row_valid):
        ctx.save_for_backward(x, w_gate, w_up, w_down, row_valid)
        return _forward(x, w_gate, w_up, w_down, row_valid)

    @staticmethod
    def backward(ctx, go):
        x, w_gate, w_up, w_down, row_valid = ctx.saved_tensors
        go = go.to(x.dtype).contiguous()
        if row_valid is None:  # the ungrouped kernel's backward: every row live
            row_valid = _all_live(x)
        dx, dwg, dwu, dwd = _backward(go, x, w_gate, w_up, w_down, row_valid)
        return dx, dwg, dwu, dwd, None


def moe_gemm(x, w_gate, w_up, w_down, row_valid=None):
    """Grouped SwiGLU over [E, C, d] (see module doc), differentiable.
    Each forward on a CUDA tensor is one launch of K1 (its gate/up and
    down passes), counted in ``moe_gemm.launches``; with ``row_valid``
    None it is one launch of K3b, counted in ``moe_gemm_ungrouped.launches``."""
    return _MoEGemm.apply(x, w_gate, w_up, w_down, row_valid)


def moe_gemm_ungrouped(x, w_gate, w_up, w_down):
    """K3b: ``moe_gemm`` with every row computed (no occupancy table)."""
    return moe_gemm(x, w_gate, w_up, w_down, None)


moe_gemm.launches = 0
moe_gemm_ungrouped.launches = 0
moe_gemm_dgrad.launches = 0
moe_gemm_wgrad.launches = 0
