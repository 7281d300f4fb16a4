"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

``wkv6(r, k, v, w, u, s0=None)`` takes r/k/v/w [B, H, T, D] and u
[H, D] and returns ``(y [B, H, T, D] f32, S_final [B, H, D, D] f32)``
with, per (b, h) and t in order,

    y_t = r_t^T (S + diag(u) k_t v_t^T)
    S   = diag(w_t) S + k_t v_t^T

from S = 0, or from ``s0`` [B, H, D, D] f32 when given (a decode step
carries the state).  r/k/v are widened to f32 before any product; w and
u are f32.  On a CUDA tensor it launches ``csrc/rwkv_wkv.cu`` (D = 64,
r/k/v bf16 or f32) or raises; on a CPU tensor it runs ``wkv6_plain``.
The kernel reads the inputs through their strides when all four share
them with a contiguous last dim and 16-byte-aligned rows, so the model's
[B, T, H, D] activations transposed to [B, H, T, D] are not copied (other
views are made contiguous first); its y is a [B, H, T, D] view
of [B, T, H, D] storage, the layout the model reads back.  Counterpart
of ``repro.kernels.rwkv_wkv.wkv6`` (which always starts from S = 0) and
of its oracle ``wkv6_ref`` (which takes ``s0``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["HEAD_DIM", "wkv6", "wkv6_plain"]

HEAD_DIM = 64  # the only head size the kernel is built for (RWKV6's)


def wkv6_plain(r, k, v, w, u, s0=None):
    """The recurrence step by step in f32 (the scan of ``wkv6_ref``)."""
    b, h, t, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device) if s0 is None else s0.float()
    uf = u.float()[:, :, None]  # [H, D, 1]
    ys = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]  # [B, H, D, D]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, :, i], s + uf * kv))
        s = wf[:, :, i, :, None] * s + kv
    return torch.stack(ys, dim=2), s


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv_wkv")
    if lib.wkv6_fwd.argtypes is None:
        lib.wkv6_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.wkv6_fwd.restype = ctypes.c_int
    return lib


def _rows_aligned(strides, *xs) -> bool:
    """Every (b, h, t) row starts on 16 bytes, as the kernel's cp.async
    copies need: 16-byte-aligned bases and strides a multiple of 8."""
    return all(s % 8 == 0 for s in strides[:3]) and all(x.data_ptr() % 16 == 0 for x in xs)


def _launch(r, k, v, w, u, s0):
    b, h, t, d = r.shape
    dev = r.device
    if d != HEAD_DIM or t < 1:
        raise ValueError(f"wkv6 kernel: head size {d} and T={t}; it is built for D={HEAD_DIM} and T >= 1")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"wkv6 kernel: r/k/v must be bf16 or f32, got {r.dtype}")
    want = [("r", r, r.dtype, (b, h, t, d)), ("k", k, r.dtype, (b, h, t, d)), ("v", v, r.dtype, (b, h, t, d)),
            ("w", w, torch.float32, (b, h, t, d)), ("u", u, torch.float32, (h, d))]
    if s0 is not None:
        want.append(("s0", s0, torch.float32, (b, h, d, d)))
    for name, x, dtype, shape in want:
        if x.dtype != dtype or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"wkv6 kernel: {name} must be {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    strides = r.stride()
    if strides[3] != 1 or any(x.stride() != strides for x in (k, v, w)) or not _rows_aligned(strides, r, k, v, w):
        r, k, v, w = (x.clone(memory_format=torch.contiguous_format) for x in (r, k, v, w))  # fresh, aligned
        strides = r.stride()
    if not u.is_contiguous() or u.data_ptr() % 16:
        u = u.clone(memory_format=torch.contiguous_format)  # decode reads 16-byte row pieces of u
    if s0 is not None and (not s0.is_contiguous() or s0.data_ptr() % 16):
        s0 = s0.clone(memory_format=torch.contiguous_format)  # read a 16-byte row piece at a time
    y = torch.empty((b, t, h, d), dtype=torch.float32, device=dev)
    s_final = torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    err = _lib().wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_final.data_ptr(),
        b, h, t, d, strides[0], strides[1], strides[2], int(r.dtype == torch.bfloat16),
        build.stream_handle(dev),
    )
    build.check(err, "wkv6_fwd")
    return y.transpose(1, 2), s_final


def wkv6(r, k, v, w, u, s0=None):
    """The WKV6 recurrence (see module doc).  Each call on a CUDA tensor is
    one kernel launch, counted in ``wkv6.launches``."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    out = _launch(r, k, v, w, u, s0)
    wkv6.launches += 1
    return out


wkv6.launches = 0
