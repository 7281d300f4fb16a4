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

``wkv6`` is differentiable: where autograd records (grad mode on and an
input that requires grad) it goes through ``_WKV6``, whose backward is
``wkv6_bwd``: kernel K5b (``csrc/rwkv_wkv_bwd.cu``) on a CUDA tensor,
``wkv6_bwd_plain`` on a CPU tensor.  Under ``torch.no_grad`` or
``inference_mode`` (serving, a captured decode step) it calls the forward
directly: no autograd node, no saved tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["HEAD_DIM", "wkv6", "wkv6_plain", "wkv6_bwd", "wkv6_bwd_plain"]

HEAD_DIM = 64  # the only head size the kernel is built for (RWKV6's)


def _wide(x):
    """f32, or f64 where the input is f64 (the tests' exact reference)."""
    return x if x.dtype == torch.float64 else x.float()


def wkv6_plain(r, k, v, w, u, s0=None):
    """The recurrence step by step in f32 (the scan of ``wkv6_ref``)."""
    b, h, t, d = r.shape
    rf, kf, vf, wf = (_wide(x) for x in (r, k, v, w))
    s = torch.zeros((b, h, d, d), dtype=rf.dtype, device=r.device) if s0 is None else _wide(s0)
    uf = _wide(u)[:, :, None]  # [H, D, 1]
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


def _rows_aligned(strides, *xs, per16=8) -> bool:
    """Every (b, h, t) row starts on 16 bytes, as the kernels' 16-byte
    copies need: 16-byte-aligned bases and strides a multiple of ``per16``
    elements (8: a bf16 or f32 view of r/k/v and w; 4: an f32 dy)."""
    return all(s % per16 == 0 for s in strides[:3]) and all(x.data_ptr() % 16 == 0 for x in xs)


def _aligned(x):
    """``x`` itself if contiguous and 16-byte aligned, else a fresh copy."""
    return x if x.is_contiguous() and x.data_ptr() % 16 == 0 else x.clone(memory_format=torch.contiguous_format)


def _prepare(what, r, k, v, w, u, states):
    """Check the kernels' arguments (``states``: name -> a [B, H, D, D]
    f32 tensor or None) and return r, k, v, w sharing strides with 16-byte
    aligned rows (copied where they do not), their strides, u and the
    states contiguous and aligned."""
    b, h, t, d = r.shape
    dev = r.device
    if d != HEAD_DIM or t < 1:
        raise ValueError(f"{what}: head size {d} and T={t}; it is built for D={HEAD_DIM} and T >= 1")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: r/k/v must be bf16 or f32, got {r.dtype}")
    want = [("r", r, r.dtype, (b, h, t, d)), ("k", k, r.dtype, (b, h, t, d)), ("v", v, r.dtype, (b, h, t, d)),
            ("w", w, torch.float32, (b, h, t, d)), ("u", u, torch.float32, (h, d))]
    want += [(name, x, torch.float32, (b, h, d, d)) for name, x in states.items() if x is not None]
    for name, x, dtype, shape in want:
        if x.dtype != dtype or x.device != dev or tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} must be {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    strides = r.stride()
    if strides[3] != 1 or any(x.stride() != strides for x in (k, v, w)) or not _rows_aligned(strides, r, k, v, w):
        r, k, v, w = (x.clone(memory_format=torch.contiguous_format) for x in (r, k, v, w))  # fresh, aligned
        strides = r.stride()
    # decode reads 16-byte row pieces of u and s0, and K5b whole rows of s0 and dS_final
    return (r, k, v, w), strides, _aligned(u), [None if x is None else _aligned(x) for x in states.values()]


def _launch(r, k, v, w, u, s0):
    b, h, t, d = r.shape
    dev = r.device
    (r, k, v, w), strides, u, (s0,) = _prepare("wkv6 kernel", r, k, v, w, u, {"s0": s0})
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


def wkv6_bwd_plain(r, k, v, w, u, dy, s0=None, ds_final=None):
    """The backward of ``wkv6_plain`` step by step in f32 (f64 for f64
    inputs): given dy [B, H, T, D] and dS_final [B, H, D, D] (None: 0),
    returns (dr, dk, dv, dw, du, ds0) in f32, du [H, D] summed over B and
    ds0 only when ``s0`` was given (else None).  With S_{t-1} the state
    before step t and G_t the gradient of S_t:

        dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
        dk_t = G_t v_t + u * r_t (v_t . dy_t)
        dv_t = G_t^T k_t + dy_t (sum_i u_i r_t,i k_t,i)
        dw_t = rowsum(S_{t-1} * G_t)
        du   = sum over b, t of r_t * k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  ds0 = G_0

    The states S_{t-1} are kept for every step (B H T D^2 elements)."""
    b, h, t, d = r.shape
    rf, kf, vf, wf, dyf = (_wide(x) for x in (r, k, v, w, dy))
    uf = _wide(u)
    s = torch.zeros((b, h, d, d), dtype=rf.dtype, device=r.device) if s0 is None else _wide(s0)
    before = []
    for i in range(t):
        before.append(s)
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] * vf[:, :, i, None, :]
    g = torch.zeros_like(s) if ds_final is None else _wide(ds_final)
    dr, dk, dv, dw = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for i in reversed(range(t)):
        r_t, k_t, v_t, w_t, dy_t = (x[:, :, i] for x in (rf, kf, vf, wf, dyf))
        vdy = (v_t * dy_t).sum(-1, keepdim=True)  # [B, H, 1]
        dr[:, :, i] = torch.einsum("bhij,bhj->bhi", before[i], dy_t) + uf * k_t * vdy
        dk[:, :, i] = torch.einsum("bhij,bhj->bhi", g, v_t) + uf * r_t * vdy
        dv[:, :, i] = torch.einsum("bhij,bhi->bhj", g, k_t) + dy_t * (uf * r_t * k_t).sum(-1, keepdim=True)
        dw[:, :, i] = (before[i] * g).sum(-1)
        du += (r_t * k_t * vdy).sum(0)
        g = w_t[..., None] * g + r_t[..., None] * dy_t[..., None, :]
    return dr, dk, dv, dw, du, (None if s0 is None else g)


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("rwkv_wkv_bwd")
    if lib.wkv6_bwd.argtypes is None:
        lib.wkv6_bwd.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.wkv6_bwd.restype = ctypes.c_int
        lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
        lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


def _launch_bwd(r, k, v, w, u, dy, s0, ds_final):
    """One K5b call (two kernel launches: the sweep of the state and of its
    gradient over the 32-step chunks' edges, then each chunk's gradients):
    (dr, dk, dv, dw, du, ds0) as ``wkv6_bwd_plain``."""
    b, h, t, d = r.shape
    dev = r.device
    (r, k, v, w), strides, u, (s0, ds_final) = _prepare(
        "wkv6 backward kernel", r, k, v, w, u, {"s0": s0, "dS_final": ds_final}
    )
    if dy.dtype != torch.float32 or dy.device != dev or tuple(dy.shape) != (b, h, t, d):
        raise ValueError(f"wkv6 backward kernel: dy must be f32 {(b, h, t, d)} on {dev}, "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if dy.stride(3) != 1 or not _rows_aligned(dy.stride(), dy, per16=4):
        dy = dy.clone(memory_format=torch.contiguous_format)  # fresh, aligned
    lib = _bwd_lib()
    grads = [torch.empty((b, t, h, d), dtype=torch.float32, device=dev) for _ in range(4)]  # dr, dk, dv, dw
    du_part = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    ds0 = None if s0 is None else torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
    # scratch: the state before every 32-step chunk and G at its last step
    states = torch.empty(lib.wkv6_bwd_scratch_floats(b, h, t), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    err = lib.wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), ptr(s0), dy.data_ptr(),
        ptr(ds_final), *(g.data_ptr() for g in grads), du_part.data_ptr(), ptr(ds0), states.data_ptr(),
        b, h, t, d, *strides[:3], *dy.stride()[:3], int(r.dtype == torch.bfloat16), build.stream_handle(dev),
    )
    build.check(err, "wkv6_bwd")
    return (*(g.transpose(1, 2) for g in grads), du_part.sum(0), ds0)


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def wkv6_bwd(r, k, v, w, u, dy, s0=None, ds_final=None):
    """The gradients of ``wkv6`` in f32 (see ``wkv6_bwd_plain``).  Each call on a
    CUDA tensor is one launch of K5b, counted in ``wkv6_bwd.launches``;
    on a CPU tensor it runs ``wkv6_bwd_plain``."""
    if r.device.type == "cpu":
        return wkv6_bwd_plain(r, k, v, w, u, dy, s0, ds_final)
    _on_card(r, "wkv6_bwd")
    out = _launch_bwd(r, k, v, w, u, dy, s0, ds_final)
    wkv6_bwd.launches += 1
    return out


def _forward(r, k, v, w, u, s0):
    """K5 on a CUDA tensor (counted in ``wkv6.launches``), the plain
    version on a CPU tensor."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    _on_card(r, "wkv6")
    out = _launch(r, k, v, w, u, s0)
    wkv6.launches += 1
    return out


# the backward the autograd Function calls (a module global, as _forward,
# so a run can swap in the plain versions on the card to compare paths)
_backward = wkv6_bwd


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.set_materialize_grads(False)  # an unused S_final gives dS_final None: no zero tensor
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dw, du, ds0 = _backward(r, k, v, w, u, dy, s0, ds_final)
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, ds0


def wkv6(r, k, v, w, u, s0=None):
    """The WKV6 recurrence (see module doc), differentiable in every input.
    Each forward on a CUDA tensor is one launch of K5, counted in
    ``wkv6.launches``; its backward is one launch of K5b."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (r, k, v, w, u, s0)):
        return _WKV6.apply(r, k, v, w, u, s0)
    return _forward(r, k, v, w, u, s0)


wkv6.launches = 0
wkv6_bwd.launches = 0
