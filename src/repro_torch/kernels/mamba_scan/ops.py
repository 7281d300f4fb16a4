"""Mamba selective scan (K6): the CUDA kernel's wrapper and its plain version.

``selective_scan(x, dt, b, c, a, d_skip, h0=None, h_out=None)`` takes x
[B, S, di] (the compute dtype), dt [B, S, di] f32, b/c [B, S, ds] f32,
a [di, ds] f32 (``-exp(a_log)``), d_skip [di] f32 and h0 [B, di, ds] f32
(None: zeros), and returns ``(y [B, S, di] f32, h [B, di, ds] f32)`` with,
per (b, channel i) and t in order,

    h   = exp(dt_t,i a_i) * h + (dt_t,i x_t,i) b_t
    y_t = sum_s h_s c_t,s + d_skip_i x_t,i

x widened to f32 first: the recurrence of JAX's ``_scan_ssm`` plus its
skip term.  ``h_out`` (a [B, di, ds] f32 tensor, may be ``h0`` itself)
receives the final state and is returned as ``h``: a decode step writes
the cache's own tensor in place.  On a CUDA tensor it launches
``csrc/mamba_scan.cu`` (ds <= 16 states a channel) or raises; on a CPU
tensor it runs ``selective_scan_plain``.  No Pallas kernel computes this:
the JAX model runs the recurrence as a ``lax.scan``
(``repro/models/mamba.py``, ``_scan_ssm``), so K6 is a port-side kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["MAX_STATE", "selective_scan", "selective_scan_plain"]

MAX_STATE = 16  # states a channel the kernel holds in registers (Mamba's d_state)


def selective_scan_plain(x, dt, b, c, a, d_skip, h0=None, h_out=None):
    """The recurrence step by step in f32, as ``_scan_ssm``'s scan body."""
    bsz, s, di = x.shape
    xf = x.float()
    h = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32, device=x.device) if h0 is None else h0.float()
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a)  # [B, di, ds]
        dbx = (dt[:, t] * xf[:, t])[..., None] * b[:, t, None, :]
        h = da * h + dbx
        ys.append((h * c[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + d_skip * xf
    if h_out is not None:
        h_out.copy_(h)
        h = h_out
    return y, h


@functools.cache
def _fwd():
    """The kernel's C entry point, bound once."""
    fn = build.load("mamba_scan").mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, dt, b, c, a, d_skip, h0=None, h_out=None):
    """One launch; every tensor contiguous on one device (copied where not)."""
    bsz, s, di = x.shape
    ds = a.shape[1]
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= ds <= MAX_STATE or s < 1:
        raise ValueError(f"selective_scan kernel: x {x.dtype}, ds={ds}, S={s}; it takes bf16 or f32 x, "
                         f"1 <= ds <= {MAX_STATE} and S >= 1")
    want = [("dt", dt, (bsz, s, di)), ("b", b, (bsz, s, ds)), ("c", c, (bsz, s, ds)), ("a", a, (di, ds)),
            ("d_skip", d_skip, (di,))]
    want += [(name, t, (bsz, di, ds)) for name, t in (("h0", h0), ("h_out", h_out)) if t is not None]
    for name, t, shape in want:
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"selective_scan kernel: {name} must be f32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("selective_scan kernel: h_out must be contiguous")
    x, dt, b, c, a, d_skip = (t.contiguous() for t in (x, dt, b, c, a, d_skip))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dev)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=dev) if h_out is None else h_out
    err = _fwd()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), d_skip.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        bsz, s, di, ds, int(x.dtype == torch.bfloat16), build.stream_handle(dev),
    )
    build.check(err, "mamba_scan_fwd")
    return y, h


def selective_scan(x, dt, b, c, a, d_skip, h0=None, h_out=None):
    """The scan (see module doc).  Each call on a CUDA tensor is one kernel
    launch, counted in ``selective_scan.launches``."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, dt, b, c, a, d_skip, h0, h_out)
    if x.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device {x.device}")
    out = _launch(x, dt, b, c, a, d_skip, h0, h_out)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0
