"""Mamba selective scan (K6) and its backward (K6b): the CUDA kernels'
wrappers and their plain versions.

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

``selective_scan`` is differentiable in every input but ``h_out``: where
autograd records (grad mode on and an input that requires grad) it goes
through ``_SelectiveScan``, whose forward launches K6 with checkpoints
(the state before every ``ckpt_steps()``-th step, [B, ceil(S / ck), ds,
di] f32, the interval K6b was built to read) and whose backward is ``selective_scan_bwd``: K6b
(``csrc/mamba_scan_bwd.cu``) on a CUDA tensor, ``selective_scan_bwd_plain``
on a CPU tensor.  Under ``torch.no_grad`` or ``inference_mode`` (serving,
a captured decode step) it calls the forward directly: no autograd node,
no checkpoint buffer.  ``h_out`` is a serving argument and raises where
autograd records.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["MAX_STATE", "bind_bwd", "ckpt_steps", "selective_scan", "selective_scan_plain", "selective_scan_bwd",
           "selective_scan_bwd_plain"]

MAX_STATE = 16  # states a channel the kernel holds in registers (Mamba's d_state)


def _wide(x):
    """f32, or f64 where the input is f64 (the tests' exact reference)."""
    return x if x.dtype == torch.float64 else x.float()


def selective_scan_plain(x, dt, b, c, a, d_skip, h0=None, h_out=None):
    """The recurrence step by step in f32, as ``_scan_ssm``'s scan body."""
    bsz, s, di = x.shape
    xf = x.to(_wide(dt).dtype)
    h = torch.zeros((bsz, di, a.shape[1]), dtype=xf.dtype, device=x.device) if h0 is None else h0.to(xf.dtype)
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


def selective_scan_bwd_plain(x, dt, b, c, a, d_skip, dy, h0=None, dh_final=None, checkpoints=None):
    """The gradients of ``selective_scan`` by the explicit reverse recurrence
    in f32 (f64 when dt is f64), not autograd: every state kept from one
    forward pass (``checkpoints`` is ignored), then, t from S - 1 down to 0,
    with e = exp(dt_t a) and the adjoint g = dL/dh_t (from ``dh_final``,
    or 0),

        g     += dy_t c_t                 dc_t   = sum_i dy_t h_t
        ddt_t  = sum_s g (a e h_t-1 + x_t b_t)     dx_t = sum_s g dt_t b_t + d_skip dy_t
        da    += sum_b g dt_t e h_t-1     db_t   = sum_i g dt_t x_t
        g      = e g

    Returns ``(dx, ddt [B, S, di], db, dc [B, S, ds], da [di, ds],
    dd_skip [di], dh0 [B, di, ds] or None when h0 is None)``: K6b's plain
    version."""
    bsz, s, di = x.shape
    ds = a.shape[1]
    wide = _wide(dt).dtype
    xf, dtf, bf, cf, af, dsk, dyf = (t.to(wide) for t in (x, dt, b, c, a, d_skip, dy))
    h = torch.zeros((bsz, di, ds), dtype=wide, device=x.device) if h0 is None else h0.to(wide)
    hs = [h]
    for t in range(s):
        h = torch.exp(dtf[:, t, :, None] * af) * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        hs.append(h)
    g = torch.zeros_like(h) if dh_final is None else dh_final.to(wide)
    dx, ddt = torch.empty_like(dtf), torch.empty_like(dtf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros_like(af)
    for t in range(s - 1, -1, -1):
        d_t = dtf[:, t, :, None]
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        dc[:, t] = (dyf[:, t, :, None] * hs[t + 1]).sum(1)
        e = torch.exp(d_t * af)
        eh = e * hs[t]
        ddt[:, t] = (g * (eh * af + xf[:, t, :, None] * bf[:, t, None, :])).sum(-1)
        da += (g * eh * d_t).sum(0)
        dx[:, t] = (g * bf[:, t, None, :]).sum(-1) * dtf[:, t] + dyf[:, t] * dsk
        db[:, t] = (g * (dtf[:, t] * xf[:, t])[..., None]).sum(1)
        g = g * e
    dd = (dyf * xf).sum((0, 1))
    return dx, ddt, db, dc, da, dd, (g if h0 is not None else None)


@functools.cache
def _fwd():
    """The forward kernel's C entry point, bound once."""
    fn = build.load("mamba_scan").mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_bwd(lib):
    """Set the argument types of a K6b library's C entry points (the
    package's build, or another build of the same interface that a profile
    times beside it); returns ``lib``."""
    lib.mamba_scan_bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.mamba_scan_bwd.restype = ctypes.c_int
    for name in ("mamba_scan_bwd_ckpt_steps", "mamba_scan_bwd_block_channels"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib():
    """The backward kernel's library, bound once."""
    return bind_bwd(build.load("mamba_scan_bwd"))


def ckpt_steps() -> int:
    """Steps between the checkpoints K6 writes for K6b: the interval
    ``csrc/mamba_scan_bwd.cu`` was built to read (its ``CK``)."""
    return _bwd_lib().mamba_scan_bwd_ckpt_steps()


def _check_inputs(what, x, dt, b, c, a, d_skip, extra):
    """Shapes, dtypes and device of a launch's inputs; ``extra`` maps a name to
    (tensor or None, shape).  Returns (B, S, di, ds)."""
    bsz, s, di = x.shape
    ds = a.shape[1]
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32) or not 1 <= ds <= MAX_STATE or s < 1:
        raise ValueError(f"{what}: x {x.dtype}, ds={ds}, S={s}; it takes bf16 or f32 x, "
                         f"1 <= ds <= {MAX_STATE} and S >= 1")
    want = [("dt", dt, (bsz, s, di)), ("b", b, (bsz, s, ds)), ("c", c, (bsz, s, ds)), ("a", a, (di, ds)),
            ("d_skip", d_skip, (di,))]
    want += [(name, t, shape) for name, (t, shape) in extra.items() if t is not None]
    for name, t, shape in want:
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be f32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return bsz, s, di, ds


def _n_checkpoints(s: int, ck: int | None = None) -> int:
    return -(-s // (ck or ckpt_steps()))


def _launch(x, dt, b, c, a, d_skip, h0=None, h_out=None, checkpoints=False):
    """One launch; every tensor contiguous on one device (copied where not).
    Returns (y, h), plus the checkpoints [B, ceil(S / ckpt_steps()), ds, di]
    with ``checkpoints``."""
    bsz, s, di, ds = _check_inputs("selective_scan kernel", x, dt, b, c, a, d_skip,
                                   {"h0": (h0, (x.shape[0], x.shape[2], a.shape[1])),
                                    "h_out": (h_out, (x.shape[0], x.shape[2], a.shape[1]))})
    dev = x.device
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("selective_scan kernel: h_out must be contiguous")
    x, dt, b, c, a, d_skip = (t.contiguous() for t in (x, dt, b, c, a, d_skip))
    h0 = None if h0 is None else h0.contiguous()
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dev)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=dev) if h_out is None else h_out
    hck = torch.empty((bsz, _n_checkpoints(s), ds, di), dtype=torch.float32, device=dev) if checkpoints else None
    err = _fwd()(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), d_skip.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(), None if hck is None else hck.data_ptr(),
        bsz, s, di, ds, ckpt_steps() if checkpoints else 0, int(x.dtype == torch.bfloat16), build.stream_handle(dev),
    )
    build.check(err, "mamba_scan_fwd")
    return (y, h, hck) if checkpoints else (y, h)


def _launch_bwd(x, dt, b, c, a, d_skip, dy, h0, dh_final, checkpoints, lib=None):
    """One launch of K6b (the scan kernel and the ordered sums of its
    partials); returns what ``selective_scan_bwd_plain`` returns.  ``lib``
    (default the package's build) is a library bound by ``bind_bwd``."""
    lib = lib or _bwd_lib()
    bsz, s, di, ds = x.shape[0], x.shape[1], x.shape[2], a.shape[1]
    state = (bsz, di, ds)
    _check_inputs("selective_scan backward kernel", x, dt, b, c, a, d_skip, {
        "dy": (dy, (bsz, s, di)), "h0": (h0, state), "dh_final": (dh_final, state),
        "checkpoints": (checkpoints, (bsz, _n_checkpoints(s, lib.mamba_scan_bwd_ckpt_steps()), ds, di))})
    if checkpoints is None:
        raise ValueError("selective_scan backward kernel: needs the forward's checkpoints (_launch(..., checkpoints=True))")
    dev = x.device
    x, dt, b, c, a, d_skip, dy, checkpoints = (
        t.contiguous() for t in (x, dt, b, c, a, d_skip, dy, checkpoints))
    dh_final = None if dh_final is None else dh_final.contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    dx, ddt = torch.empty((bsz, s, di), **f32), torch.empty((bsz, s, di), **f32)
    dbc = torch.empty((bsz, s, 2, MAX_STATE), **f32)
    da, dd = torch.empty((di, ds), **f32), torch.empty((di,), **f32)
    dh0 = None if h0 is None else torch.empty(state, **f32)
    n_blocks = -(-di // lib.mamba_scan_bwd_block_channels())
    part_bc = torch.empty((n_blocks, bsz, s, 2 * MAX_STATE), **f32)
    part_a, part_d = torch.empty(state, **f32), torch.empty((bsz, di), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.mamba_scan_bwd(
        x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(), d_skip.data_ptr(),
        checkpoints.data_ptr(), dy.data_ptr(), ptr(dh_final), dx.data_ptr(), ddt.data_ptr(), dbc.data_ptr(),
        da.data_ptr(), dd.data_ptr(), ptr(dh0), part_bc.data_ptr(), part_a.data_ptr(), part_d.data_ptr(),
        bsz, s, di, ds, int(x.dtype == torch.bfloat16), build.stream_handle(dev),
    )
    build.check(err, "mamba_scan_bwd")
    return dx, ddt, dbc[:, :, 0, :ds].contiguous(), dbc[:, :, 1, :ds].contiguous(), da, dd, dh0


def _on_card(x, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def selective_scan_bwd(x, dt, b, c, a, d_skip, dy, h0=None, dh_final=None, checkpoints=None):
    """The gradients of ``selective_scan`` in f32 (see
    ``selective_scan_bwd_plain``).  Each call on a CUDA tensor is one launch
    of K6b, counted in ``selective_scan_bwd.launches``, and needs the
    forward's ``checkpoints``; on a CPU tensor it runs the plain version."""
    if x.device.type == "cpu":
        return selective_scan_bwd_plain(x, dt, b, c, a, d_skip, dy, h0, dh_final)
    _on_card(x, "selective_scan_bwd")
    out = _launch_bwd(x, dt, b, c, a, d_skip, dy, h0, dh_final, checkpoints)
    selective_scan_bwd.launches += 1
    return out


def _forward(x, dt, b, c, a, d_skip, h0=None, h_out=None, checkpoints=False):
    """K6 on a CUDA tensor (counted in ``selective_scan.launches``), the
    plain version on a CPU tensor (which writes no checkpoints: None)."""
    if x.device.type == "cpu":
        out = selective_scan_plain(x, dt, b, c, a, d_skip, h0, h_out)
        return (*out, None) if checkpoints else out
    _on_card(x, "selective_scan")
    out = _launch(x, dt, b, c, a, d_skip, h0, h_out, checkpoints)
    selective_scan.launches += 1
    return out


# the backward the autograd Function calls (a module global, as _forward,
# so a run can swap in the plain versions on the card to compare paths)
_backward = selective_scan_bwd


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, b, c, a, d_skip, h0):
        ctx.set_materialize_grads(False)  # an unused final state gives dh_final None: no zero tensor
        y, h, hck = _forward(x, dt, b, c, a, d_skip, h0, checkpoints=True)
        ctx.save_for_backward(x, dt, b, c, a, d_skip, h0, hck)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, b, c, a, d_skip, h0, hck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, db, dc, da, dd, dh0 = _backward(x, dt, b, c, a, d_skip, dy, h0, dh_final, checkpoints=hck)
        return dx.to(x.dtype), ddt, db, dc, da, dd, dh0


def selective_scan(x, dt, b, c, a, d_skip, h0=None, h_out=None):
    """The scan (see module doc), differentiable in every input but
    ``h_out``.  Each forward on a CUDA tensor is one launch of K6, counted
    in ``selective_scan.launches``; its backward is one launch of K6b."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, dt, b, c, a, d_skip, h0)):
        if h_out is not None:
            raise ValueError("selective_scan: h_out is a serving argument; autograd records this call")
        return _SelectiveScan.apply(x, dt, b, c, a, d_skip, h0)
    return _forward(x, dt, b, c, a, d_skip, h0, h_out)


selective_scan.launches = 0
selective_scan_bwd.launches = 0
