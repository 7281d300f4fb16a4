"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention(q, k, v, causal=, window=)`` takes q [B, H, Sq, D] and
k/v [B, K, Skv, D] and returns [B, H, Sq, D] in q.dtype.  Like the JAX
wrapper it first scales q by ``D**-0.5`` in q's own dtype (after
``prescale``, also rounded to q's dtype, when one is given); query row i
sits at absolute position ``i + Skv - Sq`` and query head h reads kv head
``h // (H // K)``.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (bf16, D a multiple of 8 up to 128: 120 for
h2o-danube), which reads q, k
and v in place through their strides and scales q in its load with the
same roundings, or raises; on a CPU tensor it runs
``flash_attention_plain``, which rounds where the kernel does (p to
v.dtype before the PV product, output in q.dtype).  Counterpart of
``repro.kernels.flash_attention.flash_attention``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["NEG", "flash_attention", "flash_attention_plain", "attention_mask", "kernel_readable"]

NEG = -1e30  # masked logit (not -inf: a fully masked row stays finite)


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None, device) -> torch.Tensor:
    """[Sq, Skv] bool, True where query row i may see key j."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    return mask


def flash_attention_plain(q_scaled, k, v, *, causal: bool = True, window: int | None = None):
    """The kernel's function in plain PyTorch on an already scaled q."""
    b, h, sq, d = q_scaled.shape
    kh, skv = k.shape[1], k.shape[2]
    qg = q_scaled.reshape(b, kh, h // kh, sq, d).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    mask = attention_mask(sq, skv, causal=causal, window=window, device=q_scaled.device)
    s = torch.where(mask, s, torch.full((), NEG, device=s.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,bktd->bkgsd", p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q_scaled.dtype).reshape(b, h, sq, d)


@functools.cache
def _fwd():
    """The kernel's C entry point, bound once."""
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_readable(t: torch.Tensor) -> bool:
    """True if the kernel reads ``t`` in place with 16-byte loads: a unit
    innermost stride, every other stride (of a dim longer than 1) a
    multiple of 16 bytes, and a 16-byte-aligned start."""
    return t.data_ptr() % 16 == 0 and _strides_readable(tuple(t.shape), t.stride(), t.element_size())


def _strides_readable(shape, strides, element_size) -> bool:
    step = 16 // element_size
    return strides[-1] == 1 and all(st % step == 0 for st, n in zip(strides[:-1], shape[:-1]) if n > 1)


@functools.lru_cache(maxsize=256)
def _layout(q_shape, kv_shape, q_strides, k_strides, v_strides, o_strides):
    """The checked (b, h, s) strides of q, k, v and o for the kernel, as a
    C array, once per layout: the host's work per call stays small."""
    (b, h, sq, d), kh = q_shape, kv_shape[1]
    if tuple(kv_shape) != (b, kh, kv_shape[2], d):
        raise ValueError(f"flash_attention kernel: k and v must be [{b}, K, Skv, {d}], got {tuple(kv_shape)}")
    if d % 8 or not 8 <= d <= 128 or h % kh:
        raise ValueError(f"flash_attention kernel: unsupported D={d}, H={h}, K={kh}")
    for name, shape, strides in (("q", q_shape, q_strides), ("k", kv_shape, k_strides), ("v", kv_shape, v_strides)):
        if not _strides_readable(shape, strides, 2):
            raise ValueError(f"flash_attention kernel: {name} needs a unit stride in D and other strides in "
                             f"multiples of 8 elements, got strides {strides}")
    return (ctypes.c_longlong * 12)(*q_strides[:3], *k_strides[:3], *v_strides[:3], *o_strides[:3])


def _launch(q, k, v, *, causal: bool, window: int | None, prescale: float = 1.0):
    """One launch on unscaled q, read in place: the model's transposed
    [B, S, H, D] views included.  The output takes q's layout
    (``torch.empty_like``), so its [B, S, H, D] transpose is dense."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16 and q.device == k.device == v.device):
        raise ValueError(f"flash_attention kernel: q, k, v must be bf16 on one device, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype} on {q.device}/{k.device}/{v.device}")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention kernel: q, k and v must start 16-byte aligned")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention kernel: unsupported window={window}")
    out = torch.empty_like(q)
    strides = _layout(q.shape, k.shape, q.stride(), k.stride(), v.stride(), out.stride())
    b, h, sq, d = q.shape
    err = _fwd()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, k.shape[1], sq, k.shape[2], d, int(causal), -1 if window is None else window, prescale, d**-0.5,
        build.stream_handle(q.device),
    )
    build.check(err, "flash_attention_fwd")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None, prescale: float = 1.0):
    """Attention over [B, H, S, D] (see module doc).  Each call on a CUDA
    tensor is one kernel launch (the scaling of q included), counted in
    ``flash_attention.launches``."""
    if q.device.type == "cpu":
        if prescale != 1.0:
            q = q * prescale
        q_scaled = q * (q.shape[-1] ** -0.5)  # in q.dtype, as the JAX wrapper
        return flash_attention_plain(q_scaled, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = _launch(q, k, v, causal=causal, window=window, prescale=prescale)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
