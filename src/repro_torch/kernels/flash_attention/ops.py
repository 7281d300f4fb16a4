"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention(q, k, v, causal=, window=)`` takes q [B, H, Sq, D] and
k/v [B, K, Skv, D] and returns [B, H, Sq, D] in q.dtype.  Like the JAX
wrapper it first scales q by ``D**-0.5`` in q's own dtype; query row i
sits at absolute position ``i + Skv - Sq`` and query head h reads kv head
``h // (H // K)``.  On a CUDA tensor it launches
``csrc/flash_attention.cu`` (bf16, D in 16/32/64/128) or raises; on a
CPU tensor it runs ``flash_attention_plain``, which rounds where the
kernel does (p to v.dtype before the PV product, output in q.dtype).
Counterpart of ``repro.kernels.flash_attention.flash_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["NEG", "flash_attention", "flash_attention_plain", "attention_mask"]

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


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _launch(q_scaled, k, v, *, causal: bool, window: int | None):
    b, h, sq, d = q_scaled.shape
    kh, skv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q_scaled, (b, h, sq, d)), ("k", k, (b, kh, skv, d)), ("v", v, (b, kh, skv, d))):
        if t.dtype != torch.bfloat16 or t.device != q_scaled.device or tuple(t.shape) != shape:
            raise ValueError(f"flash_attention kernel: {name} must be bf16 {shape} on {q_scaled.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if d not in (16, 32, 64, 128) or h % kh or sq > skv or (window is not None and window < 1):
        raise ValueError(
            f"flash_attention kernel: unsupported D={d}, H={h}, K={kh}, Sq={sq}, Skv={skv}, window={window}"
        )
    # the kernel reads dense [.., S, D] rows with 16-byte loads
    q_scaled, k, v = (t.contiguous() for t in (q_scaled, k, v))
    q_scaled, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q_scaled, k, v))
    out = torch.empty_like(q_scaled)
    err = _lib().flash_attention_fwd(
        q_scaled.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kh, sq, skv, d, int(causal), int(window or 0),
        build.stream_handle(q_scaled.device),
    )
    build.check(err, "flash_attention_fwd")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Attention over [B, H, S, D] (see module doc).  Each call on a CUDA
    tensor is one kernel launch, counted in ``flash_attention.launches``."""
    q_scaled = q * (q.shape[-1] ** -0.5)  # in q.dtype, as the JAX wrapper
    if q.device.type == "cpu":
        return flash_attention_plain(q_scaled, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = _launch(q_scaled, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
