"""A timeline of K4 on the card: where one launch's time goes, phase by phase.

    python -m repro_torch.kernels.flash_attention.phases

Builds ``csrc/flash_attention.cu`` with ``-DK4_PHASES`` (the first thread of
each warpgroup then stamps ``clock64`` at each phase) into
``build/kernels``, launches it at the Mixtral prefill shape (B=4, 32/8 heads
of 128, S=256, causal, the model's [B, S, H, D] views), and prints, per
block column (blockIdx.x: a pair of q tiles), the mean cycles from a
warpgroup's start to: its Q tile stored; each KV step's tile ready, S done,
softmax done and PV done; each pass's output stored.  The SM clock (cycles
over ``globaltimer`` nanoseconds) converts them to microseconds.  Needs the
card and nvcc; the kernel the port launches is built without the stamps.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from repro_torch.kernels import build

B, H, KH, S, D = 4, 32, 8, 256, 128
HPB = 2  # query heads per block at an even group (csrc/flash_attention.cu)
SLOTS, BLOCKS, WARPGROUPS = 32, 1024, 2  # csrc/flash_attention.cu, K4_PHASES


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention", defines=("K4_PHASES",))
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.k4_phases.argtypes = [ctypes.c_void_p]
    lib.k4_phases.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("the K4 timeline needs a CUDA card")
    lib = _library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (torch.randn((B, S, H, D), generator=gen, device=dev) * D**-0.5).to(torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, S, KH, D), generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream
    n_qt = S // 64
    print(f"K4 timeline: q[{B},{H},{S},{D}] kv[{B},{KH},{S},{D}] causal, two query heads and two q tiles a block; "
          f"cycles from each warpgroup's start (mean over its blocks' rows and warpgroups)")
    for _ in range(3):  # the last launch's stamps are read
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                                      B, H, KH, S, S, D, 1, -1, D**0.5, D**-0.5, stream)
        build.check(err, "flash_attention_fwd (K4_PHASES)")
    torch.cuda.synchronize()
    stamps = np.zeros(BLOCKS * WARPGROUPS * SLOTS, dtype=np.uint64)
    build.check(lib.k4_phases(stamps.ctypes.data), "k4_phases")
    nx = (n_qt + 1) // 2
    st = stamps[: nx * (H // HPB) * B * WARPGROUPS * SLOTS].reshape(B, H // HPB, nx, WARPGROUPS, SLOTS).astype(np.int64)
    ns = st[..., 31] - st[..., 30]
    last = np.where(st[..., 29] > 0, st[..., 29], st[..., 28])
    mhz = float(((last - st[..., 0]) / np.maximum(ns, 1)).mean() * 1e3)
    print(f"SM clock {mhz:.0f} MHz; a warpgroup's span {ns.mean() / 1e3:.2f} us (mean), {ns.max() / 1e3:.2f} us (longest)")
    for x in range(nx):
        col = st[:, :, x]
        rel = col - col[..., :1]
        steps = n_qt - x + (x + 1 if x < n_qt - 1 - x else 0)  # KV steps: causal, Sq = Skv
        parts = [f"Q stored {rel[..., 1].mean():.0f}"]
        for g in range(min(steps, 6)):
            parts.append("step {}: ready {:.0f} S {:.0f} softmax {:.0f} PV {:.0f}".format(
                g, *(rel[..., 2 + 4 * g + i].mean() for i in range(4))))
        parts.append("stored " + " / ".join(f"{rel[..., 28 + p].mean():.0f}" for p in range(2) if col[..., 28 + p].any()))
        print(f"  block column {x}: " + " | ".join(parts))


if __name__ == "__main__":
    main()
