"""A timeline of K5 on the card: where one prefill launch's time goes.

    python -m repro_torch.kernels.rwkv_wkv.phases

Builds ``csrc/rwkv_wkv.cu`` with ``-DK5_PHASES`` (thread 0 of each block
then adds up ``clock64`` cycles per phase) into ``build/kernels``,
launches it at the RWKV6-7B prefill shape (r/k/v [4, 64, 1024, 64] bf16, S
from 0), holds it against ``wkv6_plain`` (1e-4 + 1e-4·|plain|), and
prints, per pass of 32 steps and as a mean over the blocks, the cycles
thread 0 spends waiting at the pass's barrier, in the steps with the next
pass's widening folded in, and in the steps of the last pass; the SM
clock (cycles over ``globaltimer`` nanoseconds) converts them.  Prints the
card's name and power limit first.  Needs the card and nvcc; the kernel
the port launches is built without the stamps.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv_wkv.ops import HEAD_DIM, wkv6_plain

B, H, T = 4, 64, 1024
BT, BLOCKS, SLOTS = 32, 1024, 8  # csrc/rwkv_wkv.cu, K5_PHASES
WKV_TOL = 1e-4
PHASES = ("wait at the pass barrier", "steps with the next pass's widening", "steps of the last pass")


def _library() -> ctypes.CDLL:
    lib = build.load("rwkv_wkv", defines=("K5_PHASES",))
    lib.wkv6_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.wkv6_fwd.restype = ctypes.c_int
    lib.k5_phases.argtypes = [ctypes.c_void_p]
    lib.k5_phases.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("the K5 timeline needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    lib = _library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (B, H, T, HEAD_DIM)
    r, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(shape, generator=gen, device=dev)))
    u = torch.randn((H, HEAD_DIM), generator=gen, device=dev) * 0.1
    y = torch.empty((B, T, H, HEAD_DIM), dtype=torch.float32, device=dev)
    s = torch.empty((B, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):  # the last launch's stamps are read
        err = lib.wkv6_fwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), None,
                           y.data_ptr(), s.data_ptr(), B, H, T, HEAD_DIM, *r.stride()[:3], 1, stream)
        build.check(err, "wkv6_fwd (K5_PHASES)")
    torch.cuda.synchronize()
    y_ref, s_ref = wkv6_plain(r, k, v, w, u)
    for got, ref in ((y.transpose(1, 2), y_ref), (s, s_ref)):
        diff = (got - ref).abs()
        if not torch.isfinite(got).all() or float((diff - WKV_TOL * ref.abs()).max()) > WKV_TOL:
            sys.exit(f"K5 (K5_PHASES): max |kernel - plain| {float(diff.max()):.4g} beyond tolerance")
    log = np.zeros((BLOCKS, SLOTS), dtype=np.uint64)
    build.check(lib.k5_phases(log.ctypes.data), "k5_phases")
    log = log[: B * H].astype(np.float64)
    passes = -(-T // BT)
    mhz = float((log[:, 3] / log[:, 4]).mean() * 1e3)
    print(f"K5 prefill timeline (thread 0, mean over {B * H} blocks; SM clock {mhz:.0f} MHz): "
          f"{log[:, 4].mean() / 1e3:.1f} us a block after the first pass's widening; per pass of {BT} steps: "
          + ", ".join(f"{name} {log[:, i].mean() / passes:.0f} cycles" for i, name in enumerate(PHASES))
          + f"; {(log[:, 1] + log[:, 2]).mean() / T:.0f} cycles a step")


if __name__ == "__main__":
    main()
