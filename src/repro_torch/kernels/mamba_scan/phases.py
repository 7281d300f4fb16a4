"""A timeline of K6b on the card: where one backward launch's time goes.

    python -m repro_torch.kernels.mamba_scan.phases [--source DIR] [--names a,b,...]

Builds K6b (``csrc/mamba_scan_bwd.cu``, or ``DIR/mamba_scan_bwd.cu``, a
source of the same C interface) as the port launches it and with
``-DK6B_PHASES`` (thread 0 of each block then adds up ``clock64`` cycles
per phase and logs its total cycles and ``globaltimer`` nanoseconds) into
``build/kernels``.  At the training shape of Jamba's layer 0 (x [4, 1024,
16384] bf16, dt and dy f32, ds 16, from zeros, K6's checkpoints at the
source's interval) it holds both builds against
``selective_scan_bwd_plain`` (each gradient within 1e-3 relative L2 and
1e-3 max|plain|), prints each of the plain build's kernels' device time
from a profile of 5 calls, and the stamped build's phases as shares of a
block's cycles (mean over blocks; ``--names`` names the source's phases,
by default those of the package's source).  Prints the card's name and
power limit first.  Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan import ops

B, S, DI, DS = 4, 1024, 16384, 16
TOL = 1e-3
# the package's stamps: the first chunk's copies, then each chunk's next copies with its recompute, its walk, its
# barrier, the block's dB/dC sums and the dx/ddt rows out
NAMES = ("first copies", "next copies and recompute", "walk", "chunk barrier", "block sums", "rows out")
GRADS = ("dx", "ddt", "db", "dc", "da", "dd_skip")


def training_inputs(dev, seed: int = 0):
    """Seeded inputs of the scan backward at Jamba layer 0's training shape: dt a softplus of a small
    projection, a = -(1 .. 16) per channel (Mamba's initial a_log), dy of the loss's scale."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, DI), generator=gen, device=dev).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((B, S, DI), generator=gen, device=dev) - 4.0)
    bm, cm = (torch.randn((B, S, DS), generator=gen, device=dev) for _ in range(2))
    a = -torch.arange(1, DS + 1, dtype=torch.float32, device=dev).repeat(DI, 1)
    d_skip = torch.ones(DI, device=dev)
    dy = torch.randn((B, S, DI), generator=gen, device=dev) * 1e-3
    return x, dt, bm, cm, a, d_skip, dy


def hold(got, want, what: str) -> None:
    for name, g, w in zip(GRADS, got, want):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        err, top = float((g - w).abs().max()), float(w.abs().max())
        if not torch.isfinite(g).all() or rel > TOL or err > TOL * top:
            sys.exit(f"{what} {name}: rel L2 {rel:.3g}, max |diff| {err:.3g} against max |plain| {top:.3g}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None, help="a directory holding another mamba_scan_bwd.cu")
    ap.add_argument("--names", default=",".join(NAMES), help="the source's phases, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("the K6b timeline needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    names = args.names.split(",")
    lib = ops.bind_bwd(build.load("mamba_scan_bwd", csrc=args.source))
    stamped = ops.bind_bwd(build.load("mamba_scan_bwd", defines=("K6B_PHASES",), csrc=args.source))
    stamped.k6b_phases.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    x, dt, bm, cm, a, d_skip, dy = training_inputs(dev)
    ck = lib.mamba_scan_bwd_ckpt_steps()
    if ck != ops.ckpt_steps():
        sys.exit(f"{args.source} reads checkpoints every {ck} steps; K6 writes them every {ops.ckpt_steps()}")
    _, _, hck = ops._launch(x, dt, bm, cm, a, d_skip, checkpoints=True)
    want = ops.selective_scan_bwd_plain(x, dt, bm, cm, a, d_skip, dy)
    call = lambda lib_: ops._launch_bwd(x, dt, bm, cm, a, d_skip, dy, None, None, hck, lib=lib_)  # noqa: E731
    hold(call(lib), want, "K6b")
    for _ in range(3):  # the last launch's stamps are read
        got = call(stamped)
    torch.cuda.synchronize()
    hold(got, want, "K6b (K6B_PHASES)")
    for _ in range(2):
        call(lib)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call(lib)
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        name = next((k for k in ("mamba_scan_bwd_kernel", "sum_parts_kernel") if k in e.key), None)
        if name is not None and e.device_time_total > 0:
            times[name] = times.get(name, 0.0) + e.device_time_total / 5 / 1e3
    print("K6b kernels, device ms a call (profile of 5 calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(times.items(), key=lambda kv: -kv[1])))
    log = np.zeros((1024, 8), dtype=np.uint64)
    build.check(stamped.k6b_phases(log.ctypes.data), "k6b_phases")
    log = log[np.nonzero(log[:, 6])[0]].astype(np.float64)
    total = log[:, 6].mean()
    mhz = float((log[:, 6] / log[:, 7]).mean() * 1e3)
    shares = ", ".join(f"{name} {100 * log[:, k].mean() / total:.1f}%" for k, name in enumerate(names))
    print(f"K6b timeline ({args.source or 'csrc'}; thread 0, mean over {len(log)} blocks, checkpoints every {ck} "
          f"steps; SM clock {mhz:.0f} MHz): {total / 1e3:.1f} k cycles, {log[:, 7].mean() / 1e3:.1f} us a block; "
          f"{shares}")


if __name__ == "__main__":
    main()
