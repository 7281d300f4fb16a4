"""Build the CUDA kernels with ``nvcc`` and bind them through ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared
library under ``<checkout>/build/kernels/`` with a plain C interface
(``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), named by a
hash of the source, every ``csrc/*.cuh`` header and the flags (with any
``-D`` defines a caller asks for), so an edited source or header rebuilds.
``build_all`` starts one ``nvcc`` per source at once and waits for all;
``csrc`` builds a source of the same name from another directory (a
profile timing an earlier design beside the current one).
Nothing here runs at import; a failed build raises with the compiler's
output, and there is no path back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "check", "stream_handle", "ptxas_report", "ptxas_kernels"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <checkout>/build/kernels for a source checkout (src/repro_torch/kernels/build.py)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("moe_gemm", "moe_gemm_bwd", "flash_attention", "rwkv_wkv", "rwkv_wkv_bwd", "mamba_scan", "mamba_scan_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[tuple[str, ...], ctypes.CDLL] = {}
_PTXAS: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _flags(defines=()) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def _lib_path(name: str, defines=(), csrc=None) -> Path:
    h = hashlib.sha256((Path(csrc or CSRC) / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, defines=(), csrc=None) -> dict[str, Path]:
    """Compile every missing library in parallel, each with ``-D`` for
    each of ``defines``, from ``csrc`` (default: the package's
    ``csrc/``); returns name -> path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src_dir = Path(csrc or CSRC)
    paths = {name: _lib_path(name, defines, src_dir) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(defines), "-o", tmp, str(src_dir / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        _PTXAS[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            os.unlink(tmp)
        else:
            os.replace(tmp, todo[name])  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(name: str) -> str:
    """The compiler's ``-Xptxas -v`` output from this process's build of
    ``name`` (registers, shared memory, spills); empty if it was cached."""
    return _PTXAS.get(name, "")


def _kernel_name(mangled: str) -> str:
    """``k4_flash_fwd_kernel<128, 4>`` from ``_ZN12_GLOBAL__N_119k4_flash_fwd_kernelILi128ELi4EEEv...``:
    the last of the nested names, with its integer template arguments."""
    i = mangled.find("N") + 1 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        digits = re.match(r"\d+", mangled[i:]).group()
        i += len(digits)
        name, i = mangled[i:i + int(digits)], i + int(digits)
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    return f"{name}<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>" if args else name


def ptxas_kernels(name: str) -> list[dict]:
    """Per kernel of ``csrc/<name>.cu`` in this process's build: registers,
    stack frame, spill stores and loads and static shared memory (bytes),
    from ``ptxas_report``; empty if the library was cached."""
    kernels: dict[str, dict] = {}
    current = None
    for line in ptxas_report(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w.$]+)'?", line)
        if m:
            current = kernels.setdefault(m.group(1), {"kernel": _kernel_name(m.group(1))})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(sm.group(1)) if sm else 0
    return [k for k in kernels.values() if "registers" in k]


def load(name: str, defines=(), csrc=None) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed);
    ``defines`` builds a variant with ``-D`` for each, as a profile of a
    kernel asks for, and ``csrc`` the source of that name in another
    directory."""
    key = (name, str(csrc or ""), *defines)
    lib = _LIBS.get(key)
    if lib is None:
        path = build_all((name,), defines, csrc)[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[key] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    """The current PyTorch stream on ``device`` (a CUDA device with an
    index), as the integer a ``c_void_p`` argument takes: PyTorch's raw
    stream query, without building a ``torch.cuda.Stream`` each call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
