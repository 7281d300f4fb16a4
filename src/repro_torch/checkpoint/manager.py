"""Checkpointing: atomic, async, keep-K, restore in place.

Layout (the JAX package's):  <dir>/step_<N:08d>/
            arrays.npz      flattened tree ('/'-joined paths)
            manifest.json   {step, keys, dtypes, when, complete: true}

A tree is a nested dict whose leaves are tensors, numpy arrays or Python
scalars: the train state is ``{"params": {name: tensor}, "opt": {...},
"ef": {...}}``.  Guarantees used by the fault-tolerant loop:

* **Atomicity**: written to ``.tmp-step_<N>`` then ``os.rename``d; restore
  only considers directories whose manifest says ``complete``.
* **Async**: ``save_async`` takes a complete device-to-host copy on the
  calling thread before it returns (the port's optimizer updates
  parameters and moments in place, so a lazy snapshot would race the
  next step) and writes on a background thread, releasing each array's
  host copy once it is in the file; ``wait()`` joins before the next
  save or shutdown.  As in the JAX package, the writer thread
  swallows nothing and reports nothing: a caller that must know lists
  ``steps()`` after ``wait()``.
* **Restore in place**: ``restore`` copies each array into the
  template's existing tensor (``copy_``), so parameters keep their
  storage and ``model.parameters()`` stays valid; a scalar leaf is set
  in its dict.  A missing key or a shape mismatch raises.
* **keep-K GC**: old steps deleted after a successful newer save.

``np.savez`` has no bfloat16: a bf16 leaf is stored as its raw 16-bit
words and the manifest's ``dtypes`` records ``bfloat16``.  The manager
keeps each asynchronous save's times (``saves``: step, ``snapshot_s``
blocking the caller, ``write_s`` in the background, ``nbytes``) and each
restore's (``restores``: step, ``s``).  Counterpart of
``repro/checkpoint/manager.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

__all__ = ["CheckpointManager", "restore", "save"]

SEP = "/"


def _walk(tree, prefix=""):
    """(path, container, key) for every leaf of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, tree, k


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (bf16 as its raw 16-bit words)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of every leaf by path, and each leaf's dtype name.
    Every device-to-host copy has completed when this returns."""
    flat, dtypes = {}, {}
    for path, parent, key in _walk(tree):
        leaf = parent[key]
        flat[path] = _to_host(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtypes[path] = "bfloat16" if bf16 else str(flat[path].dtype)
    return flat, dtypes


def _savez(path: str, flat: dict) -> None:
    """``np.savez(path, **flat)``, the same file, written one array at a
    time and each dropped from ``flat`` once written, so a snapshot's host
    memory shrinks as the file grows."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key in list(flat):
            arr = flat.pop(key)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, arr, allow_pickle=False)
            del arr


def _write(directory: str, step: int, flat: dict, dtypes: dict) -> str:
    """Write ``flat`` (consumed) as checkpoint ``step``: tmp dir, rename."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "keys": sorted(flat), "dtypes": dtypes, "when": time.time(), "complete": True}
    _savez(os.path.join(tmp, "arrays.npz"), flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree) -> str:
    """Atomic synchronous save.  Returns the final path."""
    return _write(directory, step, *_flatten(tree))


def restore(path: str, template):
    """Restore into ``template`` in place, leaf by leaf (one array on the
    host at a time), and return it.  Tensor leaves keep their storage and
    dtype; a scalar leaf takes the stored value as the template's type."""
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        files = set(z.files)
        for key, parent, k in _walk(template):
            if key not in files:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = z[key]
            leaf = parent[k]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != model {shape}")
            if isinstance(leaf, torch.Tensor):
                src = torch.from_numpy(arr)
                if dtypes.get(key) == "bfloat16":
                    src = src.view(torch.bfloat16)
                with torch.no_grad():
                    leaf.copy_(src)
            elif isinstance(leaf, np.ndarray):
                leaf[...] = arr
            else:
                parent[k] = type(leaf)(arr.item())
    return template


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- queries
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_"):
                continue
            mpath = os.path.join(self.directory, name, "manifest.json")
            try:
                with open(mpath) as f:
                    if json.load(f).get("complete"):
                        out.append(int(name.split("_")[1]))
            except (OSError, ValueError, json.JSONDecodeError):
                continue  # partial/corrupt: ignore
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self, template):
        """(step, template restored in place), or (None, None) when the
        directory holds no complete checkpoint."""
        step = self.latest_step()
        if step is None:
            return None, None
        t0 = time.perf_counter()
        out = restore(os.path.join(self.directory, f"step_{step:08d}"), template)
        self.restores.append({"step": step, "s": time.perf_counter() - t0})
        return step, out

    # --------------------------------------------------------------- saves
    def save(self, step: int, tree) -> None:
        self.wait()
        save(self.directory, step, tree)
        self._gc()

    def save_async(self, step: int, tree) -> None:
        """Snapshot now (a complete device-to-host copy), write in the background."""
        self.wait()
        t0 = time.perf_counter()
        flat, dtypes = _flatten(tree)
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0, "write_s": None,
               "nbytes": sum(a.nbytes for a in flat.values())}
        self.saves.append(rec)

        def work():
            t1 = time.perf_counter()
            _write(self.directory, step, flat, dtypes)
            self._gc()
            rec["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
