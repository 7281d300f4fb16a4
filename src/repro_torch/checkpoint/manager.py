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
  in its dict.  A missing key or a shape mismatch raises.  A leaf's
  bytes are read from where its member lies in the file, straight into
  the leaf (through a pinned buffer for the card): one pass, and an
  expert slice reads only its own.
* **keep-K GC**: old steps deleted after a successful newer save.

**Layout-free under a world** (``CheckpointManager(..., world=,
sharded=)``): ``sharded`` names the parameters split over the model group
(the experts, ``Model.expert_names()``); a leaf whose last path part is
one of them (the parameter and its two moments) is gathered over data
group 0's model group into the global ``[E, ...]`` leaf, and global rank
0 writes the same ``step_<N>`` layout as one process (the other data
groups hold the same values).  ``wait()`` ends with a barrier over the
world, so every rank then reads the same ``latest_step``; a restore
reads the global leaf and copies in this rank's ``expert_range`` slice.
So a checkpoint written on one layout restores onto another, and onto
one process, as JAX's unsharded arrays do.  Every rank reads the same
directory (one host, or a shared file system).

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
import struct
import threading
import time
import zipfile

import numpy as np
import torch
import torch.distributed as dist

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


def _gather_leaf(leaf: torch.Tensor, world) -> np.ndarray | None:
    """The global ``[E, ...]`` leaf of an expert slice, gathered over data
    group 0's model group onto global rank 0 (None on its other ranks)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    t = t.to(world.stage_device).contiguous()
    if world.rank != 0:
        dist.gather(t, None, dst=0, group=world.model_group)
        return None
    out = t.new_empty((world.n_model * t.shape[0], *t.shape[1:]))
    dist.gather(t, list(out.chunk(world.n_model)), dst=0, group=world.model_group)  # straight into place
    return out.cpu().numpy()


def _flatten(tree, world=None, sharded=frozenset()) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """Host copies of every leaf by path, and each leaf's dtype name.
    Every device-to-host copy has completed when this returns.  Under a
    world (``sharded`` as ``CheckpointManager``'s) the ranks of data group
    0 gather the expert leaves and rank 0 alone returns the copies; the
    others return empty dicts."""
    flat, dtypes = {}, {}
    for path, parent, key in _walk(tree):
        leaf = parent[key]
        if world is not None and _is_sharded(path, leaf, world, sharded):
            if world.data_index != 0:
                continue
            arr = _gather_leaf(leaf, world)
            if arr is None:
                continue
            flat[path] = arr
        elif world is not None and world.rank != 0:
            continue
        else:
            flat[path] = _to_host(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        dtypes[path] = "bfloat16" if bf16 else str(flat[path].dtype)
    return flat, dtypes


def _is_sharded(path: str, leaf, world, sharded) -> bool:
    """A tensor leaf of an expert parameter split over the model group."""
    return world.n_model > 1 and isinstance(leaf, torch.Tensor) and path.rsplit(SEP, 1)[-1] in sharded


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


STAGE_BYTES = 1 << 26  # a restore's pinned staging buffer for a leaf on the card


def _members(npz: str) -> dict:
    """Where each ``.npy`` member of the ``.npz`` keeps its data: key ->
    (file offset, dtype, shape).  The members are stored uncompressed in
    C order, as ``_savez`` and the JAX package's ``np.savez`` write them."""
    out = {}
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{npz}: member {info.filename} is compressed; a checkpoint stores its arrays as they are")
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])  # the local file header
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else \
                np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            if fortran and len(shape) > 1:
                raise ValueError(f"{npz}: member {info.filename} is in Fortran order")
            out[info.filename.removesuffix(".npy")] = (f.tell(), dtype, shape)
    return out


def _read_exact(f, buf) -> None:
    if f.readinto(buf) != len(buf):
        raise ValueError(f"{f.name}: truncated")


def _read_into(f, offset: int, dst: torch.Tensor, stage: list) -> None:
    """The raw bytes at ``offset`` into the contiguous tensor ``dst``: read
    straight into host memory, or through one reused pinned buffer
    (``stage[0]``, made at first use) for a tensor on the card."""
    raw = dst.detach().view(-1).view(torch.uint8)
    f.seek(offset)
    if raw.device.type == "cpu":
        _read_exact(f, memoryview(raw.numpy()))
        return
    if stage[0] is None:
        stage[0] = torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
    buf = memoryview(stage[0].numpy())
    for a in range(0, raw.numel(), STAGE_BYTES):
        n = min(STAGE_BYTES, raw.numel() - a)
        _read_exact(f, buf[:n])
        raw[a:a + n].copy_(stage[0][:n])


def restore(path: str, template, *, world=None, sharded=frozenset()):
    """Restore into ``template`` in place, leaf by leaf, and return it.
    Tensor leaves keep their storage and dtype (a leaf of the stored dtype
    reads its bytes straight in: one pass over the file's, only this rank's
    slice of an expert leaf); a scalar leaf takes the stored value as the
    template's type.  Under a world an expert leaf (``sharded`` as
    ``CheckpointManager``'s) takes this rank's ``expert_range`` slice of the
    stored global leaf."""
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    npz = os.path.join(path, "arrays.npz")
    members, stage = _members(npz), [None]
    with open(npz, "rb") as f:
        for key, parent, k in _walk(template):
            if key not in members:
                raise KeyError(f"checkpoint missing array {key!r}")
            offset, dtype, shape = members[key]
            leaf = parent[k]
            if world is not None and _is_sharded(key, leaf, world, sharded):
                lo, hi = world.expert_range(shape[0])
                offset += lo * int(np.prod(shape[1:])) * dtype.itemsize
                shape = (hi - lo, *shape[1:])
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
            if tuple(shape) != tuple(want):
                raise ValueError(f"{key}: checkpoint shape {shape} != model {want}")
            stored = torch.bfloat16 if dtypes.get(key) == "bfloat16" else torch.from_numpy(np.empty(0, dtype)).dtype
            if isinstance(leaf, torch.Tensor) and leaf.dtype == stored and leaf.is_contiguous():
                _read_into(f, offset, leaf, stage)
                continue
            arr = np.empty(shape, dtype)
            f.seek(offset)
            _read_exact(f, memoryview(arr.reshape(-1)).cast("B"))
            if isinstance(leaf, torch.Tensor):
                src = torch.from_numpy(arr)
                if stored == torch.bfloat16:
                    src = src.view(torch.bfloat16)
                with torch.no_grad():
                    leaf.copy_(src)
            elif isinstance(leaf, np.ndarray):
                leaf[...] = arr
            else:
                parent[k] = type(leaf)(arr.item())
    return template


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, *, world=None, sharded=frozenset()):
        """``world`` (a ``parallel.sharding.World`` of several ranks) and
        ``sharded`` (the parameter names split over its model group) make
        the checkpoints layout-free (module doc); every rank of the world
        makes the same calls in the same order."""
        self.directory = directory
        self.keep = keep
        self.world = world if world is not None and world.size > 1 else None
        self.sharded = frozenset(sharded)
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
        directory holds no complete checkpoint.  Under a world the step is
        rank 0's latest, broadcast."""
        step = self.latest_step()
        if self.world is not None:
            t = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=self.world.stage_device)
            dist.broadcast(t, src=0)
            step = None if int(t) < 0 else int(t)
        if step is None:
            return None, None
        t0 = time.perf_counter()
        out = restore(os.path.join(self.directory, f"step_{step:08d}"), template, world=self.world,
                      sharded=self.sharded)
        self.restores.append({"step": step, "s": time.perf_counter() - t0})
        return step, out

    # --------------------------------------------------------------- saves
    def save(self, step: int, tree) -> None:
        self.save_async(step, tree)
        self.wait()

    def save_async(self, step: int, tree) -> None:
        """Snapshot now (a complete device-to-host copy; under a world the
        gathers too), write in the background (rank 0 alone under a world)."""
        self.wait()
        t0 = time.perf_counter()
        flat, dtypes = _flatten(tree, self.world, self.sharded)
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0, "write_s": None,
               "nbytes": sum(a.nbytes for a in flat.values())}
        self.saves.append(rec)
        if self.world is not None and self.world.rank != 0:
            return

        def work():
            t1 = time.perf_counter()
            _write(self.directory, step, flat, dtypes)
            self._gc()
            rec["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write; under a world, then a barrier, so the
        write is on disk for every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.world is not None:
            dist.barrier()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
