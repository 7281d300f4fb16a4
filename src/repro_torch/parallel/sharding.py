"""The expert-parallel world: a ``torch.distributed`` process group split
into data x model groups.

The default layout is JAX's serving mesh (``repro/launch/serve.py``):
``n`` ranks form ``(max(n // 4, 1), min(n, 4))`` on the axes ("data",
"model"), rank ``r`` at ``(r // n_model, r % n_model)``.  A caller passes
another ``layout=(n_data, n_model)``: the training launcher takes
``train_mesh_shape(n)``, JAX's training mesh, and ``regroup`` lays the
same ranks out anew (an elastic restart inside one job).  The model group is the EP
group.  Experts are placed contiguously: expert ``e`` lives on model rank
``e // e_local``, so a bucket id ``dst_rank * e_local + local_expert`` is
the expert id.  Under 2D expert sharding (``MoECfg.expert_2d`` with more
than one data group) a rank also holds just its data group's slice of
each expert's FFN width, ``ffn_range``.  Every rank of a model group
holds the full non-expert weights and computes the same activations; the MoE layer
(``models/moe.py``) cuts its tokens into per-rank chunks, moves them
through a fabric and all-gathers the outputs over the model group.

The backend follows the layout, never a caught failure: CPU tensors, or
several ranks sharing one card, run ``gloo`` (NCCL refuses two ranks on
one device; gloo's CUDA path copies through host memory itself); one
card a rank runs ``nccl``.

``ep_world(world)`` makes a world current for the model code, as JAX's
``axis_rules`` makes a mesh current; ``current_world()`` reads it (None:
one device, the virtual fabric).  ``spawn_world`` starts ``n`` ranks in
child processes with a rendezvous file and a timeout on the world and on
the join, so a dead rank fails the run instead of hanging it.

Counterpart of ``AxisRules``, ``axis_rules`` and ``current_rules`` in
``repro/parallel/sharding.py``, as far as expert parallelism needs them.
``logical_to_spec``, ``shard`` and ``shard_map_compat`` have no
counterpart: no partitioner places the port's tensors; each rank holds
its expert slice and the replicated rest explicitly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import tempfile
import threading
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

__all__ = [
    "World",
    "mesh_shape",
    "train_mesh_shape",
    "world_backend",
    "init_world",
    "close_world",
    "ep_world",
    "current_world",
    "spawn_world",
    "regroup",
]

DEFAULT_TIMEOUT_S = 60.0


def mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) group sizes of ``n`` ranks, as JAX's serving mesh."""
    shape = (max(n // 4, 1), min(n, 4))
    if shape[0] * shape[1] != n:
        raise ValueError(f"{n} ranks do not form a (data, model) mesh of {shape}")
    return shape


def train_mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) group sizes of ``n`` ranks, as JAX's training mesh
    (``repro/launch/train.py`` ``build_mesh``): the model group is the
    largest of 16, 8, 4, 2, 1 that divides ``n``."""
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0)
    return n // model, model


def _check_layout(layout, size: int) -> tuple[int, int]:
    n_data, n_model = (int(v) for v in layout)
    if n_data < 1 or n_model < 1 or n_data * n_model != size:
        raise ValueError(f"layout {tuple(layout)} does not lay out {size} ranks as (data, model)")
    return n_data, n_model


def world_backend(device: torch.device, n: int, n_cards: int) -> str:
    """``gloo`` for CPU tensors or ranks sharing a card, ``nccl`` for a card a rank."""
    if device.type == "cpu" or n > n_cards:
        return "gloo"
    return "nccl"


@dataclasses.dataclass(frozen=True)
class World:
    """This rank's place in the world: global rank and size, the (data,
    model) layout, its groups and its device."""

    rank: int
    size: int
    n_data: int
    n_model: int
    backend: str
    device: torch.device
    model_group: Any  # ProcessGroup of this rank's model (EP) group
    data_group: Any  # ProcessGroup of this rank's data group

    @property
    def n(self) -> int:
        """EP ranks: the model group's size."""
        return self.n_model

    @property
    def me(self) -> int:
        """This rank's index in its model group."""
        return self.rank % self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def stage_device(self) -> torch.device:
        """Where bulk host-side collectives (checkpoint gathers, small
        flags) run: the host under gloo, which stages CUDA tensors through
        host memory anyway; the card under NCCL."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def expert_range(self, n_experts: int) -> tuple[int, int]:
        """[lo, hi) of the experts this rank holds."""
        if n_experts % self.n_model:
            raise ValueError(f"{n_experts} experts do not split over {self.n_model} EP ranks")
        e_local = n_experts // self.n_model
        return self.me * e_local, (self.me + 1) * e_local

    def ffn_range(self, d_ff: int) -> tuple[int, int]:
        """[lo, hi) of the expert FFN width this rank holds under 2D expert
        sharding: its data group's slice."""
        if d_ff % self.n_data:
            raise ValueError(f"an expert FFN width of {d_ff} does not split over {self.n_data} data groups")
        f_local = d_ff // self.n_data
        return self.data_index * f_local, (self.data_index + 1) * f_local

    def two_d(self, cfg) -> bool:
        """2D expert sharding is on: the config asks for it and the world has
        more than one data group (JAX needs a "data" axis in its mesh)."""
        return bool(cfg.moe is not None and cfg.moe.expert_2d and self.n_data > 1)

    def model_shards(self, cfg) -> dict:
        """``Model``'s keyword arguments for this rank's slice of the experts
        (and, under 2D, of their FFN width)."""
        return {"expert_shard": (self.me, self.n_model),
                "ffn_shard": (self.data_index, self.n_data) if self.two_d(cfg) else None}


def init_world(
    device=None, *, rank: int | None = None, size: int | None = None, init_method: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S, layout: tuple[int, int] | None = None,
) -> World:
    """Join the process group and build the data and model groups.

    ``rank``/``size`` default to ``RANK``/``WORLD_SIZE`` (torchrun) and
    ``init_method`` to ``env://``.  ``device`` "cpu" keeps every tensor on
    the host; otherwise each rank takes card ``LOCAL_RANK % device_count``.
    ``layout`` (n_data, n_model) defaults to ``mesh_shape(size)``.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    size = int(os.environ["WORLD_SIZE"]) if size is None else size
    n_data, n_model = _check_layout(mesh_shape(size) if layout is None else layout, size)
    dev = torch.device("cuda" if device is None else device)
    n_cards = 0
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the world on the host")
        n_cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    backend = world_backend(dev, size, n_cards)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return _grouped(rank, size, (n_data, n_model), backend, dev)


def _grouped(rank: int, size: int, layout: tuple[int, int], backend: str, dev: torch.device) -> World:
    """The World of ``layout`` over the joined process group: every rank
    creates every group, in the same order."""
    n_data, n_model = layout
    model_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + j for j in range(n_model)])
        if rank // n_model == d:
            model_group = g
    for j in range(n_model):
        g = dist.new_group([d * n_model + j for d in range(n_data)])
        if rank % n_model == j:
            data_group = g
    return World(rank=rank, size=size, n_data=n_data, n_model=n_model, backend=backend, device=dev,
                 model_group=model_group, data_group=data_group)


def regroup(world: World, layout: tuple[int, int]) -> World:
    """The same ranks laid out as ``layout`` (n_data, n_model): new data and
    model groups over the joined process group.  Every rank calls it."""
    return _grouped(world.rank, world.size, _check_layout(layout, world.size), world.backend, world.device)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class _State(threading.local):
    def __init__(self):
        self.stack: list[World] = []


_STATE = _State()


@contextlib.contextmanager
def ep_world(world: World | None):
    """Make ``world`` current for the model code in this context."""
    _STATE.stack.append(world)
    try:
        yield world
    finally:
        _STATE.stack.pop()


def current_world() -> World | None:
    return _STATE.stack[-1] if _STATE.stack else None


# ------------------------------------------------------------------ spawning
def _child(rank: int, size: int, rdv: str, out_dir: str, device: str, timeout_s: float, layout, fn, args) -> None:
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    if device == "cpu":
        torch.set_num_threads(1)  # one thread a rank, as torchrun sets OMP_NUM_THREADS
    try:
        world = init_world(device, rank=rank, size=size, init_method=f"file://{rdv}", timeout_s=timeout_s,
                           layout=layout)
        try:
            result = ("ok", fn(world, *args))
        finally:
            close_world()
    except BaseException:  # the parent reports the child's traceback
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def spawn_world(fn, size: int, *, device: str = "cpu", args: tuple = (), timeout_s: float = 120.0,
                init_timeout_s: float = DEFAULT_TIMEOUT_S, layout: tuple[int, int] | None = None) -> list:
    """Run ``fn(world, *args)`` on ``size`` ranks in spawned processes and
    return each rank's result, in rank order.  ``layout`` (n_data,
    n_model) defaults to ``mesh_shape(size)``.

    The ranks meet through a rendezvous file in a temporary directory
    (no port).  ``init_timeout_s`` bounds every collective, ``timeout_s``
    the whole run: past it the ranks are killed and this raises, as it
    does when a rank raises or dies.  ``fn`` must be importable by the
    children (a module-level function).  A CPU rank runs one thread."""
    import torch.multiprocessing as mp

    if layout is not None:
        _check_layout(layout, size)  # in the parent: a bad layout fails before any rank starts
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        procs = [
            ctx.Process(target=_child, args=(r, size, rdv, tmp, device, init_timeout_s, layout, fn, args),
                        daemon=True)
            for r in range(size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"the world of {size} ranks did not finish within {timeout_s:.0f} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r} exited with code {p.exitcode} and left no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} failed:\n{value}")
            results.append(value)
        if errors:  # every failed rank: the first to fail is often not the first in rank order
            raise RuntimeError("\n".join(errors))
        return results
