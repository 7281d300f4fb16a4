"""Training across the ranks of a world: each data group trains on its
rows of the global batch, each model group splits the experts, and the
gradients are reduced so that every rank steps with the one-device
gradient of the global batch.

The convention is ``models/moe.py``'s: under a world the router's and the
input's gradients are partial on each model rank and an expert's
gradient is whole on the rank that holds it.  So each model rank
backprops ``loss_share(world)`` of its data group's loss (the shares of a
model group sum to 1), and then

* a replicated (non-expert) gradient is summed over the model group and
  averaged over the data group: one all-reduce over the world, then
  ``/ n_data``;
* an expert's gradient is averaged over the data group.

Under 2D expert sharding (``World.two_d``: ``MoECfg.expert_2d`` with more
than one data group) a rank holds a slice of each of its experts' FFN
width, and the layer gathers every data group's tokens around the GEMM
on it (``models/moe.py``).  The reduce-scatter's backward gathers their
cotangents too, so an expert slice's gradient is already summed over the
data groups: it is only divided by ``n_data``, with no collective.  The
replicated gradients are reduced as above.

Each data group's loss is a mean over the same number of positions (a
``SyntheticStream`` row has ``seq - 1`` targets), so the mean of the
groups' means is the global batch's mean, as JAX's ``P("data", ...)``
batch sharding computes it (``repro/launch/train.py``).

Every collective here runs in the same order on every rank: leaves in
name order, each rank's model built alike.  Counterpart of the gradient
reductions that JAX's partitioner inserts under ``train_rules`` (the
replicated weights and moments stay whole on each rank here; JAX shards
them over the data axis, ZeRO-3: ``ROADMAP.md`` §1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "NEXT_SLICE",
    "refuse",
    "loss_share",
    "batch_rows",
    "reduce_gradients",
    "world_loss",
    "agree",
]

NEXT_SLICE = "ROADMAP.md §1 item 1 (training across ranks, the next slice)"
# elements a gradient all-reduce moves at once: gloo stages a CUDA tensor through host memory, so a
# full-width leaf (a 14336 x 4096 expert block) goes in 256 MB parts
CHUNK = 1 << 26


def refuse(what: str) -> NotImplementedError:
    """The error for a training feature that does not run under a world yet."""
    return NotImplementedError(f"{what} does not run under a world of several ranks yet: {NEXT_SLICE}")


def loss_share(world) -> float:
    """This model rank's share of its data group's loss: equal shares
    summing to 1 over the model group (exact for a power-of-two group)."""
    return 1.0 / world.n_model


def batch_rows(global_batch: int, world) -> slice:
    """The rows of the global batch this rank's data group trains on,
    ``[d * B / n_data, (d + 1) * B / n_data)``; every model rank of the
    group sees the same rows."""
    if global_batch % world.n_data:
        raise ValueError(f"a global batch of {global_batch} rows does not split over {world.n_data} data groups")
    rows = global_batch // world.n_data
    return slice(world.data_index * rows, (world.data_index + 1) * rows)


@torch.no_grad()
def reduce_gradients(grads: dict, world, sharded, *, two_d: bool = False) -> None:
    """In place: every gradient of ``grads`` becomes the one-device
    gradient of the global batch (see the module doc).  ``sharded`` names
    the expert leaves, split over the model group (and, with ``two_d``,
    along their FFN width over the data groups)."""
    for name in sorted(grads):
        g = grads[name]
        if name in sharded and (world.n_data == 1 or two_d):
            if world.n_data > 1:
                g.div_(world.n_data)
            continue
        for part in g.view(-1).split(CHUNK):
            dist.all_reduce(part, group=world.data_group if name in sharded else None)
        if world.n_data > 1:
            g.div_(world.n_data)


@torch.no_grad()
def world_loss(loss: torch.Tensor, world) -> torch.Tensor:
    """The global batch's loss: the data groups' losses averaged (every
    model rank of a group computes the same one)."""
    if world.n_data == 1:
        return loss
    total = loss.detach().clone()
    dist.all_reduce(total, group=world.data_group)
    return total / world.n_data


def agree(flag: bool, world) -> bool:
    """True on every rank when ``flag`` is true on any: one MAX
    all-reduce over the world."""
    t = torch.tensor([float(flag)], device=world.stage_device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
