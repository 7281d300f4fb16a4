"""EP collectives on ``torch.distributed``: the monolithic all-to-all, the
scheduled (decomposition -> phase sequence) dispatch and combine, one
ragged transfer a phase, and the model group's all-gather and all-reduce.

Every movement is one ``all_to_all_single`` (gloo's CUDA path covers it,
and not ``send``/``recv``): a ppermute phase is an all-to-all with one
non-zero send split and one non-zero receive split a rank.  A rank that
receives nothing in a phase gets zeros, as JAX's ``ppermute`` gives it.
Each call is differentiable through a ``torch.autograd.Function`` whose
backward is the reverse movement: an all-to-all with the split sizes
swapped (a ppermute phase's inverse permutation).  The all-gather's
backward is this rank's slice of the gradient summed over the group, an
all-reduce and a slice (gloo has no reduce-scatter in every version); the
all-reduce's backward is an all-reduce.  Both sum in f32, whatever the
cotangent's dtype.  The reduce-scatter (2D expert sharding's return leg
over the data group) is the all-gather's pair: an f32 all-reduce and this
rank's slice forward, an all-gather backward.

Gradients follow one convention: the cotangent a rank holds for a
replicated tensor is its part of the whole, which is the sum over the
model group.  So a replicated weight's gradient (the router's) and the
input's are partial on each rank and sum to the one-device gradient;
an expert's lives on one rank, whole.

The backward's collectives run on every rank in the same order only if
every rank builds the same graph: a result a rank does not use still
enters the graph (``torch.where``, as JAX's ``jnp.where``), never a Python
branch on the rank.  No collective here is staged through host memory by
this module: gloo copies CUDA tensors to the host inside its own work.

Slot accounting: transfers called with ``count=True`` (a fabric's
dispatch leg) add the token rows they send to other ranks to
``SLOTS_SENT[0]``, the figure ``Fabric.dispatch_tokens`` models.

Counterpart of ``repro/parallel/collectives.py`` (there inside a
``shard_map``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "SLOTS_SENT",
    "all_to_all",
    "ppermute",
    "a2a_dispatch",
    "a2a_combine",
    "scheduled_dispatch",
    "scheduled_combine",
    "all_gather",
    "all_reduce_sum",
    "reduce_scatter",
    "all_gather_stats",
]

SLOTS_SENT = [0]  # token rows sent to other ranks by counted (dispatch) transfers, since the last reset


def _a2a(x: torch.Tensor, group, out_splits, in_splits) -> torch.Tensor:
    x = x.contiguous()
    rows = x.shape[0] if out_splits is None else sum(out_splits)
    out = x.new_empty((rows, *x.shape[1:]))
    dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, out_splits, in_splits):
        ctx.group, ctx.out_splits, ctx.in_splits = group, out_splits, in_splits
        return _a2a(x, group, out_splits, in_splits)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.in_splits, ctx.out_splits), None, None, None


def _count(x: torch.Tensor, in_splits, me: int, n: int) -> None:
    """Token rows (the last dim is the model width) ``x`` sends to other ranks."""
    per_row = x[0].numel() // x.shape[-1] if x.shape[0] else 0
    if in_splits is None:
        SLOTS_SENT[0] += (x.shape[0] - x.shape[0] // n) * per_row
    else:
        SLOTS_SENT[0] += (sum(in_splits) - in_splits[me]) * per_row


def all_to_all(x: torch.Tensor, group, *, out_splits=None, in_splits=None, count: bool = False) -> torch.Tensor:
    """Rows of ``x`` (dim 0) to the group's ranks by ``in_splits`` (even
    without), received by ``out_splits``.  Differentiable."""
    if count:
        _count(x, in_splits, dist.get_rank(group), dist.get_world_size(group))
    return _AllToAll.apply(x, group, out_splits, in_splits)


def ppermute(x: torch.Tensor, group, *, dst: int | None, src: int | None, count: bool = False) -> torch.Tensor:
    """One circuit phase: this rank's ``x`` to ``dst`` (None: sends
    nothing), and the block ``src`` sends here (None: zeros shaped like
    ``x``).  Every rank of the group must call it.  Differentiable."""
    n = dist.get_world_size(group)
    rows = x.shape[0]
    in_splits, out_splits = [0] * n, [0] * n
    if dst is not None:
        in_splits[dst] = rows
    if src is not None:
        out_splits[src] = rows
    send = x if dst is not None else x[:0]
    got = all_to_all(send, group, out_splits=out_splits, in_splits=in_splits, count=count)
    if src is None:  # zeros, still in the graph so the backward's collective runs here too
        got = torch.cat([got, x.new_zeros((rows, *x.shape[1:]))])
    return got


def a2a_dispatch(buckets: torch.Tensor, group, *, count: bool = False) -> torch.Tensor:
    """The baseline: one dense all-to-all.  [n(dst), ...] -> [n(src), ...]."""
    return all_to_all(buckets, group, count=count)


def a2a_combine(processed: torch.Tensor, group) -> torch.Tensor:
    """The reverse all-to-all: [n(src), ...] -> [n(dst), ...]."""
    return all_to_all(processed, group)


def _sender(perm: np.ndarray, valid: np.ndarray, me: int) -> int | None:
    """The rank whose (valid) phase pair targets ``me``, if any."""
    hit = np.nonzero((np.asarray(perm) == me) & np.asarray(valid, bool))[0]
    return int(hit[0]) if hit.size else None


def _slice_start(schedule, k: int, me: int, cap: int, c_max: int) -> int:
    """Phase k's slice offset of a multi-phase pair, clamped so the slice
    fits (JAX's ``dynamic_slice``)."""
    if schedule.offsets is None:
        return 0
    return int(min(max(int(schedule.offsets[k][me]), 0), c_max - cap))


def scheduled_dispatch(buckets: torch.Tensor, schedule, group, me: int, *, count: bool = False) -> list:
    """Execute a static plan's dispatch phases.

    buckets [n, E_local, C_max, d] by destination rank.  Returns the
    received blocks: element 0 is the local block [E_local, C_max, d];
    element k >= 1 is phase k's block [E_local, C_k, d] (zeros on a rank
    the phase does not serve)."""
    received = [buckets[me]]  # local tokens never cross the fabric
    c_max = buckets.shape[2]
    for k in range(schedule.num_phases):
        perm, valid = np.asarray(schedule.perms[k]), np.asarray(schedule.valid[k], bool)
        cap = int(schedule.caps[k])
        dst = int(perm[me])
        off = _slice_start(schedule, k, me, cap, c_max)
        send = buckets[dst][:, off:off + cap]
        received.append(
            ppermute(send, group, dst=dst if valid[me] else None, src=_sender(perm, valid, me), count=count)
        )
    return received


def scheduled_combine(processed: list, schedule, group, me: int, c_max: int) -> torch.Tensor:
    """Return each phase's processed block to its sender.

    processed: as ``scheduled_dispatch`` returned it (local first), after
    expert compute.  Returns [n, E_local, C_max, d] aligned with the send
    buckets (zeros where a phase's capacity < C_max or a pair was idle)."""
    n = schedule.n
    e_local, _, d = processed[0].shape
    dev = processed[0].device
    out = [processed[0].new_zeros((e_local, c_max, d)) for _ in range(n)]
    out[me] = _pad_cap(processed[0], c_max)
    for k in range(schedule.num_phases):
        perm, valid = np.asarray(schedule.perms[k]), np.asarray(schedule.valid[k], bool)
        sender = _sender(perm, valid, me)
        dst = int(perm[me])
        # the reverse circuit: my processed block back to whoever targeted me;
        # I receive my own tokens from the rank I dispatched to
        got = ppermute(processed[k + 1], group, dst=sender, src=dst if valid[me] else None)
        mine = torch.tensor(bool(valid[me]), device=dev)
        cur = out[dst]
        if schedule.offsets is not None:
            cap = got.shape[1]
            off = _slice_start(schedule, k, me, cap, c_max)
            blk = torch.where(mine, got, cur[:, off:off + cap])
            cur = torch.cat([cur[:, :off], blk, cur[:, off + cap:]], dim=1)
        else:
            cur = torch.where(mine, _pad_cap(got, c_max), cur)
        out[dst] = cur
    return torch.stack(out)


def _pad_cap(block: torch.Tensor, c_max: int) -> torch.Tensor:
    pad = c_max - block.shape[1]
    if pad == 0:
        return block
    return torch.cat([block, block.new_zeros((block.shape[0], pad, block.shape[2]))], dim=1)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        # the reduce-scatter, written out: sum over the group in f32, keep this rank's slice; a copy, since
        # autograd may hand the same gradient tensor to another branch (a residual)
        total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total[dist.get_rank(ctx.group)].to(g.dtype), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[...] on each rank -> [n, ...], rank order.  Differentiable."""
    return _AllGather.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # a copy: summing the incoming gradient in place would change what a residual branch sees of it
        total = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, on every rank.  Differentiable."""
    return _AllReduceSum.apply(x, group)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        # an all-reduce and this rank's slice (gloo has no reduce-scatter in every version), summed in f32
        total = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=group)
        return total[dist.get_rank(group)].to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each rank -> this rank's part of the sum over the
    group, [...].  Differentiable: its backward is the all-gather (the
    transpose of ``all_gather``, whose backward is this)."""
    if x.shape[0] != dist.get_world_size(group):
        raise ValueError(f"reduce_scatter: {x.shape[0]} parts for a group of {dist.get_world_size(group)} ranks")
    return _ReduceScatter.apply(x, group)


def all_gather_stats(x: torch.Tensor, group) -> torch.Tensor:
    """Gradient-free all-gather of a small stats tensor: [...] -> [n, ...]."""
    with torch.no_grad():
        return _gather(x.detach(), group)
