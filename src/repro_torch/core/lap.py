"""Batched auction LAP on torch tensors: the device controller's solver.

Counterpart of ``repro/core/lap_jax.py``.  A Jacobi (synchronous-bidding)
auction with epsilon scaling [Bertsekas '88], batched over a ``[L, n, n]``
stack, on the device of the tensors it is given.  JAX runs the bidding
rounds as one ``lax.while_loop``; here they are a Python loop of tensor
ops that stops once every matrix of the stack has converged.  On a CUDA
tensor the host reads the convergence flag every ``CHECK_EVERY_CUDA``
rounds, not every round: a round after convergence places no bid and
changes nothing, so the extra rounds leave the result as JAX's.

Exactness contract (as the reference's): costs are scaled by ``n + 1``
and the epsilon schedule is kept integer (``eps_final = 1`` in scaled
units), so for integer-valued cost matrices the matching's weight equals
scipy's optimum exactly; on float matrices the gap is under one unit.
All arithmetic stays integer-valued, hence exact in f32 below ``2**24``.
The tie-breaks are the reference's: ``argmax`` takes the first index on
both the CPU and the card, and the free-column fill sorts, so on the same
inputs the permutations equal JAX's, not merely their weight.

``greedy_phases`` (JAX: ``greedy_phases_jax``) stacks the solver into the
greedy max-weight decomposition + ``plan_schedule`` pipeline: ``k_max``
phase slots, each solving the batched LAP on the residual stack and
clearing the matched pairs in full (``min_fill = 0``).
"""

from __future__ import annotations

import torch

__all__ = ["auction_lap", "auction_lap_batch", "greedy_phases", "matching_weight"]

# a tracing-side safety net in the reference, far above what epsilon
# scaling needs at n <= 64 (observed: < 400 rounds)
MAX_ROUNDS = 20_000
# rounds between two host reads of the convergence flag on a CUDA tensor
CHECK_EVERY_CUDA = 16


def _solve(a: torch.Tensor, max_rounds: int) -> torch.Tensor:
    """Epsilon-scaling Jacobi auction on a scaled [L, n, n] f32 stack.
    Returns ``perm`` [L, n] int32 (``perm[l, i]`` = column of row i)
    maximizing ``a[l, i, perm[l, i]].sum()`` to within ``n * eps_final``."""
    L, n, _ = a.shape
    dev = a.device
    neg = -(3.0 * n + 4.0) * torch.clamp(a.abs().amax(dim=(1, 2)), min=1.0)  # [L]: below any bid
    neg3 = neg[:, None, None]
    eps_final = 1.0
    span = a.amax(dim=(1, 2)) - a.amin(dim=(1, 2))
    eps = torch.clamp(torch.floor(span / 4.0), min=eps_final)  # [L]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_col = idx[None, None, :]
    sentinel = torch.full((L, 1), n, dtype=torch.int32, device=dev)
    p = torch.zeros((L, n), dtype=torch.float32, device=dev)
    owner = torch.full((L, n), -1, dtype=torch.int32, device=dev)  # per object: its person
    curr = torch.full((L, n), -1, dtype=torch.int32, device=dev)  # per person: its object
    check_every = CHECK_EVERY_CUDA if dev.type == "cuda" else 1
    for it in range(max_rounds):
        unassigned = curr < 0
        # values net of price; each unassigned person bids its best object
        # up by (best - second best + eps)
        v = a - p[:, None, :]
        best_j = torch.argmax(v, dim=2).to(torch.int32)
        at_best = is_col == best_j[:, :, None]
        v1 = v.amax(dim=2)
        v2 = torch.where(at_best, neg3, v).amax(dim=2)
        bid = torch.gather(p, 1, best_j.long()) + (v1 - v2) + eps[:, None]
        # objects take the highest bid; all assigned => no bids => no-op
        bids = torch.where(unassigned[:, :, None] & at_best, bid[:, :, None], neg3)
        top = bids.amax(dim=1)
        winner = torch.argmax(bids, dim=1).to(torch.int32)
        has_bid = top > neg[:, None]
        # evict prior owners of re-auctioned objects, then assign the
        # winners (distinct: a person bids on one object); index n is the
        # reference's dropped scatter
        ext = torch.cat([curr, sentinel], dim=1)
        ext.scatter_(1, torch.where(has_bid & (owner >= 0), owner, n).long(), -1)
        ext.scatter_(1, torch.where(has_bid, winner, n).long(), torch.where(has_bid, idx, 0).expand(L, n))
        curr = ext[:, :n]
        owner = torch.where(has_bid, winner, owner)
        p = torch.where(has_bid, top, p)
        # epsilon phase transition: all assigned at a coarse eps => shrink
        # eps, keep prices, restart the assignment
        shrink = (curr >= 0).all(dim=1) & (eps > eps_final)
        eps = torch.where(shrink, torch.clamp(torch.floor(eps / 6.0), min=eps_final), eps)
        curr = torch.where(shrink[:, None], -1, curr)
        owner = torch.where(shrink[:, None], -1, owner)
        if (it + 1) % check_every == 0 and bool(((curr >= 0).all(dim=1) & (eps <= eps_final)).all()):
            break
    # round-cap repair (never taken in practice): pair leftover persons
    # with unowned objects in index order, so the result is a permutation
    taken = torch.zeros((L, n + 1), dtype=torch.bool, device=dev)
    taken.scatter_(1, torch.where(curr >= 0, curr, n).long(), True)
    free_sorted = torch.sort(torch.where(taken[:, :n], n, idx), dim=1).values
    rank = torch.cumsum((curr < 0).to(torch.int32), dim=1) - 1
    fill = torch.gather(free_sorted, 1, torch.clamp(rank, 0, n - 1).long())
    return torch.where(curr < 0, fill, curr).to(torch.int32)


def _masked(a: torch.Tensor, mask, maximize: bool) -> torch.Tensor:
    """Negate for min-cost, then drive masked pairs to ``-big``, so they are
    chosen only when a row has no usable column left."""
    if not maximize:
        a = -a
    if mask is not None:
        n = a.shape[-1]
        big = (a.abs().max() + 1.0) * (n + 1)
        a = torch.where(torch.as_tensor(mask, dtype=torch.bool, device=a.device), a, -big)
    return a


def auction_lap(costs, mask=None, *, maximize: bool = True, max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """Solve one dense [n, n] assignment problem; [n] int32 ``perm`` with
    ``perm[i]`` the column of row i.  ``mask`` ([n, n] bool, True = usable)
    drives masked pairs to a large negative value.  For integer-valued
    ``costs`` the weight equals scipy ``linear_sum_assignment``'s."""
    a = torch.as_tensor(costs).to(torch.float32)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected square [n, n] costs, got {tuple(a.shape)}")
    a = _masked(a, mask, maximize)
    return _solve((a * (a.shape[0] + 1.0))[None], max_rounds)[0]


def auction_lap_batch(costs, mask=None, *, maximize: bool = True, max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """``auction_lap`` over a [L, n, n] stack -> [L, n] perms.  ``mask`` is
    one fabric-wide [n, n] availability shared by the whole stack."""
    a = torch.as_tensor(costs).to(torch.float32)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected [L, n, n] stack, got {tuple(a.shape)}")
    a = _masked(a, None if mask is None else torch.as_tensor(mask)[None], maximize)
    return _solve(a * (a.shape[1] + 1.0), max_rounds)


def matching_weight(costs, perm) -> torch.Tensor:
    """``sum_i costs[..., i, perm[..., i]]`` over any shared leading dims."""
    costs, perm = torch.as_tensor(costs), torch.as_tensor(perm)
    return torch.gather(costs, -1, perm[..., :, None].long())[..., 0].sum(-1)


def greedy_phases(
    traffic, *, k_max: int, quantum: int = 8, min_cap: int = 8, slack: float = 1.0, mask=None,
    max_rounds: int = MAX_ROUNDS,
) -> dict:
    """Greedy max-weight decomposition + ``plan_schedule`` over ``k_max``
    phase slots (``min_fill = 0``; residual past ``k_max`` slots is planned
    drops).  ``traffic`` [L, n, n] (diagonal ignored); ``mask`` optional
    fabric-wide [n, n] bool, masked pairs never valid.

    Returns the table leaves: perms [L, k_max, n] i32, caps [L, k_max] i32
    (``round_up(max(ceil(max_sent * slack), min_cap), quantum)``, 0 on dark
    slots), valid [L, k_max, n] bool, n_phases [L] i32, sent [L, k_max, n]
    f32 and residual [L, n, n] f32."""
    a = torch.as_tensor(traffic).to(torch.float32)
    L, n, _ = a.shape
    dev = a.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    a = torch.where(eye[None], 0.0, a)
    usable = ~eye if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=dev) & ~eye
    a = torch.where(usable[None], a, 0.0)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    residual, out = a, {"perms": [], "caps": [], "valid": [], "sent": []}
    for _ in range(k_max):
        # unpenalized solve, like the host greedy: dark and diagonal entries
        # are zero in the residual, so rows park on them at weight 0 and
        # ``valid`` keeps those pairs unrouted
        perms = auction_lap_batch(residual, max_rounds=max_rounds)
        sent = torch.gather(residual, 2, perms[:, :, None].long())[:, :, 0]
        valid = (sent > 0) & (perms != idx[None, :]) & usable[idx[None, :].long(), perms.long()]
        sent = torch.where(valid, sent, 0.0)
        residual = torch.where(valid[:, :, None] & (idx[None, None, :] == perms[:, :, None]), 0.0, residual)
        # plan_schedule's cap rounding (alloc == sent for max-weight); dark slots keep cap 0
        mx = torch.where(valid, sent, 0.0).amax(dim=1)
        cap = torch.clamp(torch.ceil(mx * slack), min=float(min_cap)).to(torch.int32)
        cap = -torch.div(-cap, quantum, rounding_mode="floor") * quantum
        cap = torch.where(valid.any(dim=1), cap, 0).to(torch.int32)
        for key, val in zip(("perms", "caps", "valid", "sent"), (perms, cap, valid, sent)):
            out[key].append(val)
    perms, caps, valid, sent = (torch.stack(out[key], dim=1) for key in ("perms", "caps", "valid", "sent"))
    # live slots form a prefix, so the phase count is the live count; dark
    # slots carry the identity perm, as ``ScheduleTable.from_schedules``
    live = valid.any(dim=2)
    perms = torch.where(live[:, :, None], perms, idx[None, None, :])
    return {
        "perms": perms.to(torch.int32),
        "caps": caps,
        "valid": valid,
        "n_phases": live.sum(dim=1).to(torch.int32),
        "sent": sent,
        "residual": residual,
    }
