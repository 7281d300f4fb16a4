"""Token geometry of the MoE fabric: pure slot math on torch tensors.

The router's (token, choice) pairs are admitted against a schedule row,
packed into a shape-static slot space (buckets for the uniform fabrics,
phase-major blocks for the envelope fabrics), computed, and
scatter-added back onto the residual stream.  No collectives: every
fabric packs through here, so fabrics differ only in movement.
Counterpart of ``repro/parallel/fabric/geometry.py``; every sort is
stable, as JAX's ``argsort`` is, so both packages admit and pack the
same choices.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schedule import ScheduleTable

__all__ = [
    "round8",
    "group_tokens",
    "pack_slots",
    "ungroup",
    "rank_in_group",
    "pod_of",
    "same_pod",
    "wire_mask_buckets",
    "admission_mask",
    "phase_serving",
    "phase_slot_assign",
    "routing_counts",
    "stats_tree",
]

_INT32_MAX = 2**31 - 1


def pod_of(idx, pod_size: int):
    """Pod of a rank (or virtual rank) index: ranks ``[p * pod_size,
    (p + 1) * pod_size)`` form pod ``p``.  Ints, numpy or tensors."""
    return idx // pod_size


def same_pod(src, dst, pod_size: int):
    """Elementwise (broadcasting): do ``src`` and ``dst`` share a pod?"""
    return pod_of(src, pod_size) == pod_of(dst, pod_size)


def round8(x):
    """max(8, ceil to a multiple of 8) — scalar int or int array."""
    r = np.maximum(8, -(-np.asarray(x) // 8) * 8)
    return int(r) if r.ndim == 0 else r


def group_tokens(x, key, gates, n_buckets: int, cap: int, admitted=None):
    """Pack tokens into per-bucket slots.

    x [T, d]; key [T*k] bucket per (token, choice); gates [T*k];
    admitted [T*k] bool (None = all).  Returns buf [n_buckets, cap, d],
    pos [n_buckets, cap] int32 (-1 pads), gate [n_buckets, cap] f32 and
    live [n_buckets, cap] bool (slot holds a real admitted token).
    Choices past a bucket's capacity are dropped."""
    tk = key.shape[0]
    t = x.shape[0]
    dev = x.device
    token_of = torch.arange(tk, dtype=torch.int32, device=dev) // (tk // t)
    key = key.long()
    order = torch.argsort(key, stable=True)
    skey = key[order]
    # scatter-add, not bincount: bincount sizes its output on the host (a device sync)
    counts = torch.zeros(n_buckets, dtype=torch.long, device=dev).scatter_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=dev) - starts[skey]
    slot = torch.where(rank < cap, skey * cap + rank, torch.full_like(rank, n_buckets * cap))
    n_slots = n_buckets * cap + 1  # last slot swallows cut choices
    buf = torch.zeros((n_slots, x.shape[1]), dtype=x.dtype, device=dev)
    buf[slot] = x[token_of[order].long()]
    pos = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
    pos[slot] = token_of[order]
    gat = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    gat[slot] = gates.reshape(-1)[order].float()
    adm = torch.ones(tk, dtype=torch.bool, device=dev) if admitted is None else admitted.reshape(-1)
    liv = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    liv[slot] = adm[order]
    return (
        buf[:-1].reshape(n_buckets, cap, -1),
        pos[:-1].reshape(n_buckets, cap),
        gat[:-1].reshape(n_buckets, cap),
        liv[:-1].reshape(n_buckets, cap),
    )


def pack_slots(x, slot, gates, admitted, n_slots: int):
    """Direct-slot twin of ``group_tokens`` for precomputed assignments.

    slot [T*k] flat slot per (token, choice), unique for kept choices;
    ``n_slots`` is the dump slot of cut choices.  Returns flat buf
    [n_slots, d], pos [n_slots] int32 (-1 pads), gate [n_slots] f32 and
    live [n_slots] bool (a real admitted token)."""
    tk = slot.shape[0]
    t = x.shape[0]
    dev = x.device
    token_of = torch.arange(tk, dtype=torch.int32, device=dev) // (tk // t)
    slot = slot.long()
    buf = torch.zeros((n_slots + 1, x.shape[1]), dtype=x.dtype, device=dev)
    buf[slot] = x[token_of.long()]
    pos = torch.full((n_slots + 1,), -1, dtype=torch.int32, device=dev)
    pos[slot] = token_of
    gat = torch.zeros((n_slots + 1,), dtype=torch.float32, device=dev)
    gat[slot] = gates.reshape(-1).float()
    liv = torch.zeros((n_slots + 1,), dtype=torch.bool, device=dev)
    liv[slot] = admitted.reshape(-1)
    return buf[:-1], pos[:-1], gat[:-1], liv[:-1]


def ungroup(y, pos, gate, t: int):
    """Gate-weighted scatter-add of processed slots back to [T, d] (f32)."""
    yf = y.reshape(-1, y.shape[-1]).float()
    pf = pos.reshape(-1).long()
    safe = torch.where(pf >= 0, pf, torch.full_like(pf, t))
    out = torch.zeros((t + 1, y.shape[-1]), dtype=torch.float32, device=y.device)
    out.index_add_(0, safe, yf * gate.reshape(-1)[:, None])
    return out[:t]


def rank_in_group(key: torch.Tensor) -> torch.Tensor:
    """Arrival rank of each element among same-key elements, in order.
    [N] int -> [N] int32 (exactly the bucket slot ``group_tokens`` gives)."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sk = key[order]
    idxs = torch.arange(n, dtype=torch.int32, device=key.device)
    is_start = torch.ones(n, dtype=torch.bool, device=key.device)
    is_start[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(is_start, idxs, torch.zeros_like(idxs)), 0).values
    out = torch.zeros_like(idxs)
    out[order] = idxs - first
    return out


def wire_mask_buckets(live, e_local: int, me: int):
    """Wire-crossing slots of a ``[n * e_local, cap]`` bucket layout: live
    slots whose bucket's rank (``bucket // e_local``) is not ``me``."""
    dst = torch.arange(live.shape[0], device=live.device) // e_local
    return live & (dst != me)[:, None]


def admission_mask(idx, gates, row: ScheduleTable, n_experts: int, *, src):
    """Enforce a schedule row's planned capacities on the gates.

    idx/gates [T, k]; src [T*k] source rank of each choice.  A choice is
    admitted iff its arrival rank in its (src, expert) bucket is below the
    pair's per-expert capacity (``row.pair_caps``); local (src == dst)
    traffic is never clipped.  Returns (masked gates, admitted [T*k])."""
    n_v = row.n
    e_local = n_experts // n_v
    e_flat = idx.reshape(-1).long()
    dst = e_flat // e_local
    src = src.long()
    cap_pair = row.pair_caps(e_local)
    cap_flat = torch.where(
        src == dst, torch.full_like(dst, _INT32_MAX), cap_pair[src, dst].long()
    )
    rank = rank_in_group(src * n_experts + e_flat)
    admitted = rank.long() < cap_flat
    return gates * admitted.reshape(gates.shape), admitted


def phase_serving(row: ScheduleTable, e_local: int, me: int):
    """Rank ``me``'s phase-major serving plan from a schedule row, [K_max]
    per phase: ``on_k`` (bool: ``me`` takes part), ``dst_k`` (its
    destination), ``serve`` (per-expert slots the pair carries, the
    envelope-clamped ``phase_slot_caps``, 0 when off), and [K, n]
    ``cum`` / ``cum_lo``: inclusive / exclusive per-destination
    cumulative slots.  ``cum[-1]`` is ``pair_caps(e_local)[me]``, so
    admission and the phase slotting read the same numbers."""
    k_max, n = row.perms.shape
    dev = row.perms.device
    kk = torch.arange(k_max, device=dev)
    on_k = (kk < row.n_phases) & row.valid[:, me]
    dst_k = row.perms[:, me].long()
    serve = torch.where(on_k, row.phase_slot_caps(e_local), torch.zeros((), dtype=torch.int32, device=dev))
    serve_mat = torch.zeros((k_max, n), dtype=torch.int32, device=dev).index_put_((kk, dst_k), serve, accumulate=True)
    cum = torch.cumsum(serve_mat, dim=0, dtype=torch.int32)
    return on_k, dst_k, serve, cum, cum - serve_mat


def phase_slot_assign(row: ScheduleTable, e_local: int, me: int, e_flat, rank, *, c_local: int):
    """A flat slot in the phase-major buffer for every routing choice.

    Layout ``[phase-0 block | ... | phase-(K-1) block | local block]``:
    phase k's block is ``[e_local, env_k]`` slots (``env_k`` the static
    envelope slot size), the local block ``[e_local, c_local]``.
    ``e_flat`` [T*k] expert ids, ``rank`` the arrival rank within the
    expert.  Returns (slot [T*k], admitted [T*k], bases, env_slots,
    n_slots, on_k, dst_k): a remote choice is admitted iff its rank fits
    the pair's planned slots, and then lands inside its phase block."""
    env_slots = row.envelope_slots(e_local)
    k_max, n = row.perms.shape
    dev = e_flat.device
    bases, off = [], 0
    for ck in env_slots:
        bases.append(off)
        off += e_local * ck
    s_remote = off
    n_slots = s_remote + e_local * c_local
    on_k, dst_k, serve, cum, cum_lo = phase_serving(row, e_local, me)

    e_flat, rank = e_flat.long(), rank.long()
    dst = e_flat // e_local
    le = e_flat % e_local
    local = dst == me
    admitted = local | (rank < cum[-1][dst])
    # the phase whose [cum_lo, cum) window holds a remote choice's rank
    ph = (rank[None, :] >= cum[:, dst]).sum(dim=0)
    ph_c = torch.clamp(ph, 0, k_max - 1)
    base_arr = torch.tensor(bases, dtype=torch.int64, device=dev)
    env_arr = torch.tensor(env_slots, dtype=torch.int64, device=dev)
    slot_in = rank - cum_lo[ph_c, dst]
    remote_slot = base_arr[ph_c] + le * env_arr[ph_c] + slot_in
    local_slot = s_remote + le * c_local + rank
    dump = torch.full_like(rank, n_slots)
    slot = torch.where(
        local,
        torch.where(rank < c_local, local_slot, dump),
        torch.where(admitted, remote_slot, dump),
    ).to(torch.int32)
    return slot, admitted, tuple(bases), env_slots, n_slots, on_k, dst_k


def routing_counts(idx, n_experts: int, weight=None):
    """Realized per-expert demand from [T, k] expert ids (pre-drop, f32).
    ``weight`` ([T] f32, optional) scales each token's count: the serving
    engine's slot-liveness mask, so vacated decode slots count nothing."""
    flat = idx.reshape(-1).long()
    if weight is None:
        w = torch.ones(flat.shape[0], dtype=torch.float32, device=idx.device)
    else:
        w = weight.to(torch.float32)[:, None].expand(idx.shape).reshape(-1)
    return torch.zeros(n_experts, dtype=torch.float32, device=idx.device).index_add_(0, flat, w)


def stats_tree(counts, admitted, live) -> dict:
    """The MoE layer's stats: ``routing`` (the counts), ``dropped``
    (choices the plan admitted that packing still cut) and ``admitted``
    (choices the plan admitted), the last two shaped like ``routing``'s
    leading dims."""
    adm = admitted.sum().float()
    dropped = adm - live.sum().float()
    lead = (1,) * (counts.dim() - 1)
    return {"routing": counts, "dropped": dropped.reshape(lead), "admitted": adm.reshape(lead)}
