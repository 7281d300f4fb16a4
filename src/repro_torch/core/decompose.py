"""Unified decomposition API.

``decompose(matrix, strategy)`` removes the diagonal (rank-local tokens
never ride a circuit), decomposes the rest and returns the diagonal in
``meta["local_tokens"]``; ``decompose_batch`` does the same for a stack
``[L, n, n]``.  Counterpart of ``repro/core/decompose.py``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bvn import bvn_decompose, bvn_decompose_batch
from repro_torch.core.faults import apply_link_mask
from repro_torch.core.maxweight import maxweight_decompose, maxweight_decompose_batch
from repro_torch.core.types import Decomposition, StackedPhases

__all__ = ["decompose", "decompose_batch", "STRATEGIES"]

STRATEGIES = ("bvn", "bvn-bottleneck", "maxweight", "shift")


def _shift_decompose(matrix: np.ndarray) -> Decomposition:
    """Static shifted ring: phase k sends i -> (i+k) mod n, n-1 phases."""
    a = np.asarray(matrix, dtype=np.float64)
    n = a.shape[0]
    idx = np.arange(n)
    perms = (idx[None, :] + np.arange(1, n)[:, None]) % n  # [n-1, n]
    sent = a[idx[None, :], perms].copy() if n > 1 else np.zeros((0, n))
    stacked = StackedPhases(perms=perms, alloc=sent.copy(), sent=sent)
    d = Decomposition(matrix=a, phases=stacked.to_phases(), strategy="shift", meta={})
    d._stacked_cache = stacked
    return d


def decompose(
    matrix: np.ndarray,
    strategy: str,
    *,
    keep_diagonal: bool = False,
    link_mask: np.ndarray | None = None,
    **kwargs,
) -> Decomposition:
    """Decompose a traffic matrix with ``strategy``; ``kwargs`` go to the
    strategy (``min_fill``/``warm_start`` for max-weight).  Unless
    ``keep_diagonal`` the diagonal is split off first.  ``link_mask``
    (``[n, n]`` bool, True = usable) reroutes demand around dark pairs
    (``faults.apply_link_mask``) for every strategy."""
    a = np.asarray(matrix, dtype=np.float64).copy()
    local = np.zeros(a.shape[0])
    if not keep_diagonal:
        local = np.diag(a).copy()
        np.fill_diagonal(a, 0.0)
    mask_meta: dict = {}
    if link_mask is not None and strategy != "maxweight":
        a = apply_link_mask(a, link_mask, meta=mask_meta)
    if strategy == "bvn":
        d = bvn_decompose(a, **kwargs)
    elif strategy == "bvn-bottleneck":
        d = bvn_decompose(a, bottleneck=True, **kwargs)
    elif strategy == "maxweight":
        d = maxweight_decompose(a, link_mask=link_mask, **kwargs)
    elif strategy == "shift":
        d = _shift_decompose(a)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    d.meta["local_tokens"] = local
    if link_mask is not None:
        d.meta["link_masked"] = True
        d.meta.setdefault("unroutable_tokens", mask_meta.get("unroutable_tokens", 0.0))
    return d


def decompose_batch(
    matrices: np.ndarray,
    strategy: str,
    *,
    keep_diagonal: bool = False,
    warm_start: list | None = None,
    link_mask: np.ndarray | None = None,
    backend: str = "scipy",
    **kwargs,
) -> list[Decomposition]:
    """Decompose a stack ``[L, n, n]`` in one call (one matrix per MoE
    layer or regime), the diagonal handled as in ``decompose``.
    ``warm_start`` (max-weight only) is a per-layer list of ``WarmState``;
    ``link_mask`` is one fabric-wide mask shared by every layer;
    ``backend`` is the max-weight LAP solver."""
    stack = np.asarray(matrices, dtype=np.float64)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected [L, n, n] stack, got {stack.shape}")
    n_layers = stack.shape[0]
    stack = stack.copy()
    local = np.zeros((n_layers, stack.shape[1]))
    if not keep_diagonal:
        local = np.einsum("lii->li", stack).copy()
        np.einsum("lii->li", stack)[:] = 0.0
    if link_mask is not None and strategy != "maxweight":
        stack = np.stack([apply_link_mask(stack[i], link_mask) for i in range(n_layers)])
    if strategy == "maxweight":
        out = maxweight_decompose_batch(stack, warm_start=warm_start, link_mask=link_mask, backend=backend, **kwargs)
    elif warm_start is not None:
        raise ValueError("warm_start is only supported for 'maxweight'")
    elif backend != "scipy":
        raise ValueError(f"backend={backend!r} is only supported for 'maxweight'")
    elif strategy in ("bvn", "bvn-bottleneck"):
        out = bvn_decompose_batch(stack, bottleneck=(strategy == "bvn-bottleneck"), **kwargs)
    elif strategy == "shift":
        out = [_shift_decompose(stack[i]) for i in range(n_layers)]
    else:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    for i, d in enumerate(out):
        d.meta["local_tokens"] = local[i]
        if link_mask is not None:
            d.meta["link_masked"] = True
    return out
