"""Request model and length-bucketed admission queue.

The serving front-end is host-side and shape-aware: every step
function in the engine runs at static shapes, so the queue's job is to
translate ragged arrivals into the small set of shapes the engine
compiles.  Prompts are bucketed by *prefill length* (``prompt_len - 1``
— the last prompt token rides the decode path so the first generated
token comes from a batched decode step, not a per-length prefill
variant): a request joins the smallest bucket that fits, prefill pads to
the bucket length, and padding KV is masked out of the cache before the
row enters the decode batch.  Requests longer than the largest bucket,
or whose KV footprint (``kv_tokens``) exceeds the engine's cache, are
*rejected* at add/admit time and surfaced in the metrics — never
silently truncated.

Ordering is global FIFO: ``pop`` returns the oldest request across all
buckets (per-bucket FIFO composes with arrival order), so bucketing
shapes compilation, not fairness.

Counterpart of ``repro/serve/queue.py``, a copy (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

import numpy as np

__all__ = ["Request", "RequestQueue"]

_rid = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle telemetry.

    ``arrival`` is in virtual time — decode-step units — so offered load
    is deterministic and independent of host speed; the wall-clock
    fields are stamped by the engine as the request moves through
    admission → first token → completion.
    """

    prompt: np.ndarray  # [P] int32 token ids
    max_new_tokens: int
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))
    # engine-stamped lifecycle telemetry
    admit_step: int | None = None  # decode-step count at admission
    admit_wall: float | None = None
    first_token_wall: float | None = None
    finish_wall: float | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def prefill_len(self) -> int:
        """Tokens the prefill executable consumes (the last prompt token
        enters through the decode path — see module docstring)."""
        return self.prompt_len - 1

    @property
    def kv_tokens(self) -> int:
        """Peak KV positions the request occupies: the last decode step
        writes position ``prompt_len + max_new_tokens - 2``."""
        return self.prompt_len + self.max_new_tokens - 1

    @property
    def done(self) -> bool:
        return self.finish_wall is not None


class RequestQueue:
    """Length-bucketed FIFO admission queue (see module docstring)."""

    def __init__(self, buckets=(16, 32, 64)):
        bs = tuple(sorted(int(b) for b in buckets))
        if not bs or bs[0] < 1:
            raise ValueError(f"need at least one positive bucket, got {buckets}")
        if len(set(bs)) != len(bs):
            raise ValueError(f"duplicate buckets in {buckets}")
        self.buckets = bs
        self._q: dict[int, deque[Request]] = {b: deque() for b in bs}
        self._order = 0  # monotone tie-break for equal arrivals

    def bucket_of(self, prefill_len: int) -> int | None:
        """Smallest bucket holding ``prefill_len`` tokens; None when the
        prompt exceeds every bucket (the caller rejects and counts it).
        A 1-token prompt (prefill_len 0) takes the smallest bucket —
        the engine skips its empty prefill entirely."""
        for b in self.buckets:
            if prefill_len <= b:
                return b
        return None

    def add(self, req: Request) -> bool:
        """Enqueue; False = no bucket fits (rejected, caller's metric)."""
        b = self.bucket_of(req.prefill_len)
        if b is None:
            return False
        self._q[b].append(req)
        return True

    def pop(self) -> tuple[Request, int] | None:
        """Oldest request across buckets, with its bucket length."""
        best: tuple[float, int, int] | None = None  # (arrival, seq, bucket)
        for b, dq in self._q.items():
            if dq:
                head = dq[0]
                key = (head.arrival, head.rid, b)
                if best is None or key < best:
                    best = key
        if best is None:
            return None
        b = best[2]
        return self._q[b].popleft(), b

    def push_front(self, req: Request) -> None:
        """Return a popped-but-unadmittable request to its bucket head
        (KV pressure: it retries when a slot frees up)."""
        b = self.bucket_of(req.prefill_len)
        assert b is not None, "push_front of a request that never fit"
        self._q[b].appendleft(req)

    def __len__(self) -> int:
        return sum(len(dq) for dq in self._q.values())

    def depths(self) -> dict[int, int]:
        return {b: len(dq) for b, dq in self._q.items()}
