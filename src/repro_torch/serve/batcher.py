"""Slot-based continuous decode batch: the host mirror of the device
decode state.

The decode step is captured ONCE (one CUDA graph on the card) for a
fixed batch of ``n_slots`` rows; liveness is data, not shape.  Each slot carries its
own absolute position (the ``[B]`` step vector ``attn_decode``
consumes), so rows decode at ragged depths; a finished sequence vacates
its slot on the spot and the next admission reuses the row — no
recapture, no drain barrier.  Vacant slots keep decoding garbage tokens
(static shapes!) but are masked everywhere it matters: the ``live``
vector zeroes their routing-stats weight on the device, and the host simply
never reads their outputs.

Counterpart of ``repro/serve/batcher.py``, a copy (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve.queue import Request

__all__ = ["ContinuousBatcher"]


class ContinuousBatcher:
    """Host-side slot table for one static-shape decode batch."""

    def __init__(self, n_slots: int, max_len: int):
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.requests: list[Request | None] = [None] * n_slots
        self.step = np.zeros(n_slots, np.int32)  # next position to write
        self.remaining = np.zeros(n_slots, np.int32)
        self.token = np.zeros(n_slots, np.int32)  # next input token
        self.live = np.zeros(n_slots, bool)

    # ------------------------------------------------------------ queries
    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def free_slot(self) -> int | None:
        idle = np.flatnonzero(~self.live)
        return int(idle[0]) if idle.size else None

    def fits(self, req: Request) -> bool:
        """KV-cache admission check: the request's peak position must fit
        the slot's preallocated cache."""
        return req.kv_tokens <= self.max_len

    # ------------------------------------------------------- transitions
    def admit(self, slot: int, req: Request) -> None:
        """Seat ``req`` in ``slot``: its prefilled KV row is already in
        the decode cache; the last prompt token becomes the first decode
        input at position ``prompt_len - 1``."""
        assert not self.live[slot], f"slot {slot} is occupied"
        assert self.fits(req), (req.kv_tokens, self.max_len)
        self.requests[slot] = req
        self.step[slot] = req.prompt_len - 1
        self.remaining[slot] = req.max_new_tokens
        self.token[slot] = int(req.prompt[-1])
        self.live[slot] = True

    def advance(self, next_tokens: np.ndarray, wall: float) -> list[Request]:
        """Fold one decode step's outputs: append each live slot's token,
        bump its position, and vacate slots that hit their budget.
        Returns the finished requests (already vacated)."""
        next_tokens = np.asarray(next_tokens)
        finished: list[Request] = []
        for s in np.flatnonzero(self.live):
            req = self.requests[s]
            tok = int(next_tokens[s])
            if not req.tokens:
                req.first_token_wall = wall
            req.tokens.append(tok)
            self.token[s] = tok
            self.step[s] += 1
            self.remaining[s] -= 1
            if self.remaining[s] == 0:
                req.finish_wall = wall
                finished.append(req)
                self.vacate(s)
        return finished

    def vacate(self, slot: int) -> None:
        self.requests[slot] = None
        self.live[slot] = False
        self.step[slot] = 0
        self.remaining[slot] = 0
        self.token[slot] = 0
