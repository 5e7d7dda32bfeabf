"""FIFO admission for the continuous-batching engine (port of
``Request`` and ``FIFOScheduler`` from ``repro/serving/scheduler.py``).

Any free lane takes the head request; requests admitted together are
prefilled as one right-aligned group (phased engines) or each at its own
lane's ``offset == 0`` (mixed and prefix-cached engines). Feasibility is
checked once, at ``submit``: the slot gate (the prompt must leave decode
headroom under ``max_len``) plus an engine-installed ``feasibility`` hook
(the paged engine's page-unit check). Paged engines also gate each
admission group on free pages, strict FIFO. The mixed engine spends a
token budget per step: decode tokens first, the rest split into prompt
chunks (``plan_chunks``).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request (prompt is a 1-D int32 array)."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        self.queued_at = time.monotonic()   # re-stamped at submit
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            # prefill always emits one token; a zero budget would also
            # under-pin pages (cost is width + budget - 1 slots)
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


class FIFOScheduler:
    """FIFO admission for ``max_batch`` lanes of ``max_len`` slots.

    ``prefill_token_budget`` caps the tokens one mixed engine step may
    spend (``None``: the engine sets its default, ``max_batch +
    prefill_chunk``; phased engines ignore it)."""

    def __init__(self, max_batch: int, max_len: int,
                 prefill_token_budget: int | None = None):
        if max_batch < 1 or max_len < 2:
            raise ValueError(f"max_batch={max_batch}, max_len={max_len}")
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget={prefill_token_budget} must be >= 1")
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_token_budget = prefill_token_budget
        # engine-installed extra submit gate: callable(req) raising
        # ValueError when the request could never run
        self.feasibility: Callable[[Request], None] | None = None
        self._queue: deque[Request] = deque()
        self.reset_stats()

    def reset_stats(self) -> None:
        # ``rejections``: distinct queue heads the page gate blocked (a
        # head waiting many steps counts once); ``rejected_steps``: every
        # admission attempt the gate blocked the head
        self.rejections = 0
        self.rejected_steps = 0
        self._blocked_uid: int | None = None

    def __len__(self) -> int:
        return len(self._queue)

    def head(self) -> Request | None:
        """The request that would be admitted next (None when empty)."""
        return self._queue[0] if self._queue else None

    def submit(self, req: Request) -> None:
        if req.prompt_len >= self.max_len:
            raise ValueError(
                f"prompt of {req.prompt_len} tokens cannot fit max_len="
                f"{self.max_len} with room to generate")
        if self.feasibility is not None:
            self.feasibility(req)
        req.queued_at = time.monotonic()
        self._queue.append(req)

    def admit(self, n_free: int, free_pages: int | None = None,
              page_cost=None) -> list[Request]:
        """Pop the FIFO prefix that may start now: at most ``n_free``
        requests, and with ``page_cost`` (group -> pages it would pin)
        only as many as ``free_pages`` covers. The cost is recomputed for
        the whole trial group, since a longer prompt widens every
        member's right-aligned extent (with the prefix cache it is the
        effective cost, against free + reclaimable pages). A page-gated
        stop counts once per distinct blocked head (``rejections``) and
        once per attempt (``rejected_steps``)."""
        out: list[Request] = []
        while self._queue and len(out) < n_free:
            if (page_cost is not None
                    and page_cost(out + [self._queue[0]]) > free_pages):
                self.rejected_steps += 1
                head = self._queue[0]
                if head.uid != self._blocked_uid:
                    self.rejections += 1
                    self._blocked_uid = head.uid
                break
            out.append(self._queue.popleft())
        return out

    def plan_chunks(self, tails: list[tuple[int, int]], n_decode: int,
                    chunk_cap: int) -> dict[int, int]:
        """Split one mixed step's budget across prefilling lanes.
        ``tails`` is [(lane, prompt tokens left)] in admission order; the
        ``n_decode`` decode tokens are spent first, the rest handed out
        FIFO, at most ``chunk_cap`` per lane. Returns {lane: chunk}, empty
        when decode fills the budget."""
        left = (max(self.prefill_token_budget - n_decode, 0)
                if self.prefill_token_budget is not None
                else chunk_cap * len(tails))
        plan: dict[int, int] = {}
        for lane, rem in tails:
            c = min(rem, chunk_cap, left)
            if c <= 0:
                break
            plan[lane] = c
            left -= c
        return plan

    def push_front(self, reqs: list[Request]) -> None:
        """Return admitted requests that never started to the queue head,
        in their order."""
        for r in reversed(reqs):
            self._queue.appendleft(r)
