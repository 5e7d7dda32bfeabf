"""FIFO admission for the continuous-batching engine (port of
``Request`` and ``FIFOScheduler`` from ``repro/serving/scheduler.py``).

Any free lane takes the head request; requests admitted together are
prefilled as one right-aligned group. Feasibility is checked once, at
``submit``: the slot gate (the prompt must leave decode headroom under
``max_len``) plus an engine-installed ``feasibility`` hook (the paged
engine's page-unit check). Paged engines also gate each admission group
on free pages, strict FIFO.
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
    """FIFO admission for ``max_batch`` lanes of ``max_len`` slots."""

    def __init__(self, max_batch: int, max_len: int):
        if max_batch < 1 or max_len < 2:
            raise ValueError(f"max_batch={max_batch}, max_len={max_len}")
        self.max_batch = max_batch
        self.max_len = max_len
        # engine-installed extra submit gate: callable(req) raising
        # ValueError when the request could never run
        self.feasibility: Callable[[Request], None] | None = None
        self._queue: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._queue)

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
        member's right-aligned extent."""
        out: list[Request] = []
        while self._queue and len(out) < n_free:
            if (page_cost is not None
                    and page_cost(out + [self._queue[0]]) > free_pages):
                break
            out.append(self._queue.popleft())
        return out
