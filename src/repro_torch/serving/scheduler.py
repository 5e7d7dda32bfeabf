"""Admission scheduling for the continuous-batching engine (port of
``repro/serving/scheduler.py``).

Any free lane takes the head request; requests admitted together are
prefilled as one right-aligned group (phased engines) or each at its own
lane's ``offset == 0`` (mixed and prefix-cached engines). Feasibility is
checked once, at ``submit``: the slot gate (the prompt must leave decode
headroom under ``max_len``) plus an engine-installed ``feasibility`` hook
(the paged engine's page-unit check). Paged engines also gate each
admission group on free pages, head of line. The mixed engine spends a
token budget per step: decode tokens first, the rest split into prompt
chunks (``plan_chunks``).

Two schedulers share that contract:

  * ``FIFOScheduler`` — strict submission order, the parity baseline;
  * ``SLAScheduler`` — priority classes, earliest deadline first within
    a class and anti-starvation aging, so interactive traffic never sits
    behind batch jobs and batch jobs never starve.

``clock`` injects the time source of queue stamps, deadlines and aging
(tests pass a fake one).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Iterable

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation request (prompt is a 1-D int32 array).

    ``priority`` is the SLA class, smaller more urgent (0 interactive,
    higher integers batch tiers); FIFO ignores it. ``deadline_s`` is an
    optional target latency from submission: the SLA scheduler orders a
    class by absolute deadline, earliest first, and requests without one
    after them in arrival order."""
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0
    deadline_s: float | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        # provisional: ``submit`` stamps again at enqueue, so queued time
        # measures queue residency, not the object's lifetime
        self.queued_at = time.monotonic()
        self.deadline_at: float | None = None
        self._seq = -1                     # arrival order, set at submit
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
    prefill_chunk``; phased engines ignore it). ``clock`` is the time
    source of queue stamps and deadlines."""

    def __init__(self, max_batch: int, max_len: int,
                 prefill_token_budget: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1 or max_len < 2:
            raise ValueError(f"max_batch={max_batch}, max_len={max_len}")
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget={prefill_token_budget} must be >= 1")
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_token_budget = prefill_token_budget
        self.clock = clock
        # engine-installed extra submit gate: callable(req) raising
        # ValueError when the request could never run
        self.feasibility: Callable[[Request], None] | None = None
        self._queue: deque[Request] = deque()
        self._seq = 0
        # arrival seqs of crash-relaunched requests: far below every fresh
        # arrival (they were admitted once already) but increasing, so
        # they keep their relative order
        self._reinstate_seq = -(1 << 30)
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
        req.queued_at = self.clock()       # stamp at enqueue
        req.deadline_at = (req.queued_at + req.deadline_s
                           if req.deadline_s is not None else None)
        req._seq = self._seq
        self._seq += 1
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

    def remove(self, uid: int) -> Request | None:
        """Pull a queued request out (cancellation); None when ``uid`` is
        not queued."""
        for r in self._queue:
            if r.uid == uid:
                self._queue.remove(r)
                return r
        return None

    def reinstate(self, reqs: list[Request]) -> None:
        """Re-queue crash-relaunched requests at the head, in order,
        without the submit gates (each was feasible when first admitted,
        and a relaunch prompt, prompt + emitted, never outgrows the extent
        proven to fit). ``queued_at`` is now; a request without an
        absolute deadline gets one from now (the caller keeps the
        original ones)."""
        now = self.clock()
        for r in reqs:
            r.queued_at = now
            if r.deadline_at is None and r.deadline_s is not None:
                r.deadline_at = now + r.deadline_s
            if r._seq < 0:
                r._seq = self._reinstate_seq
                self._reinstate_seq += 1
        for r in reversed(reqs):
            self._queue.appendleft(r)

    def extend(self, reqs: Iterable[Request]) -> None:
        for r in reqs:
            self.submit(r)


# conventional SLA classes: any int works, smaller is more urgent
INTERACTIVE = 0
BATCH = 1


class SLAScheduler(FIFOScheduler):
    """Priority-class admission with deadline order and aging.

    At every admission attempt the queue is ordered, stably, by:

      1. **effective class** — ``priority`` minus one for every full
         ``aging_s`` waited, without bound, so a waiting request in the
         end outranks every fresh arrival of every class (a class-``p``
         request is admitted once it has aged ``(p + 1) * aging_s`` past
         the freshest competitor);
      2. **deadline** — earliest absolute deadline first; requests
         without one after them;
      3. **arrival** — submission order.

    The page gate is FIFO's, on the ordered queue: a page-blocked
    interactive head blocks the batch tier behind it (the engine may
    preempt a lower-priority lane to make room). ``aging_s=None`` turns
    aging off (pure class order, starvable)."""

    def __init__(self, max_batch: int, max_len: int,
                 prefill_token_budget: int | None = None,
                 aging_s: float | None = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if aging_s is not None and aging_s <= 0.0:
            raise ValueError(f"aging_s={aging_s} must be > 0")
        super().__init__(max_batch, max_len,
                         prefill_token_budget=prefill_token_budget,
                         clock=clock)
        self.aging_s = aging_s

    def effective_priority(self, req: Request,
                           now: float | None = None) -> int:
        """Class after aging: one level less per full ``aging_s``
        waited."""
        if self.aging_s is None:
            return req.priority
        now = self.clock() if now is None else now
        waited = max(0.0, now - req.queued_at)
        return req.priority - int(waited // self.aging_s)

    def _order(self) -> None:
        now = self.clock()

        def key(r: Request):
            dl = r.deadline_at if r.deadline_at is not None else math.inf
            return (self.effective_priority(r, now), dl, r._seq)

        ordered = sorted(self._queue, key=key)
        self._queue.clear()
        self._queue.extend(ordered)

    def head(self) -> Request | None:
        self._order()
        return super().head()

    def admit(self, n_free: int, free_pages: int | None = None,
              page_cost=None) -> list[Request]:
        self._order()
        return super().admit(n_free, free_pages, page_cost)
