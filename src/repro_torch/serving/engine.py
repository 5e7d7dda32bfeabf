"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

  * **paged KV pool** (default) — K/V live in a shared pool ``(layers,
    n_pages, page_size, KV, hd)`` with a host free list
    (serving/pages.py); each lane maps logical slots to pool pages
    through a ``(max_pages,)`` block table. Attention reads only a lane's
    first ``read_pages`` pages, bucketed to a power of two of the live
    frontier. ``paged=False`` keeps the dense ``(B, max_len)`` slab
    instead: the same slot numbering, rope and masking, so greedy tokens
    are the same;
  * **lanes and per-lane frontiers** — ``max_batch`` batch rows, each
    with its own write position; a finished request frees its lane and
    pages for the next queued one;
  * **phased FIFO admission** (default) — free lanes take the queue
    head, gated on free pages; the group is prefilled right-aligned in
    whole chunks (``W`` = longest prompt, ``offset = W - plen``) while
    running lanes are shielded by the lane mask and wait (counted in
    ``stalled_decode_steps``);
  * **decode slabs** — ``slab_k`` greedy steps on the device per host
    sync (serving/step.py); lanes that stop mid-slab are masked on the
    device and their trailing tokens dropped on the host;
  * **mixed batching** (``mixed=True``, paged only) — prefill rides in
    the decode step under a token budget (``prefill_token_budget``,
    default ``max_batch + prefill_chunk``): running lanes give one decode
    token each, admitting lanes a prompt chunk, in one call
    (``make_mixed_step``), so an arriving prompt never stalls decode.
    Requests are admitted per lane at ``offset == 0``. With no prompt in
    flight the engine runs decode slabs;
  * **prefix cache** (``prefix_cache=True``, paged only) — a radix tree
    over token IDs (serving/prefix_cache.py) shares pool pages between
    requests: a prompt's longest cached prefix goes straight into its
    block table (refcount-pinned, no prefill), a partly shared boundary
    page is copied first (copy-on-write), and only the tail is
    prefilled; finished sequences are inserted back and their pages
    park as cached-idle, reclaimed least recently used first. The
    admission gate counts the effective cost against free plus
    reclaimable pages. Prefix-cached admissions sit at ``offset == 0``
    (sharing is positional), and their tails prefill together through
    the mixed step (phased) or inside the decode steps (mixed).

Greedy decode only (temperature sampling is ``serve_loop``'s).
Preemption and host offload, fault injection, weight hot-swap,
cancellation and the tracer are not ported yet. Everything runs on
``device`` (default the GPU); the CPU serves only when the caller asks
for it, as the tests do.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.serving.pages import PagePool
from repro_torch.serving.prefix_cache import Match, PrefixCache
from repro_torch.serving.scheduler import FIFOScheduler, Request
from repro_torch.serving.step import (make_copy_pages_step,
                                      make_decode_slab_step,
                                      make_mixed_step,
                                      make_paged_decode_slab_step,
                                      make_paged_prefill_chunk_step,
                                      make_prefill_chunk_step)


class LaneFaultError(RuntimeError):
    """A lane's logits went non-finite; only its own request fails."""

    def __init__(self, uid: int, lane: int):
        super().__init__(f"request {uid}: non-finite logits in lane {lane}")
        self.uid, self.lane = uid, lane


@dataclasses.dataclass
class GenResult:
    """Finished request: prompt + generated tokens (greedy). A failed
    request carries its exception in ``error``."""
    uid: int
    prompt: np.ndarray
    generated: np.ndarray
    truncated: bool = False    # hit the lane's slot cap before budget
    ttft_s: float = 0.0        # submit -> first token (monotonic clock)
    error: Exception | None = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([self.prompt, self.generated])


@dataclasses.dataclass
class _Lane:
    req: Request
    offset: int                # left-pad: group width - plen
    generated: list[int]
    pages: list[int] = dataclasses.field(default_factory=list)
    token_times: list[float] = dataclasses.field(default_factory=list)


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clipped to [1, cap]: the paged
    attention read width and the mixed step's query width."""
    return max(1, min(cap, 1 << max(0, (n - 1).bit_length())))


_COUNTERS = (
    "prefill_chunks", "prefill_tokens", "decode_slabs", "decode_steps",
    "decode_tokens", "generated_tokens", "prefill_s", "decode_s",
    "admitted", "evicted", "truncated", "lanes_quarantined",
    # mixed batching: fused calls, their time, and blocking prefill calls
    # that ran while live decode lanes waited (0 when mixed)
    "mixed_steps", "mixed_s", "stalled_decode_steps",
    # paged attention reads (page units) against a dense max_len read
    "pages_read", "pages_read_dense_equiv",
    # prefix cache: prompt tokens submitted, radix hits and misses, the
    # prompt tokens shared pages covered, boundary-page copies, and
    # cached-idle pages reclaimed under pressure
    "prompt_tokens", "prefix_hits", "prefix_misses",
    "prefill_tokens_skipped", "cow_copies", "cache_evicted_pages")


class Engine:
    """Continuous-batching greedy generation over pruned/packed weights.

    >>> eng = Engine(cfg, params, max_batch=8, max_len=512)
    >>> uid = eng.submit(prompt_ids, max_new_tokens=64)
    >>> results = eng.run()          # {uid: GenResult}

    ``params`` must already lie on ``device``. ``slab_k`` decode steps
    run per host sync; ``n_pages`` defaults to ``max_batch`` lanes of
    ``max_len`` slots. ``paged``, ``mixed`` and ``prefix_cache`` pick
    the cache layout and admission policy (module docstring)."""

    def __init__(self, cfg, params, *, max_batch: int, max_len: int,
                 prefill_chunk: int = 16, slab_k: int = 8,
                 eos_id: int | None = None, paged: bool = True,
                 page_size: int = 16, n_pages: int | None = None,
                 prefix_cache: bool = False, mixed: bool = False,
                 prefill_token_budget: int | None = None, device="cuda"):
        if not registry.supports_prefill_chunk(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} is not servable by the engine; "
                "use serve_loop.generate")
        if paged and not registry.supports_paged(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} has no paged KV cache; pass "
                "paged=False")
        if prefix_cache and not paged:
            raise ValueError("prefix_cache=True requires paged=True "
                             "(pages are the unit of sharing)")
        if mixed and not paged:
            raise ValueError("mixed=True requires paged=True (the mixed "
                             "step writes per-lane query runs through "
                             "block tables)")
        if mixed and not registry.supports_mixed(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} has no mixed decode+prefill step")
        if slab_k < 1:
            raise ValueError(f"slab_k={slab_k} must be >= 1")
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.chunk = max(1, min(prefill_chunk, max_len))
        self.slab_k = slab_k
        self.eos_id = eos_id
        self.paged = paged
        self.mixed = mixed
        self.scheduler = FIFOScheduler(
            max_batch, max_len,
            prefill_token_budget=(max_batch + self.chunk
                                  if prefill_token_budget is None
                                  else prefill_token_budget))
        # lanes whose prompt is still being prefilled across calls:
        # lane -> next prompt position, in admission order
        self._prefilling: dict[int, int] = {}
        self.lanes: list[_Lane | None] = [None] * max_batch
        # host mirror of the per-lane device state; uploaded only after
        # admission or eviction edits it (self._dirty)
        self._mirror = {
            "pending": np.zeros(max_batch, np.int32),
            "frontier": np.zeros(max_batch, np.int32),
            "offsets": np.zeros(max_batch, np.int32),
            "remaining": np.zeros(max_batch, np.int32),
            "live": np.zeros(max_batch, bool),
            "faulted": np.zeros(max_batch, bool),
        }
        self.pcache: PrefixCache | None = None
        self.pool: PagePool | None = None
        if paged:
            self.page_size = page_size
            per_lane = -(-max_len // page_size)
            self.n_pages = (max_batch * per_lane if n_pages is None
                            else n_pages)
            self.max_pages = min(per_lane, self.n_pages)
            self.pool = PagePool(self.n_pages, page_size)
            self.cache = registry.init_paged_cache(
                cfg, self.n_pages, page_size, device=self.device)
            if prefix_cache:
                self.pcache = PrefixCache(self.pool)
                self._copy_pages = make_copy_pages_step()
            self._mirror["bt"] = np.zeros((max_batch, self.max_pages),
                                          np.int32)
            self.scheduler.feasibility = self._check_feasible
            self._prefill = make_paged_prefill_chunk_step(cfg)
            # one fused decode+prefill call (mixed steps, and the phased
            # engine's batched tail prefill of prefix-cached admissions)
            self._mixed_fn = make_mixed_step(cfg)
            # query-width bucket cap: smallest power of two >= chunk
            self._wcap = 1 << max(0, (self.chunk - 1).bit_length())
            self._slab = make_paged_decode_slab_step(
                cfg, slab_k, max_len, page_size, eos_id=eos_id)
        else:
            self.cache = registry.init_cache(cfg, max_batch, max_len,
                                             device=self.device)
            self._prefill = make_prefill_chunk_step(cfg)
            self._slab = make_decode_slab_step(cfg, slab_k, max_len,
                                               eos_id=eos_id)
        self._dstate: dict[str, torch.Tensor] | None = None
        self._dirty = True
        self._uid = 0
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats: dict = {k: 0 for k in _COUNTERS}
        self._ttft: list[float] = []
        self.scheduler.reset_stats()
        if self.pool is not None:
            self.pool.reset_peaks()

    # ------------------------------------------------------------ memory
    @property
    def page_bytes(self) -> int:
        """Bytes of ONE pool page across all layers, K+V."""
        k = self.cache["k"]
        return (2 * k.shape[0] * self.page_size * k.shape[-2] * k.shape[-1]
                * k.element_size())

    @property
    def kv_bytes_peak(self) -> int:
        """Peak bytes of live KV: pages occupied at once (paged) or the
        whole slab (contiguous)."""
        if self.paged:
            return self.pool.peak_in_use * self.page_bytes
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    @property
    def kv_bytes_contiguous_equiv(self) -> int:
        """What a dense (max_batch, max_len) cache of this model holds."""
        k = self.cache["k"]
        return (2 * k.shape[0] * self.max_batch * self.max_len * k.shape[-2]
                * k.shape[-1] * k.element_size())

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: int = 32,
               uid: int | None = None) -> int:
        """Queue one request; infeasible ones raise ValueError here."""
        uid = self._uid if uid is None else uid
        self._uid = max(self._uid, uid) + 1
        self.scheduler.submit(Request(uid, np.asarray(prompt),
                                      max_new_tokens))
        return uid

    def _check_feasible(self, req: Request) -> None:
        need = self._page_cost([req])
        if need > self.n_pages:
            raise ValueError(
                f"oversized request: prompt of {req.prompt_len} tokens + "
                f"budget of {req.max_new_tokens} new tokens needs {need} "
                f"pages ({self.page_size} slots each) even admitted alone, "
                f"but the pool holds only {self.n_pages} pages")

    def _page_cost(self, group: list[Request]) -> int:
        """Pages a tentative group pins: it prefills right-aligned to the
        longest member, so each lane's extent is ``min(W + budget - 1,
        max_len)`` slots (never fewer than the W prefill writes)."""
        w = max(r.prompt_len for r in group)
        return sum(self.pool.slots_for(
            min(max(w + r.max_new_tokens - 1, w), self.max_len))
            for r in group)

    def _effective_match(self, r: Request) -> tuple[Match, int]:
        """Radix match for admission, with the copy-on-write tail dropped
        when the request's extent fills the whole pool (the copy needs the
        shared original and the private copy at once, extent + 1 pages,
        which such a request could never pin). Returns (match, extent
        pages); a lane at offset 0 has its own prompt as group width."""
        m = self.pcache.match(r.prompt)
        extent = self._page_cost([r])
        if m.tail_page is not None and extent >= self.n_pages:
            m = Match(m.pages, len(m.pages) * self.page_size)
        return m, extent

    def _page_cost_shared(self):
        """The effective page-cost gate of prefix-cached admission, held
        against free + reclaimable pages: shared pages cost nothing new,
        but matched pages that are cached-idle count once (pinning them
        makes them unreclaimable). Memoizes each request's match over the
        scheduler's growing trial groups."""
        memo: dict[int, tuple[int, list[int]]] = {}

        def per_request(r: Request) -> tuple[int, list[int]]:
            if id(r) not in memo:
                m, extent = self._effective_match(r)
                pinned = m.pages + ([m.tail_page]
                                    if m.tail_page is not None else [])
                memo[id(r)] = (
                    extent - len(m.pages),
                    [p for p in pinned if self.pool.refcount(p) == 0])
            return memo[id(r)]

        def cost(group: list[Request]) -> int:
            new_pages = 0
            idle_matched: set[int] = set()
            for r in group:
                new, idle = per_request(r)
                new_pages += new
                idle_matched.update(idle)
            return new_pages + len(idle_matched)
        return cost

    # ------------------------------------------------------- lane helpers
    @property
    def active_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l is not None]

    @property
    def frontiers(self) -> np.ndarray:
        """(max_batch,) per-lane cache-slot write positions."""
        return self._mirror["frontier"].copy()

    @property
    def block_tables(self) -> np.ndarray:
        """(max_batch, max_pages) logical page -> pool page (paged)."""
        return self._mirror["bt"].copy()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """Upload a host array. On the GPU through a pinned copy and an
        asynchronous transfer: a blocking upload waits for every kernel
        already queued (a host sync)."""
        if self.device.type != "cuda":
            return torch.tensor(a, device=self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            self.device, non_blocking=True)

    def _sync_dstate(self) -> None:
        if self._dirty:
            self._dstate = {k: self._tensor(v)
                            for k, v in self._mirror.items()}
            self._dirty = False

    def _finish(self, i: int, truncated: bool = False) -> GenResult:
        lane = self.lanes[i]
        self.lanes[i] = None
        self._mirror["live"][i] = False
        if self.paged and lane.pages:
            if self.pcache is not None and lane.offset == 0:
                # insert-on-finish: donate the pages covering every slot
                # the lane wrote, prompt and continuation (offset 0: slot
                # s holds token s); they park as cached-idle on release
                frontier = int(self._mirror["frontier"][i])
                seq = np.concatenate(
                    [lane.req.prompt,
                     np.asarray(lane.generated, np.int32)])[:frontier]
                self.pcache.insert(
                    seq, lane.pages[:self.pool.slots_for(frontier)])
            self.pool.release(lane.pages)
            self._mirror["bt"][i] = 0
        self._dirty = True
        self.stats["evicted"] += 1
        self.stats["truncated"] += int(truncated)
        tt = lane.token_times
        ttft = max(0.0, tt[0] - lane.req.queued_at) if tt else 0.0
        self._ttft.append(ttft)
        return GenResult(lane.req.uid, lane.req.prompt,
                         np.asarray(lane.generated, np.int32), truncated,
                         ttft_s=ttft)

    def _harvest_faults(self, finished: list[GenResult]) -> None:
        """Fail every lane the device-side finite check flagged (never
        donating its pages to the prefix cache); the other lanes' streams
        are untouched."""
        m = self._mirror
        for i in self.active_lanes:
            if m["faulted"][i]:
                lane = self.lanes[i]
                self.lanes[i] = None
                m["live"][i] = False
                m["faulted"][i] = False
                if self.paged:
                    self.pool.release(lane.pages)
                    m["bt"][i] = 0
                self._prefilling.pop(i, None)
                self._dirty = True
                self.stats["evicted"] += 1
                self.stats["lanes_quarantined"] += 1
                finished.append(GenResult(
                    lane.req.uid, lane.req.prompt,
                    np.asarray(lane.generated, np.int32),
                    error=LaneFaultError(lane.req.uid, i)))

    # --------------------------------------------------------- admission
    def _admit_once(self) -> None:
        free = [i for i, l in enumerate(self.lanes) if l is None]
        if self.pcache is not None:
            self._admit_shared(free)
            return
        if self.mixed:
            self._admit_mixed(free)
            return
        if self.paged:
            reqs = self.scheduler.admit(len(free), self.pool.free_pages,
                                        self._page_cost)
        else:
            reqs = self.scheduler.admit(len(free))
        if not reqs:
            return
        m = self._mirror
        # the group prefills right-aligned in slots [0, W): a lane freed
        # mid-traffic restarts at slot 0
        width = max(r.prompt_len for r in reqs)
        new_lanes = []
        for r in reqs:
            i = free.pop(0)
            off = width - r.prompt_len
            self.lanes[i] = _Lane(r, off, [])
            if self.paged:
                need = self.pool.slots_for(
                    min(max(width + r.max_new_tokens - 1, width),
                        self.max_len))
                self.lanes[i].pages = self.pool.alloc(need)
                m["bt"][i] = 0
                m["bt"][i, :need] = self.lanes[i].pages
            m["offsets"][i] = off
            m["frontier"][i] = width
            m["remaining"][i] = r.max_new_tokens - 1
            m["pending"][i] = 0
            m["live"][i] = True
            new_lanes.append(i)
        self._dirty = True
        self.stats["admitted"] += len(reqs)
        tokens = np.zeros((self.max_batch, width), np.int32)
        for i in new_lanes:
            p = self.lanes[i].req.prompt
            tokens[i, width - p.size:] = p
        self._run_prefill(new_lanes, tokens, width)
        self.stats["prefill_tokens"] += sum(r.prompt_len for r in reqs)
        self.stats["prompt_tokens"] += sum(r.prompt_len for r in reqs)

    def _run_prefill(self, lane_ids: list[int], tokens: np.ndarray,
                     cover_slots: int) -> None:
        """Run ``tokens`` (max_batch, W) through the prefill step in whole
        chunks (the first ``W % chunk`` wide, the rest ``chunk``), lanes
        outside ``lane_ids`` shielded by the lane mask, then fold each
        lane's FIRST generated token into the mirror. Every call stalls
        the other live lanes' decode (counted)."""
        width = tokens.shape[1]
        lane_mask = np.zeros((self.max_batch,), bool)
        lane_mask[lane_ids] = True
        offsets = self._tensor(self._mirror["offsets"])
        mask_t = self._tensor(lane_mask)
        toks = self._tensor(tokens)
        if self.paged:
            bt = self._tensor(self._mirror["bt"])
            r_pf = _pow2_bucket(self.pool.slots_for(cover_slots),
                                self.max_pages)
        rem = width % self.chunk
        sizes = ([rem] if rem else []) + [self.chunk] * (width // self.chunk)
        if any(self._mirror["live"][j] for j in self.active_lanes
               if not lane_mask[j]):
            self.stats["stalled_decode_steps"] += len(sizes)
        t0 = time.monotonic()
        last, pos = None, 0
        for c in sizes:
            if self.paged:
                last, self.cache = self._prefill(
                    self.params, self.cache, toks[:, pos:pos + c], pos,
                    offsets, mask_t, bt, read_pages=r_pf)
                self.stats["pages_read"] += r_pf * len(lane_ids) * c
                self.stats["pages_read_dense_equiv"] += (
                    self.pool.slots_for(self.max_len) * len(lane_ids) * c)
            else:
                last, self.cache = self._prefill(
                    self.params, self.cache, toks[:, pos:pos + c], pos,
                    offsets, mask_t)
            pos += c
            self.stats["prefill_chunks"] += 1
        first = torch.argmax(last, dim=-1).cpu().numpy()   # host sync
        now = time.monotonic()
        self.stats["prefill_s"] += now - t0
        for i in lane_ids:
            self._mirror["pending"][i] = int(first[i])
            self.lanes[i].generated.append(int(first[i]))
            self.lanes[i].token_times.append(now)
            self.stats["generated_tokens"] += 1

    def _admit_mixed(self, free: list[int]) -> None:
        """Chunk-granular admission (``mixed=True``, no prefix cache):
        each request takes a lane at ``offset == 0``, pins pages for its
        own extent and joins ``_prefilling``; the mixed step feeds its
        prompt chunk by chunk under the token budget."""
        reqs = self.scheduler.admit(
            len(free), self.pool.free_pages,
            lambda group: sum(self._page_cost([r]) for r in group))
        m = self._mirror
        for r in reqs:
            i = free.pop(0)
            need = self._page_cost([r])
            self.lanes[i] = _Lane(r, 0, [], pages=self.pool.alloc(need))
            m["bt"][i] = 0
            m["bt"][i, :need] = self.lanes[i].pages
            m["offsets"][i] = 0
            m["frontier"][i] = r.prompt_len
            m["remaining"][i] = r.max_new_tokens - 1
            m["pending"][i] = 0
            m["live"][i] = False          # decodable once the tail lands
            self._prefilling[i] = 0
            self.stats["prompt_tokens"] += r.prompt_len
        if reqs:
            self._dirty = True
            self.stats["admitted"] += len(reqs)

    def _admit_shared(self, free: list[int]) -> None:
        """Prefix-cached admission: the gate sees the effective page cost
        against free + reclaimable pages, and each request takes its own
        lane at ``offset == 0``. A request whose re-checked match no
        longer fits (an eviction within this round) goes back to the
        queue head. The tails of this round's admissions prefill
        together (phased) or inside the decode steps (mixed)."""
        avail = self.pool.free_pages + self.pcache.reclaimable()
        reqs = self.scheduler.admit(len(free), avail,
                                    self._page_cost_shared())
        tails: list[int] = []
        for j, r in enumerate(reqs):
            if not self._admit_one(free[0], r):
                self.scheduler.push_front(reqs[j:])
                break
            tails.append(free.pop(0))
            self.stats["admitted"] += 1
        if not self.mixed and tails:
            self._prefill_tails(tails)

    def _admit_one(self, i: int, r: Request) -> bool:
        """match -> pin the shared pages -> evict for room -> alloc own
        pages -> copy the boundary page -> register the tail prefill.
        False when the pool cannot cover the request (nothing held; an
        eviction already made is not undone)."""
        m, extent = self._effective_match(r)
        # pin everything matched before eviction or allocation can touch
        # it: the tail page until its copy lands, the full pages for the
        # lane's lifetime
        pin_tail = [m.tail_page] if m.tail_page is not None else []
        self.pool.retain(m.pages + pin_tail)
        own_need = extent - len(m.pages)
        short = own_need - self.pool.free_pages
        if short > 0:
            self.stats["cache_evicted_pages"] += self.pcache.evict(short)
        if own_need > self.pool.free_pages:
            self.pool.release(m.pages + pin_tail)
            return False
        own = self.pool.alloc(own_need)
        if m.tail_page is not None:
            # copy-on-write: the lane goes on writing this page, so it
            # gets a private copy; the shared original stays read-only
            self.cache = self._copy_pages(
                self.cache, self._tensor(np.asarray([m.tail_page], np.int32)),
                self._tensor(np.asarray([own[0]], np.int32)))
            self.pool.release(pin_tail)
            self.stats["cow_copies"] += 1
        pages = m.pages + own           # logical page order
        self.lanes[i] = _Lane(r, 0, [], pages=pages)
        mir = self._mirror
        mir["bt"][i] = 0
        mir["bt"][i, :len(pages)] = pages
        mir["offsets"][i] = 0
        mir["frontier"][i] = r.prompt_len
        mir["remaining"][i] = r.max_new_tokens - 1
        mir["pending"][i] = 0
        mir["live"][i] = False        # decodable once the tail lands
        self._prefilling[i] = m.matched_tokens
        self._dirty = True
        self.stats["prompt_tokens"] += r.prompt_len
        self.stats["prefix_hits"] += int(m.matched_tokens > 0)
        self.stats["prefix_misses"] += int(m.matched_tokens == 0)
        self.stats["prefill_tokens_skipped"] += m.matched_tokens
        return True

    def _prefill_tails(self, lane_ids: list[int]) -> None:
        """Phased prefill of prefix-cached tails: every lane admitted this
        round advances one chunk per mixed-step call until its tail has
        landed. Running decode lanes wait (counted)."""
        while any(i in self._prefilling for i in lane_ids):
            plan = {i: min(self.lanes[i].req.prompt_len
                           - self._prefilling[i], self.chunk)
                    for i in lane_ids if i in self._prefilling}
            self._mixed_call([], plan)

    def _sweep_finished(self, finished: list[GenResult]) -> None:
        """Evict lanes whose budget is spent, that emitted eos, or that
        ran out of cache slots."""
        m = self._mirror
        for i in self.active_lanes:
            lane = self.lanes[i]
            done = (len(lane.generated) >= lane.req.max_new_tokens or
                    (self.eos_id is not None and lane.generated and
                     lane.generated[-1] == self.eos_id))
            if done:
                finished.append(self._finish(i))
            elif m["frontier"][i] >= self.max_len:
                finished.append(self._finish(i, truncated=True))

    # --------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> list[GenResult]:
        """One engine iteration. Phased: evict, admit (blocking on the new
        prompts' whole prefill), then one decode slab. Mixed: evict, admit
        (non-blocking), then one fused decode+prefill call when the token
        budget planned prompt chunks, else a decode slab. Returns the
        requests finished during this step."""
        finished: list[GenResult] = []
        self._sweep_finished(finished)
        self._admit_once()
        self._sweep_finished(finished)   # e.g. max_new_tokens == 1
        if self.mixed:
            decode_lanes = [i for i in self.active_lanes
                            if self._mirror["live"][i]]
            tails = [(i, self.lanes[i].req.prompt_len - pos)
                     for i, pos in self._prefilling.items()]
            plan = self.scheduler.plan_chunks(tails, len(decode_lanes),
                                              self.chunk)
            if plan:
                self._mixed_call(decode_lanes, plan)
            elif decode_lanes:
                self._decode_slab()
        elif self.active_lanes:
            self._decode_slab()
        self._harvest_faults(finished)
        return finished

    def _decode_slab(self) -> None:
        """One slab of ``slab_k`` device-side decode steps, one host
        sync; paged, it reads ``read_pages`` = the power-of-two bucket
        covering every lane's frontier + slab_k."""
        self._sync_dstate()
        lanes = self.active_lanes
        t0 = time.monotonic()
        if self.paged:
            fmax = int(max(self._mirror["frontier"][i] for i in lanes))
            need = min(fmax + self.slab_k, self.max_len)
            r = _pow2_bucket(self.pool.slots_for(need), self.max_pages)
            block, self._dstate, self.cache = self._slab(
                self.params, self.cache, self._dstate, read_pages=r)
            n = len(lanes) * self.slab_k
            self.stats["pages_read"] += r * n
            self.stats["pages_read_dense_equiv"] += (
                self.pool.slots_for(self.max_len) * n)
        else:
            block, self._dstate, self.cache = self._slab(
                self.params, self.cache, self._dstate)
        block = block.cpu().numpy()                        # host sync
        now = time.monotonic()
        self.stats["decode_s"] += now - t0
        self.stats["decode_slabs"] += 1
        self.stats["decode_steps"] += self.slab_k
        self._replay(block, now)

    def _mixed_call(self, decode_lanes: list[int],
                    plan: dict[int, int]) -> None:
        """One fused decode+prefill call: decode lanes give one token each
        (q_len 1 at their frontier), ``plan`` lanes a prompt chunk (q_len c
        at their prefill position), padded to a power-of-two width. The
        host folds the next tokens: decode lanes advance with the slab's
        stop logic, prefill lanes advance their prompt position and go
        live when the tail lands (their token is the request's first).
        The host reads the result only when some lane emits a token, so
        calls that carry only mid-prompt chunks queue without a sync.
        With no decode lane (the phased tail prefill) the call time is
        prefill time."""
        m = self._mirror
        w = _pow2_bucket(max(plan.values(), default=1), self._wcap)
        tokens = np.zeros((self.max_batch, w), np.int32)
        starts = np.zeros(self.max_batch, np.int32)
        q_lens = np.zeros(self.max_batch, np.int32)
        need = 1
        for i in decode_lanes:
            tokens[i, 0] = m["pending"][i]
            starts[i] = m["frontier"][i]
            q_lens[i] = 1
            need = max(need, int(m["frontier"][i]) + 1)
        for i, c in plan.items():
            pos = self._prefilling[i]
            tokens[i, :c] = self.lanes[i].req.prompt[pos:pos + c]
            starts[i] = pos
            q_lens[i] = c
            need = max(need, pos + c)
        covered = set(decode_lanes) | set(plan)
        if plan and any(m["live"][j] for j in self.active_lanes
                        if j not in covered):
            self.stats["stalled_decode_steps"] += 1
        r = _pow2_bucket(self.pool.slots_for(need), self.max_pages)
        t0 = time.monotonic()
        nxt, faulted, self.cache = self._mixed_fn(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(starts), self._tensor(q_lens),
            self._tensor(m["offsets"]), self._tensor(m["bt"]),
            read_pages=r)
        fa = None
        if decode_lanes or any(self._prefilling[i] + c
                               >= self.lanes[i].req.prompt_len
                               for i, c in plan.items()):
            nxt = nxt.cpu().numpy()                        # host sync
            fa = faulted.cpu().numpy()
        now = time.monotonic()
        if self.mixed:
            self.stats["mixed_steps"] += 1
        if decode_lanes:
            self.stats["mixed_s"] += now - t0
            self.stats["decode_steps"] += 1
        else:
            self.stats["prefill_s"] += now - t0
        n_tok = len(decode_lanes) + sum(plan.values())
        self.stats["pages_read"] += r * n_tok
        self.stats["pages_read_dense_equiv"] += (
            self.pool.slots_for(self.max_len) * n_tok)
        if plan:
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += sum(plan.values())
        for i in decode_lanes:
            if fa[i]:
                # non-finite logits: the lane freezes and
                # _harvest_faults fails its request
                m["faulted"][i] = True
                m["live"][i] = False
                continue
            t = int(nxt[i])
            self.lanes[i].generated.append(t)
            self.lanes[i].token_times.append(now)
            m["pending"][i] = t
            m["frontier"][i] += 1
            m["remaining"][i] -= 1
            if (m["remaining"][i] <= 0 or m["frontier"][i] >= self.max_len
                    or (self.eos_id is not None and t == self.eos_id)):
                m["live"][i] = False     # the slab's stop rule
            self.stats["generated_tokens"] += 1
            self.stats["decode_tokens"] += 1
        for i, c in plan.items():
            pos = self._prefilling[i] + c
            if pos < self.lanes[i].req.prompt_len:
                self._prefilling[i] = pos
                continue
            del self._prefilling[i]      # tail landed: first token out
            if fa[i]:
                m["faulted"][i] = True
                continue
            first = int(nxt[i])
            self.lanes[i].generated.append(first)
            self.lanes[i].token_times.append(now)
            m["pending"][i] = first
            m["live"][i] = True
            self.stats["generated_tokens"] += 1
        self._dirty = True

    def _replay(self, block: np.ndarray, now: float) -> None:
        """Fold a slab's tokens into the host mirror using the state the
        slab returned: lane i kept ``new_frontier - old_frontier``
        tokens; anything after its stop point is dropped."""
        new = {k: v.cpu().numpy().copy() for k, v in self._dstate.items()}
        for i in self.active_lanes:
            kept = int(new["frontier"][i] - self._mirror["frontier"][i])
            self.lanes[i].generated.extend(int(t) for t in block[i, :kept])
            self.lanes[i].token_times.extend([now] * kept)
            self.stats["generated_tokens"] += kept
            self.stats["decode_tokens"] += kept
        self._mirror = new

    # ---------------------------------------------------------------- run
    def run(self) -> dict[int, GenResult]:
        """Drain the queue and all active lanes; {uid: GenResult}."""
        out: dict[int, GenResult] = {}
        while len(self.scheduler) or self.active_lanes:
            for r in self.step():
                out[r.uid] = r
        self.finalize_stats()
        return out

    def finalize_stats(self) -> dict:
        """Fold the counters into derived stats: decode throughput (decode
        tokens over decode time, fused mixed calls included), TTFT
        percentiles, KV peaks and the prefix-cache hit rate."""
        st = self.stats
        dec_s = st["decode_s"] + st["mixed_s"]
        st["tok_per_s"] = st["decode_tokens"] / dec_s if dec_s > 0 else 0.0
        arr = np.asarray(self._ttft, np.float64)
        for q in (50, 95):
            st[f"ttft_p{q}_s"] = (float(np.percentile(arr, q))
                                  if arr.size else 0.0)
        if self.paged:
            st["peak_kv_pages"] = self.pool.peak_in_use
            # pages live lanes pin at once, shared pages counted once
            st["peak_kv_bytes_referenced"] = (self.pool.peak_referenced
                                              * self.page_bytes)
        st["peak_kv_bytes"] = self.kv_bytes_peak
        st["kv_bytes_contiguous_equiv"] = self.kv_bytes_contiguous_equiv
        st["admission_rejections"] = self.scheduler.rejections
        st["admission_rejected_steps"] = self.scheduler.rejected_steps
        if self.pcache is not None:
            st["prefix_hit_rate"] = (st["prefill_tokens_skipped"]
                                     / max(1, st["prompt_tokens"]))
            st["cached_pages"] = self.pool.cached_pages
        return st


def generate(cfg, params, prompts, *, max_new_tokens: int = 32,
             max_len: int | None = None, eos_id: int | None = None,
             prefill_chunk: int = 16, slab_k: int = 8,
             max_batch: int | None = None, paged: bool = True,
             page_size: int = 16, n_pages: int | None = None,
             prefix_cache: bool = False, mixed: bool = False,
             prefill_token_budget: int | None = None, device="cuda"):
    """Ragged 1-D prompts -> (list of per-request token arrays, stats).
    A request that runs out of cache returns fewer than
    ``max_new_tokens`` tokens (``stats["truncated"]`` counts them)."""
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    max_len = max_len or (max(p.size for p in prompts) + max_new_tokens)
    eng = Engine(cfg, params, max_batch=max_batch or len(prompts),
                 max_len=max_len, prefill_chunk=prefill_chunk,
                 slab_k=slab_k, eos_id=eos_id, paged=paged,
                 page_size=page_size, n_pages=n_pages,
                 prefix_cache=prefix_cache, mixed=mixed,
                 prefill_token_budget=prefill_token_budget, device=device)
    uids = [eng.submit(p, max_new_tokens) for p in prompts]
    res = eng.run()
    return [res[u].tokens for u in uids], eng.stats
