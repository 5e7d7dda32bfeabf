"""Continuous-batching serving engine over the paged KV pool (port of
the phased, paged path of ``repro/serving/engine.py``).

  * **paged KV pool** — K/V live in a shared pool ``(layers, n_pages,
    page_size, KV, hd)`` with a host free list (serving/pages.py); each
    lane maps logical slots to pool pages through a ``(max_pages,)``
    block table. Attention reads only a lane's first ``read_pages``
    pages, bucketed to a power of two of the live frontier;
  * **lanes and per-lane frontiers** — ``max_batch`` batch rows, each
    with its own write position; a finished request frees its lane and
    pages for the next queued one;
  * **phased FIFO admission** — free lanes take the queue head, gated on
    free pages; the group is prefilled right-aligned in whole chunks
    (``W`` = longest prompt, ``offset = W - plen``) while running lanes
    are shielded by the lane mask and wait;
  * **decode slabs** — ``slab_k`` greedy steps on the device per host
    sync (serving/step.py); lanes that stop mid-slab are masked on the
    device and their trailing tokens dropped on the host.

Greedy decode only. The prefix cache, mixed batching, preemption and
offload, faults, hot-swap, cancellation and the tracer are not ported
yet. Everything runs on ``device`` (default the GPU); the CPU serves only
when the caller asks for it, as the tests do.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.serving.pages import PagePool
from repro_torch.serving.scheduler import FIFOScheduler, Request
from repro_torch.serving.step import (make_paged_decode_slab_step,
                                      make_paged_prefill_chunk_step)


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
    attention read width."""
    return max(1, min(cap, 1 << max(0, (n - 1).bit_length())))


_COUNTERS = ("prefill_chunks", "prefill_tokens", "decode_slabs",
             "decode_steps", "decode_tokens", "generated_tokens",
             "prefill_s", "decode_s", "admitted", "evicted", "truncated",
             "lanes_quarantined")


class Engine:
    """Continuous-batching greedy generation over pruned/packed weights.

    >>> eng = Engine(cfg, params, max_batch=8, max_len=512)
    >>> uid = eng.submit(prompt_ids, max_new_tokens=64)
    >>> results = eng.run()          # {uid: GenResult}

    ``params`` must already lie on ``device``. ``slab_k`` decode steps
    run per host sync; ``n_pages`` defaults to ``max_batch`` lanes of
    ``max_len`` slots."""

    def __init__(self, cfg, params, *, max_batch: int, max_len: int,
                 prefill_chunk: int = 16, slab_k: int = 8,
                 eos_id: int | None = None, page_size: int = 16,
                 n_pages: int | None = None, device="cuda"):
        if not registry.supports_paged(cfg):
            raise NotImplementedError(
                f"family {cfg.family!r} has no paged KV cache in the port")
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
        self.page_size = page_size
        per_lane = -(-max_len // page_size)
        self.n_pages = max_batch * per_lane if n_pages is None else n_pages
        self.max_pages = min(per_lane, self.n_pages)
        self.pool = PagePool(self.n_pages, page_size)
        self.cache = registry.init_paged_cache(cfg, self.n_pages, page_size,
                                               device=self.device)
        self.scheduler = FIFOScheduler(max_batch, max_len)
        self.scheduler.feasibility = self._check_feasible
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
            "bt": np.zeros((max_batch, self.max_pages), np.int32),
        }
        self._prefill = make_paged_prefill_chunk_step(cfg)
        self._slab = make_paged_decode_slab_step(cfg, slab_k, max_len,
                                                 page_size, eos_id=eos_id)
        self._dstate: dict[str, torch.Tensor] | None = None
        self._dirty = True
        self._uid = 0
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats: dict = {k: 0 for k in _COUNTERS}
        self._ttft: list[float] = []
        self.pool.reset_peaks()

    # ------------------------------------------------------------ memory
    @property
    def page_bytes(self) -> int:
        """Bytes of ONE pool page across all layers, K+V."""
        k = self.cache["k"]
        return (2 * k.shape[0] * self.page_size * k.shape[-2] * k.shape[-1]
                * k.element_size())

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

    # ------------------------------------------------------- lane helpers
    @property
    def active_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l is not None]

    @property
    def block_tables(self) -> np.ndarray:
        """(max_batch, max_pages) logical page -> pool page."""
        return self._mirror["bt"].copy()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def _sync_dstate(self) -> None:
        if self._dirty:
            self._dstate = {k: self._tensor(v)
                            for k, v in self._mirror.items()}
            self._dirty = False

    def _finish(self, i: int, truncated: bool = False) -> GenResult:
        lane = self.lanes[i]
        self.lanes[i] = None
        self._mirror["live"][i] = False
        if lane.pages:
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
        """Fail every lane the device-side finite check flagged; the
        other lanes' streams are untouched."""
        m = self._mirror
        for i in self.active_lanes:
            if m["faulted"][i]:
                lane = self.lanes[i]
                self.lanes[i] = None
                m["live"][i] = False
                m["faulted"][i] = False
                self.pool.release(lane.pages)
                m["bt"][i] = 0
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
        reqs = self.scheduler.admit(len(free), self.pool.free_pages,
                                    self._page_cost)
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
            need = self.pool.slots_for(
                min(max(width + r.max_new_tokens - 1, width), self.max_len))
            self.lanes[i] = _Lane(r, off, [], pages=self.pool.alloc(need))
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

    def _run_prefill(self, lane_ids: list[int], tokens: np.ndarray,
                     cover_slots: int) -> None:
        """Run ``tokens`` (max_batch, W) through the prefill step in whole
        chunks (the first ``W % chunk`` wide, the rest ``chunk``), lanes
        outside ``lane_ids`` shielded by the lane mask, then fold each
        lane's FIRST generated token into the mirror."""
        width = tokens.shape[1]
        lane_mask = np.zeros((self.max_batch,), bool)
        lane_mask[lane_ids] = True
        offsets = self._tensor(self._mirror["offsets"])
        mask_t = self._tensor(lane_mask)
        toks = self._tensor(tokens)
        bt = self._tensor(self._mirror["bt"])
        r_pf = _pow2_bucket(self.pool.slots_for(cover_slots),
                            self.max_pages)
        rem = width % self.chunk
        sizes = ([rem] if rem else []) + [self.chunk] * (width // self.chunk)
        t0 = time.monotonic()
        last, pos = None, 0
        for c in sizes:
            last, self.cache = self._prefill(
                self.params, self.cache, toks[:, pos:pos + c], pos, offsets,
                mask_t, bt, read_pages=r_pf)
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
        """One engine iteration: evict, admit (blocking on the new
        prompts' whole prefill), then one decode slab. Returns the
        requests finished during this step."""
        finished: list[GenResult] = []
        self._sweep_finished(finished)
        self._admit_once()
        self._sweep_finished(finished)   # e.g. max_new_tokens == 1
        if self.active_lanes:
            self._decode_slab()
        self._harvest_faults(finished)
        return finished

    def _decode_slab(self) -> None:
        """One slab of ``slab_k`` device-side decode steps, one host
        sync, reading ``read_pages`` = the power-of-two bucket covering
        every lane's frontier + slab_k."""
        self._sync_dstate()
        lanes = self.active_lanes
        t0 = time.monotonic()
        fmax = int(max(self._mirror["frontier"][i] for i in lanes))
        need = min(fmax + self.slab_k, self.max_len)
        r = _pow2_bucket(self.pool.slots_for(need), self.max_pages)
        block, self._dstate, self.cache = self._slab(
            self.params, self.cache, self._dstate, read_pages=r)
        block = block.cpu().numpy()                        # host sync
        now = time.monotonic()
        self.stats["decode_s"] += now - t0
        self.stats["decode_slabs"] += 1
        self.stats["decode_steps"] += self.slab_k
        self._replay(block, now)

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
        tokens over decode time), TTFT percentiles and KV peaks."""
        st = self.stats
        st["tok_per_s"] = (st["decode_tokens"] / st["decode_s"]
                           if st["decode_s"] > 0 else 0.0)
        arr = np.asarray(self._ttft, np.float64)
        for q in (50, 95):
            st[f"ttft_p{q}_s"] = (float(np.percentile(arr, q))
                                  if arr.size else 0.0)
        st["peak_kv_pages"] = self.pool.peak_in_use
        st["peak_kv_bytes"] = self.pool.peak_in_use * self.page_bytes
        return st


def generate(cfg, params, prompts, *, max_new_tokens: int = 32,
             max_len: int | None = None, eos_id: int | None = None,
             prefill_chunk: int = 16, slab_k: int = 8,
             max_batch: int | None = None, page_size: int = 16,
             n_pages: int | None = None, device="cuda"):
    """Ragged 1-D prompts -> (list of per-request token arrays, stats).
    A request that runs out of cache returns fewer than
    ``max_new_tokens`` tokens (``stats["truncated"]`` counts them)."""
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    max_len = max_len or (max(p.size for p in prompts) + max_new_tokens)
    eng = Engine(cfg, params, max_batch=max_batch or len(prompts),
                 max_len=max_len, prefill_chunk=prefill_chunk,
                 slab_k=slab_k, eos_id=eos_id, page_size=page_size,
                 n_pages=n_pages, device=device)
    uids = [eng.submit(p, max_new_tokens) for p in prompts]
    res = eng.run()
    return [res[u].tokens for u in uids], eng.stats
