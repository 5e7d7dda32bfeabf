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

Serving behind real traffic (``frontend.py`` steps this engine on its
own thread):

  * **SLA admission** — ``scheduler=SLAScheduler(...)`` orders the queue
    by priority class, deadline and aging; ``submit(priority=,
    deadline_s=)`` carries both. ``admission_queue_limit`` sheds a submit
    past the bound with ``BackpressureError`` and a retry-after hint;
    ``enforce_deadlines=True`` cancels a request whose deadline passed
    at the next host sync;
  * **preemption with host offload** (paged) — ``preempt(i)`` downloads
    a live lane's exclusively owned pages to a ``HostKVStore``, keeps
    prefix-shared pages pinned, and frees the rest; a restore scatters
    the KV back into fresh pages and decode resumes at the saved
    frontier with no token prefilled twice. ``preempt=True`` lets
    admission preempt strictly lower-priority lanes, least urgent first,
    for a lane- or page-blocked head;
  * **fault containment** — ``install_faults(FaultPlan)`` arms seeded
    faults (serving/faults.py); a lane whose logits go non-finite, or
    whose offloaded KV fails its checksum, fails only its own request
    with ``LaneFaultError``; ``cancel(uid)`` reaches a queued, live or
    preempted request. Every failure comes out as a ``GenResult`` whose
    ``error`` is set. An exception from ``step`` leaves the host state
    ``Supervisor.recover`` (serving/recovery.py) rebuilds from.

Weight generations (``serving/hotswap.py``): ``swap_weights(artifact)``
validates a sealed artifact, stages it beside the serving weights,
replays its canaries and flips the generation between steps. New
admissions decode under the new weights; every in-flight lane keeps the
generation it was admitted under until it retires, when the old weights
are freed. While lanes of several generations are live, each slab and
mixed call runs once per generation with the others masked out (see
``_decode_slab``). A monitor commits the swap after a window of steps or
rolls it back when new-generation lanes are quarantined.

Observability (``repro_torch/obs``): every stat is a typed metric of
``self.metrics`` (declared once in ``_METRICS``; ``self.stats`` is its
dict view, ``reset_stats`` resets the registry), and ``tracer=`` records
the request events and the ``prefill.chunks``, ``decode.slab`` and
``mixed.step`` spans from the timestamps the engine already takes around
each call's host read (``.cpu()``), so a traced run syncs exactly as an
untraced one.

Tensor-parallel serving (``dist=``, a ``distributed.context.DistContext``
over a ``model`` axis; the dense family, GLU or two-matrix MLP (GPT-2),
the VLM's text, and the MoE family with its experts split over the
axis, ``models/moe.py``): every rank builds its own
engine on its shard of the params (``serving/export.py::shard_params``)
and a pool of its own kv heads, is handed the same requests in the same
order, and steps in lockstep. Every host decision is a function of the
submitted requests and the tokens, and the tokens are the same on every
rank (``step.greedy``), so the ranks' block tables and page accounting
stay equal; ``run`` ends by all-gathering a digest of them
(``lockstep_digest``, kept by every engine) and raises on a mismatch.
Paged phased, ``mixed=True`` and the prefix cache serve under ``dist``.
Refused there (``NotImplementedError``; ROADMAP §1 item 4): the
contiguous cache, deadlines, SLA scheduling (its aging reads the clock),
preemption, fault plans and recovery, the asyncio front door and its
watchdog, and hot-swap.

A data axis (``dist`` with batch axes of dp > 1 ranks): one engine
replica per data group. ``max_batch`` is the mesh's lane count, each
group serving ``max_batch / dp`` lanes over a pool of its own (``n_pages``
pages, or by default its lanes' worth), on the model axis alone
(``DistContext.model_only``). Every rank is handed the same ``submit``
calls in the same order; request ids are global, as one device numbers
them, and request i goes to data group ``i mod dp``, so the routing is
the same on every rank and every host decision of a group is a function
of the requests it was given. Every rank validates every submit, so an
infeasible request raises on all ranks alike and counts in no group;
``admission_queue_limit`` is refused, since a group's queue is its own.
``run`` returns every request's
``GenResult`` on every rank, gathered over the batch axes, and each
group's lockstep digest (``data_group_digests``). A group's pool is not
shared with the others: the reference's GSPMD pool would all-gather
every K/V write over the data axis so that any lane, a prefix-cache hit
included, could read any page; here a lane's pages stay where its lane
runs.

Not ported: the reference's ``attn_backend=`` (the paged decode kernel
is the one backend). Everything runs on ``device`` (default the GPU);
the CPU serves only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from collections import deque

import numpy as np
import torch

from repro_torch.distributed.context import check_serving
from repro_torch.models import registry
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.faults import (BackpressureError,
                                        DeadlineExceededError,
                                        LaneFaultError,
                                        OffloadCapacityError,
                                        OffloadCorruptionError,
                                        RequestCancelledError)
from repro_torch.serving.offload import HostKVStore
from repro_torch.serving.pages import PagePool
from repro_torch.serving.prefix_cache import Match, PrefixCache
from repro_torch.serving.scheduler import FIFOScheduler, Request, SLAScheduler
from repro_torch.serving.step import (greedy, make_copy_pages_step,
                                      make_decode_slab_step,
                                      make_gather_pages_step,
                                      make_mixed_step,
                                      make_paged_decode_slab_step,
                                      make_paged_prefill_chunk_step,
                                      make_prefill_chunk_step,
                                      make_scatter_pages_step)


@dataclasses.dataclass
class GenResult:
    """Finished request: prompt + generated tokens (greedy). A failed
    request (quarantined, cancelled, expired, corrupted offload) comes
    out the same way, with its exception in ``error`` and the tokens it
    emitted before failing in ``generated``."""
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
    # the weight generation the lane was admitted under: a hot-swap
    # never changes an in-flight request's numerics
    gen: int = 0


@dataclasses.dataclass
class _Preempted:
    """A lane frozen off the device, with what decode needs to resume at
    the saved frontier: its exclusively owned pages are in the host store
    (keyed by ``req.uid``), its prefix-shared pages stay pinned on the
    device (``pinned``: block-table index -> pool page, reference held)."""
    req: Request
    offset: int
    generated: list[int]
    token_times: list[float]
    pending: int               # next token to feed (KV not yet written)
    frontier: int              # cache slot decode resumes at
    remaining: int             # decode budget left
    n_pages: int               # logical pages the block table covered
    pinned: dict[int, int]
    # salvaged by crash recovery rather than preempted: its restore counts
    # toward recovered_zero_reprefill
    recovered: bool = False
    # the weight generation it decoded under; the restore keeps it
    gen: int = 0


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clipped to [1, cap]: the paged
    attention read width and the mixed step's query width."""
    return max(1, min(cap, 1 << max(0, (n - 1).bit_length())))


# every engine stat, declared once with its kind and help (obs/metrics.py):
# reset_stats, snapshot and the Prometheus text all derive from the
# registry, so adding a metric here is the whole job
_METRICS = [
    ("counter", "prefill_chunks", "prefill chunk calls"),
    ("counter", "prefill_tokens", "prompt tokens actually computed"),
    ("counter", "decode_slabs", "on-device decode slab calls"),
    ("counter", "decode_steps", "decode steps (slab_k per slab)"),
    ("counter", "decode_tokens", "tokens emitted by decode"),
    ("counter", "generated_tokens", "all tokens emitted"),
    ("counter", "prefill_s", "seconds in prefill calls"),
    ("counter", "decode_s", "seconds in decode slabs"),
    ("counter", "admitted", "requests admitted to lanes"),
    ("counter", "evicted", "lanes freed (finish or failure)"),
    ("counter", "truncated", "requests that hit the slot cap"),
    # mixed batching: fused calls, their time, and blocking prefill calls
    # that ran while live decode lanes waited (0 when mixed)
    ("counter", "mixed_steps", "fused decode+prefill calls"),
    ("counter", "mixed_s", "seconds in fused mixed calls"),
    ("counter", "stalled_decode_steps",
     "blocking prefill calls that stalled live decode lanes"),
    # paged attention reads (page units) against a dense max_len read
    ("counter", "pages_read", "pages the paged attention gathered"),
    ("counter", "pages_read_dense_equiv",
     "pages a dense max_len read would have touched"),
    ("gauge", "peak_kv_pages", "page pool in-use high-water"),
    # admission: queue depth high-water, page-gate rejections, seconds
    # queued
    ("gauge", "queue_depth_peak", "admission queue depth high-water"),
    ("counter", "admission_rejections",
     "distinct queue heads blocked by the page gate"),
    ("counter", "queued_s_total", "total seconds requests queued"),
    ("gauge", "queued_s_max", "longest single queued wait"),
    # prefix cache: prompt tokens submitted, radix hits and misses, the
    # prompt tokens shared pages covered, boundary-page copies, and
    # cached-idle pages reclaimed under pressure
    ("counter", "prompt_tokens", "prompt tokens submitted"),
    ("counter", "prefix_hits", "admissions with a radix-tree match"),
    ("counter", "prefix_misses", "admissions with no match"),
    ("counter", "prefill_tokens_skipped",
     "prompt tokens covered by shared prefix pages"),
    ("counter", "cow_copies", "boundary pages copy-on-write duplicated"),
    ("counter", "cache_evicted_pages",
     "cached-idle pages reclaimed under pressure"),
    # preemption: lanes frozen and resumed, pages round-tripped through
    # the host (and shared pages that stayed pinned), host bytes peak
    ("counter", "preemptions", "lanes frozen off-device"),
    ("counter", "restores", "preempted lanes resumed"),
    ("counter", "offloaded_pages", "pages downloaded to the host store"),
    ("counter", "restored_pages", "pages scattered back on restore"),
    ("counter", "preempt_pinned_pages",
     "shared pages that stayed pinned through preemption"),
    ("gauge", "offload_bytes_peak",
     "host offload store bytes high-water"),
    ("counter", "admission_rejected_steps",
     "admission attempts a blocked head held off"),
    # faults: injected faults that fired, quarantined lanes, recoveries,
    # salvaged lanes restored with no re-prefill, tokens relaunches
    # prefilled again, shed and cancelled requests, condemned hangs and
    # crashes
    ("counter", "faults_injected", "injected faults that fired"),
    ("counter", "lanes_quarantined", "lanes torn down as untrusted"),
    ("counter", "recoveries", "supervisor recoveries completed"),
    ("counter", "recovered_zero_reprefill",
     "crash-salvaged lanes restored with zero re-prefill"),
    ("counter", "re_prefilled_tokens",
     "tokens re-prefilled by relaunches"),
    ("counter", "shed_requests", "submits shed by the queue bound"),
    ("counter", "cancelled", "requests cancelled (any stage)"),
    ("counter", "deadline_cancelled", "cancelled by SLA deadline"),
    ("counter", "watchdog_hangs", "hung steps the watchdog condemned"),
    ("counter", "engine_crashes", "engine-thread crashes recovered"),
    # weight hot-swap: swaps flipped, canary rejections, rollbacks, canary
    # tokens decoded, new-generation quarantines in a monitor window; the
    # current generation and the param generations held on the device
    ("counter", "weight_swaps", "weight hot-swaps flipped"),
    ("counter", "swap_canary_failures", "swaps rejected by the canary "
     "gate before flipping"),
    ("counter", "swap_rollbacks", "flipped swaps rolled back"),
    ("counter", "swap_canary_tokens", "tokens decoded by swap canaries"),
    ("counter", "swap_quarantines",
     "new-generation lanes quarantined inside a swap monitor window"),
    ("gauge", "weight_generation", "current weight generation id"),
    ("gauge", "weight_generations_held",
     "distinct param generations held on device"),
    # per-request latency samples (monotonic clock), folded into p50/p95
    # by finalize_stats
    ("histogram", "ttft_s", "submit -> first token seconds"),
    ("histogram", "itl_s", "inter-token gap seconds"),
]


class Engine:
    """Continuous-batching greedy generation over pruned/packed weights.

    >>> eng = Engine(cfg, params, max_batch=8, max_len=512)
    >>> uid = eng.submit(prompt_ids, max_new_tokens=64)
    >>> results = eng.run()          # {uid: GenResult}

    ``params`` must already lie on ``device``. ``slab_k`` decode steps
    run per host sync; ``n_pages`` defaults to ``max_batch`` lanes of
    ``max_len`` slots. ``paged``, ``mixed`` and ``prefix_cache`` pick
    the cache layout and admission policy; ``scheduler`` (default FIFO;
    an empty one is kept, not replaced), ``preempt``,
    ``offload_store`` (a ``HostKVStore`` to offload into, say one a
    caller shares or inspects; by default a new one with
    ``offload_capacity_bytes`` as its budget, None for unbounded),
    ``admission_queue_limit``,
    ``enforce_deadlines`` and ``faults`` the serving behaviour (module
    docstring); ``tracer`` (default off) records spans and events."""

    def __init__(self, cfg, params, *, max_batch: int, max_len: int,
                 prefill_chunk: int = 16, slab_k: int = 8,
                 eos_id: int | None = None,
                 scheduler: FIFOScheduler | None = None,
                 paged: bool = True, page_size: int = 16,
                 n_pages: int | None = None, prefix_cache: bool = False,
                 mixed: bool = False,
                 prefill_token_budget: int | None = None,
                 preempt: bool = False, offload_store=None,
                 offload_capacity_bytes: int | None = None,
                 admission_queue_limit: int | None = None,
                 enforce_deadlines: bool = False, faults=None,
                 tracer=None, device="cuda", dist=None):
        # the data axis: this rank's group serves its share of the lanes
        # on the model axis alone
        self.data = None
        self._submitted = 0
        self.data_group_digests: list[int] = []
        if dist is not None:
            _refuse_under_dist(cfg, dist, paged=paged, preempt=preempt,
                               enforce_deadlines=enforce_deadlines,
                               faults=faults, scheduler=scheduler)
            if dist.data_size > 1:
                if admission_queue_limit is not None:
                    # a group's queue is its own: shedding on it would
                    # route the groups' later submits apart
                    raise NotImplementedError(_REFUSED.format(
                        "admission_queue_limit over a data axis"))
                if max_batch % dist.data_size:
                    raise NotImplementedError(
                        f"max_batch={max_batch} lanes do not split over "
                        f"{dist.data_size} data groups (ROADMAP §1 item 4: "
                        "uneven splits)")
                self.data = dist
                max_batch //= dist.data_size
                dist = dist.model_only()
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
        if preempt and not paged:
            raise ValueError("preempt=True requires paged=True (pages "
                             "are the unit of offload)")
        if slab_k < 1:
            raise ValueError(f"slab_k={slab_k} must be >= 1")
        # not ``tracer or ...``: the same falsy-default hazard as the
        # scheduler's below
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricsRegistry()
        for kind, name, help_ in _METRICS:
            getattr(self.metrics, kind)(name, help_)
        # the dict view: every ``self.stats[...]`` lands on a typed metric
        self.stats = self.metrics.view()
        self.cfg = cfg
        self.params = params
        self.dist = dist
        # crc32 of the block tables, frontiers and page states after
        # every step: the lockstep guard's digest (``check_lockstep``)
        self.lockstep_digest = 0
        # weight generations (serving/hotswap.py): ``_gen`` is the one
        # new admissions decode under, ``_gen_params`` every param set an
        # in-flight lane still uses (``_gc_generations`` frees the rest),
        # ``_gen_pins`` uid -> generation of crash relaunches, which must
        # resume on their admission-time weights, and ``_swap_monitor``
        # the post-flip rollback watcher
        self._gen = 0
        self._gen_params: dict[int, object] = {0: params}
        self._gen_pins: dict[int, int] = {}
        self._swap_monitor = None
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.chunk = max(1, min(prefill_chunk, max_len))
        self.slab_k = slab_k
        self.eos_id = eos_id
        self.paged = paged
        self.mixed = mixed
        # not ``scheduler or ...``: a scheduler has __len__, so an empty
        # one is falsy and ``or`` would swap it for a new FIFO
        self.scheduler = (scheduler if scheduler is not None
                          else FIFOScheduler(max_batch, max_len))
        self.scheduler.tracer = self.tracer
        if prefill_token_budget is not None:
            self.scheduler.prefill_token_budget = prefill_token_budget
        elif self.scheduler.prefill_token_budget is None:
            # one full decode batch + one full prefill chunk per step
            self.scheduler.prefill_token_budget = max_batch + self.chunk
        # lanes whose prompt is still being prefilled across calls:
        # lane -> next prompt position, in admission order
        self._prefilling: dict[int, int] = {}
        self.lanes: list[_Lane | None] = [None] * max_batch
        # host mirror of the per-lane device state; uploaded only after
        # admission or eviction edits it (self._dirty). ``poison`` is the
        # fault-injection port of the slab and the mixed step, ``faulted``
        # their per-lane finite-check verdict
        self._mirror = {
            "pending": np.zeros(max_batch, np.int32),
            "frontier": np.zeros(max_batch, np.int32),
            "offsets": np.zeros(max_batch, np.int32),
            "remaining": np.zeros(max_batch, np.int32),
            "live": np.zeros(max_batch, bool),
            "poison": np.zeros(max_batch, np.float32),
            "faulted": np.zeros(max_batch, bool),
        }
        self.admission_queue_limit = admission_queue_limit
        self.enforce_deadlines = enforce_deadlines
        self._finish_times: deque[float] = deque(maxlen=32)
        # uid -> (original prompt, tokens emitted before a crash
        # relaunch): a relaunched request decodes over prompt + emitted,
        # its result reports the original split
        self._recovered_prefix: dict[int, tuple[np.ndarray, list[int]]] = {}
        # failure results made outside step() (cancel, a corrupted
        # restore, recovery), handed out by the next step
        self._pending_results: list[GenResult] = []
        self._step_idx = 0
        # set by the watchdog to abort a wedged step (the injected stall
        # polls it)
        self._condemned = threading.Event()
        self._faults = None
        self.preempt_enabled = preempt
        self._preempted: list[_Preempted] = []
        self.pcache: PrefixCache | None = None
        self.pool: PagePool | None = None
        self._offload: HostKVStore | None = None
        if paged:
            self.page_size = page_size
            per_lane = -(-max_len // page_size)
            self.n_pages = (max_batch * per_lane if n_pages is None
                            else n_pages)
            self.max_pages = min(per_lane, self.n_pages)
            self.pool = PagePool(self.n_pages, page_size)
            self.cache = registry.init_paged_cache(
                cfg, self.n_pages, page_size, device=self.device, dist=dist)
            if prefix_cache:
                self.pcache = PrefixCache(self.pool)
                self._copy_pages = make_copy_pages_step()
            self._mirror["bt"] = np.zeros((max_batch, self.max_pages),
                                          np.int32)
            self._offload = (offload_store if offload_store is not None
                             else HostKVStore(offload_capacity_bytes))
            self._offload.tracer = self.tracer
            self._gather = make_gather_pages_step()
            self._scatter = make_scatter_pages_step()
            self.scheduler.feasibility = self._check_feasible
            self._prefill = make_paged_prefill_chunk_step(cfg, dist)
            # one fused decode+prefill call (mixed steps, and the phased
            # engine's batched tail prefill of prefix-cached admissions)
            self._mixed_fn = make_mixed_step(cfg, dist)
            # query-width bucket cap: smallest power of two >= chunk
            self._wcap = 1 << max(0, (self.chunk - 1).bit_length())
            self._slab = make_paged_decode_slab_step(
                cfg, slab_k, max_len, page_size, eos_id=eos_id, dist=dist)
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
        if faults is not None:
            self.install_faults(faults)

    def install_faults(self, plan) -> None:
        """Wire a ``FaultPlan`` into every injection point: the step
        hooks, the page allocator and the offload store."""
        if self.dist is not None:
            raise NotImplementedError(_REFUSED.format("fault plans"))
        self._faults = plan
        plan._engine = self
        if self.paged:
            self.pool.fault_hook = plan.on_alloc
            self._offload.fault_hook = plan.on_offload_save

    def reset_stats(self) -> None:
        """Zero every registered metric: derived from the registry, so a
        metric added to ``_METRICS`` or registered through the view at
        finalize cannot be missed."""
        self.metrics.reset()
        self.scheduler.reset_stats()
        if self.pool is not None:
            self.pool.reset_peaks()
        if self._offload is not None:
            self._offload.reset_peaks()

    # the raw latency samples, registry histograms (reset clears them in
    # place), under the names callers append to and read
    @property
    def _ttft(self) -> list[float]:
        return self.metrics.histogram("ttft_s").samples

    @property
    def _itl(self) -> list[float]:
        return self.metrics.histogram("itl_s").samples

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
               uid: int | None = None, *, priority: int = 0,
               deadline_s: float | None = None) -> int:
        """Queue one request (under a data axis, only the requests of this
        rank's group: the i-th submitted goes to group i mod dp, every
        rank numbering them alike). ``priority`` is the SLA class (smaller is
        more urgent; only an ``SLAScheduler`` orders by it), ``deadline_s``
        an optional target latency. Infeasible requests raise ValueError
        here; past ``admission_queue_limit`` a submit is shed with
        ``BackpressureError`` carrying a retry-after hint from the recent
        completion rate."""
        if (self.admission_queue_limit is not None
                and len(self.scheduler) >= self.admission_queue_limit):
            self.stats["shed_requests"] += 1
            self.tracer.event("request.shed",
                              queue_depth=len(self.scheduler))
            raise BackpressureError(len(self.scheduler),
                                    self.admission_queue_limit,
                                    self._retry_after_hint())
        uid = self._uid if uid is None else uid
        self._uid = max(self._uid, uid) + 1
        req = Request(uid, np.asarray(prompt), max_new_tokens,
                      priority=priority, deadline_s=deadline_s)
        if self.data is not None and self._submitted % self.data.data_size \
                != self.data.data_rank:
            # another data group's request: refused here as there, so
            # every rank counts the same submits
            self.scheduler.check(req)
            self._submitted += 1
            return uid
        self.scheduler.submit(req)
        self._submitted += 1
        if self.tracer.enabled:
            self.tracer.event("request.queued", t=req.queued_at,
                              uid=uid, prompt_len=req.prompt_len,
                              max_new_tokens=max_new_tokens,
                              priority=priority)
        self.stats["queue_depth_peak"] = max(self.stats["queue_depth_peak"],
                                             len(self.scheduler))
        return uid

    def _retry_after_hint(self) -> float:
        """Seconds until a queue slot plausibly frees: the mean gap of the
        last completions, clamped to [0.05, 60]; 1 s on a cold engine."""
        ft = self._finish_times
        if len(ft) >= 2 and ft[-1] > ft[0]:
            est = (ft[-1] - ft[0]) / (len(ft) - 1)
        else:
            est = 1.0
        return float(min(60.0, max(0.05, est)))

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
        self._gen_pins.pop(lane.req.uid, None)
        if self.paged and lane.pages:
            # donation also needs current-generation KV: the swap flushed
            # the tree at its flip, and an old-generation lane finishing
            # later must not reseed it with KV of retired weights
            if (self.pcache is not None and lane.offset == 0
                    and lane.gen == self._gen):
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
        self._itl.extend(b - a for a, b in zip(tt, tt[1:]))
        self._finish_times.append(time.monotonic())
        # a crash-relaunched request decoded over prompt + emitted: report
        # the original split
        prompt, gen = lane.req.prompt, lane.generated
        pre = self._recovered_prefix.pop(lane.req.uid, None)
        if pre is not None:
            prompt, gen = pre[0], list(pre[1]) + gen
        if self.tracer.enabled:
            self.tracer.event("request.finish", uid=lane.req.uid,
                              lane=i, tokens=len(gen), ttft_s=ttft,
                              truncated=truncated)
        return GenResult(lane.req.uid, prompt, np.asarray(gen, np.int32),
                         truncated, ttft_s=ttft)

    # ------------------------------------------------ quarantine / cancel
    def _failed_result(self, req: Request, generated: list[int],
                       exc: Exception) -> GenResult:
        """The failure result of ``req``, re-split at its original prompt
        after a relaunch. No latency samples: failures must not skew the
        percentiles."""
        prompt, gen = req.prompt, list(generated)
        pre = self._recovered_prefix.pop(req.uid, None)
        if pre is not None:
            prompt, gen = pre[0], list(pre[1]) + gen
        return GenResult(req.uid, prompt, np.asarray(gen, np.int32),
                         error=exc)

    def _fail_lane(self, i: int, exc: Exception) -> GenResult:
        """Tear lane ``i`` down with a structured error: its pages free
        (never donated to the prefix cache: its KV is not trusted; shared
        pages just unpin) and its device state clears. The other lanes'
        state is untouched, so their streams are too."""
        lane = self.lanes[i]
        self.lanes[i] = None
        self._gen_pins.pop(lane.req.uid, None)
        if (self._swap_monitor is not None
                and isinstance(exc, (LaneFaultError,
                                     OffloadCorruptionError))):
            # rollback evidence: quarantines of lanes on the freshly
            # flipped generation
            self._swap_monitor.note_quarantine(lane.gen, self)
        m = self._mirror
        m["live"][i] = False
        m["faulted"][i] = False
        m["poison"][i] = 0.0
        if self.paged and lane.pages:
            self.pool.release(lane.pages)
            m["bt"][i] = 0
        self._prefilling.pop(i, None)
        self._dirty = True
        self.stats["evicted"] += 1
        self._finish_times.append(time.monotonic())
        if self.tracer.enabled:
            name = ("request.quarantined"
                    if isinstance(exc, (LaneFaultError,
                                        OffloadCorruptionError))
                    else "request.failed")
            self.tracer.event(name, uid=lane.req.uid, lane=i,
                              error=type(exc).__name__,
                              tokens=len(lane.generated))
        return self._failed_result(lane.req, lane.generated, exc)

    def _harvest_faults(self, finished: list[GenResult]) -> None:
        """Fail every lane the device-side finite check flagged this step
        with ``LaneFaultError``; only its own request fails."""
        m = self._mirror
        if not m["faulted"].any():
            return
        for i in self.active_lanes:
            if m["faulted"][i]:
                uid = self.lanes[i].req.uid
                self.stats["lanes_quarantined"] += 1
                finished.append(self._fail_lane(i, LaneFaultError(uid, i)))
        m["faulted"][:] = False
        self._dirty = True

    def _cancel_expired(self, finished: list[GenResult]) -> None:
        """Cancel, at this host sync, every lane whose absolute deadline
        (on the scheduler's clock) has passed."""
        now = self.scheduler.clock()
        for i in self.active_lanes:
            req = self.lanes[i].req
            if req.deadline_at is not None and now > req.deadline_at:
                self.stats["deadline_cancelled"] += 1
                self.stats["cancelled"] += 1
                finished.append(
                    self._fail_lane(i, DeadlineExceededError(req.uid)))

    def cancel(self, uid: int) -> bool:
        """Cancel a request wherever it is (queued, on a lane, preempted),
        releasing its lane, pages and offload record; its
        ``RequestCancelledError`` result comes out of the next step. False
        when the uid is not in flight."""
        req = self.scheduler.remove(uid)
        if req is not None:
            self.stats["cancelled"] += 1
            self._gen_pins.pop(uid, None)
            self._pending_results.append(
                self._failed_result(req, [], RequestCancelledError(uid)))
            return True
        for j, pre in enumerate(self._preempted):
            if pre.req.uid == uid:
                self._preempted.pop(j)
                self._gen_pins.pop(uid, None)
                self._offload.drop(uid)
                if pre.pinned:
                    self.pool.release(list(pre.pinned.values()))
                self.stats["cancelled"] += 1
                self._pending_results.append(self._failed_result(
                    pre.req, pre.generated, RequestCancelledError(uid)))
                return True
        for i in self.active_lanes:
            if self.lanes[i].req.uid == uid:
                self.stats["cancelled"] += 1
                self._pending_results.append(
                    self._fail_lane(i, RequestCancelledError(uid)))
                return True
        return False

    # ---------------------------------------------------------- preemption
    def _download_pages(self, pages: list[int]):
        """Copy pool pages ``pages`` (physical) to host tensors. On the
        GPU into pinned buffers, and the stream is synchronized before
        returning: the caller releases the pages next, and the next
        admission's prefill may write them."""
        k, v = self._gather(self.cache,
                            self._tensor(np.asarray(pages, np.int64)))
        if self.device.type != "cuda":
            return k, v
        hk = torch.empty(k.shape, dtype=k.dtype, pin_memory=True)
        hv = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        hk.copy_(k, non_blocking=True)
        hv.copy_(v, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return hk, hv

    def _upload_pages(self, dst: list[int], k: torch.Tensor,
                      v: torch.Tensor) -> None:
        """Scatter host page data into pool pages ``dst``. The copies are
        asynchronous from pinned buffers; PyTorch's pinned-memory
        allocator keeps a buffer from reuse until the copy that reads it
        has completed, so the record may be dropped at once."""
        self.cache = self._scatter(
            self.cache, self._tensor(np.asarray(dst, np.int64)),
            k.to(self.device, non_blocking=True),
            v.to(self.device, non_blocking=True))

    @torch.inference_mode()
    def preempt(self, i: int) -> None:
        """Freeze live decode lane ``i`` off the device: download its
        exclusively owned pages covering slots ``[0, frontier)`` to the
        host store, keep prefix-shared or cached pages pinned (another
        reader needs them), release the rest, and save the decode state,
        so a restore resumes with no re-prefilled token. Raises
        ``OffloadCapacityError``, with nothing changed, when the store is
        full."""
        if not self.paged:
            raise ValueError("preemption requires the paged engine")
        lane = self.lanes[i]
        m = self._mirror
        if lane is None or i in self._prefilling or not m["live"][i]:
            raise ValueError(f"lane {i} is not a live decode lane")
        n_live = self.pool.slots_for(int(m["frontier"][i]))
        dl_logical: list[int] = []
        dl_pages: list[int] = []
        pinned: dict[int, int] = {}
        for j in range(n_live):
            p = lane.pages[j]
            if self.pool.exclusive(p):
                dl_logical.append(j)
                dl_pages.append(p)
            else:
                pinned[j] = p            # reference held through preempt
        if dl_pages:
            k, v = self._download_pages(dl_pages)
            self._offload.save(lane.req.uid, dl_logical, k, v)
            self.stats["offloaded_pages"] += len(dl_pages)
            self.stats["offload_bytes_peak"] = max(
                self.stats["offload_bytes_peak"], self._offload.bytes_peak)
        self.stats["preempt_pinned_pages"] += len(pinned)
        # extent pages past the frontier free without a download: never
        # shared (sharing covers at most the prompt, and a live lane's
        # frontier is at least its prompt)
        self.pool.release(dl_pages + lane.pages[n_live:])
        self._preempted.append(_Preempted(
            req=lane.req, offset=lane.offset, generated=lane.generated,
            token_times=lane.token_times, pending=int(m["pending"][i]),
            frontier=int(m["frontier"][i]),
            remaining=int(m["remaining"][i]), n_pages=len(lane.pages),
            pinned=pinned, gen=lane.gen))
        self.lanes[i] = None
        m["live"][i] = False
        m["bt"][i] = 0
        self._dirty = True
        self.stats["preemptions"] += 1
        if self.tracer.enabled:
            self.tracer.event("request.preempt", uid=lane.req.uid, lane=i,
                              offloaded_pages=len(dl_pages),
                              pinned_pages=len(pinned))

    def _restore_one(self, pre: _Preempted) -> bool:
        """Re-admit one preempted lane: fresh pages for every logical page
        not pinned, the pinned ones at their logical positions, the host
        KV scattered back, the lane rebuilt at its saved frontier. False
        when no lane is free or the pool cannot cover it yet."""
        free = [i for i, l in enumerate(self.lanes) if l is None]
        if not free:
            return False
        own_need = pre.n_pages - len(pre.pinned)
        if self.pcache is not None:
            short = own_need - self.pool.free_pages
            if short > 0:
                self.stats["cache_evicted_pages"] += \
                    self.pcache.evict(short)
        if own_need > self.pool.free_pages:
            return False
        i = free[0]
        own = iter(self.pool.alloc(own_need))
        pages = [pre.pinned[j] if j in pre.pinned else next(own)
                 for j in range(pre.n_pages)]
        try:
            rec = self._offload.pop(pre.req.uid)
        except OffloadCorruptionError as e:
            # the parked KV rotted in host RAM: this request fails, the
            # others are untouched (own pages free, pinned ones unpin)
            self.pool.release(pages)
            self.stats["lanes_quarantined"] += 1
            self.tracer.event("request.quarantined", uid=pre.req.uid,
                              error=type(e).__name__,
                              tokens=len(pre.generated))
            self._pending_results.append(self._failed_result(
                pre.req, pre.generated,
                LaneFaultError(pre.req.uid, -1, reason=str(e))))
            return True          # the entry is resolved
        if rec is not None:      # None: every live page was pinned shared
            dst = [pages[j] for j in rec.logical]
            self._upload_pages(dst, rec.k, rec.v)
            self.stats["restored_pages"] += len(dst)
            if pre.recovered:
                self.stats["recovered_zero_reprefill"] += 1
        self.lanes[i] = _Lane(pre.req, pre.offset, pre.generated,
                              pages=pages, token_times=pre.token_times,
                              gen=pre.gen)
        m = self._mirror
        m["bt"][i] = 0
        m["bt"][i, :len(pages)] = pages
        m["offsets"][i] = pre.offset
        m["frontier"][i] = pre.frontier
        m["remaining"][i] = pre.remaining
        m["pending"][i] = pre.pending
        m["live"][i] = True
        self._dirty = True
        self.stats["restores"] += 1
        if self.tracer.enabled:
            self.tracer.event(
                "request.restore", uid=pre.req.uid, lane=i,
                frontier=pre.frontier, recovered=pre.recovered,
                restored_pages=(len(rec.logical) if rec is not None
                                else 0))
        return True

    def _try_restore(self) -> None:
        """Re-admit preempted lanes, most urgent first, unless the queue
        head outranks them (restoring a lane only to preempt it again
        would thrash); one that does not fit yet blocks those behind it."""
        self._preempted.sort(key=lambda p: (p.req.priority, p.req._seq))
        while self._preempted:
            head = self.scheduler.head()
            if (head is not None
                    and head.priority < self._preempted[0].req.priority):
                return
            if not self._restore_one(self._preempted[0]):
                return
            self._preempted.pop(0)

    def _releasable(self, i: int) -> int:
        """Pages preempting lane ``i`` would return to the pool."""
        return sum(1 for p in self.lanes[i].pages if self.pool.exclusive(p))

    def _shortfall(self, head: Request) -> int:
        """Pages the queue head needs beyond what the pool can give now
        (with the prefix cache: effective cost against free +
        reclaimable)."""
        if self.pcache is not None:
            return (self._page_cost_shared()([head])
                    - self.pool.free_pages - self.pcache.reclaimable())
        return self._page_cost([head]) - self.pool.free_pages

    def _preempt_for_head(self) -> bool:
        """Make room for a lane- or page-blocked queue head by preempting
        strictly lower-priority live lanes, least urgent (then latest
        arrived) first, until the head fits, no candidate is left, or a
        victim would free no page the head is short of. True when a lane
        was preempted (the caller admits again)."""
        head = self.scheduler.head()
        if head is None:
            return False
        did = False
        while True:
            free_lane = any(l is None for l in self.lanes)
            short = self._shortfall(head)
            if free_lane and short <= 0:
                return did
            cands = [i for i in self.active_lanes
                     if self._mirror["live"][i]
                     and i not in self._prefilling
                     and self.lanes[i].req.priority > head.priority]
            if not cands:
                return did
            victim = max(cands, key=lambda i: (self.lanes[i].req.priority,
                                               self.lanes[i].req._seq))
            if free_lane and short > 0 and self._releasable(victim) == 0:
                return did
            try:
                self.preempt(victim)
            except OffloadCapacityError:
                # host store full: the victim runs on (preempt changed
                # nothing) and the head waits the normal way
                return did
            did = True

    # --------------------------------------------------------- admission
    def _note_admitted(self, reqs: list[Request]) -> None:
        now = self.scheduler.clock()
        tr = self.tracer
        for r in reqs:
            q = max(0.0, now - r.queued_at)
            self.stats["queued_s_total"] += q
            self.stats["queued_s_max"] = max(self.stats["queued_s_max"], q)
            if tr.enabled:
                tr.event("request.admitted", t=now, uid=r.uid,
                         queued_s=q, priority=r.priority)
        self.stats["admitted"] += len(reqs)

    def _admit(self) -> None:
        """Admission, then, when a head is left behind and
        ``preempt=True``, preemption of lower-priority lanes and admission
        again."""
        self._admit_once()
        if (self.paged and self.preempt_enabled and len(self.scheduler)
                and self._preempt_for_head()):
            self._admit_once()

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
        # grouped by target weight generation: the current one, except
        # crash relaunches pinned to their admission-time generation (one
        # group outside a swap window)
        groups: dict[int, list[Request]] = {}
        for r in reqs:
            groups.setdefault(self._gen_pins.get(r.uid, self._gen),
                              []).append(r)
        m = self._mirror
        built: list[tuple[int, int, list[int]]] = []   # (gen, W, lanes)
        try:
            for gen in sorted(groups):
                sub = groups[gen]
                # the group prefills right-aligned in slots [0, W): a
                # lane freed mid-traffic restarts at slot 0
                width = max(r.prompt_len for r in sub)
                new_lanes = []
                for r in sub:
                    i = free.pop(0)
                    off = width - r.prompt_len
                    self.lanes[i] = _Lane(r, off, [], gen=gen)
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
                built.append((gen, width, new_lanes))
        except BaseException:
            # crash-safe admission: after an allocation failure mid-group,
            # requests that never reached a lane go back to the queue head
            # (one stranded on a half-built lane relaunches in recovery)
            placed = {l.req.uid for l in self.lanes if l is not None}
            self.scheduler.push_front(
                [r for r in reqs if r.uid not in placed])
            raise
        self._dirty = True
        self._note_admitted(reqs)
        for gen, width, new_lanes in built:
            # each group prefills through its own generation's weights
            tokens = np.zeros((self.max_batch, width), np.int32)
            for i in new_lanes:
                p = self.lanes[i].req.prompt
                tokens[i, width - p.size:] = p
            self._run_prefill(new_lanes, tokens, width,
                              self._gen_params[gen])
        self.stats["prefill_tokens"] += sum(r.prompt_len for r in reqs)
        self.stats["prompt_tokens"] += sum(r.prompt_len for r in reqs)

    def _run_prefill(self, lane_ids: list[int], tokens: np.ndarray,
                     cover_slots: int, params) -> None:
        """Run ``tokens`` (max_batch, W) through the prefill step with
        ``params`` (one weight generation) in whole chunks (the first
        ``W % chunk`` wide, the rest ``chunk``), lanes outside
        ``lane_ids`` shielded by the lane mask, then fold each lane's
        FIRST generated token into the mirror. Every call stalls the other
        live lanes' decode (counted)."""
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
                    params, self.cache, toks[:, pos:pos + c], pos,
                    offsets, mask_t, bt, read_pages=r_pf)
                self.stats["pages_read"] += r_pf * len(lane_ids) * c
                self.stats["pages_read_dense_equiv"] += (
                    self.pool.slots_for(self.max_len) * len(lane_ids) * c)
            else:
                last, self.cache = self._prefill(
                    params, self.cache, toks[:, pos:pos + c], pos,
                    offsets, mask_t)
            pos += c
            self.stats["prefill_chunks"] += 1
        first = greedy(self.cfg, last, self.dist)[0].cpu().numpy()  # sync
        now = time.monotonic()
        self.stats["prefill_s"] += now - t0
        if self.tracer.enabled:
            # the span reuses this loop's own timestamps: no sync added
            self.tracer.span_at(
                "prefill.chunks", t0, now, lanes=len(lane_ids),
                chunks=len(sizes), tokens=width,
                uids=[self.lanes[i].req.uid for i in lane_ids])
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
        for j, r in enumerate(reqs):
            i = free.pop(0)
            need = self._page_cost([r])
            try:
                pages = self.pool.alloc(need)
            except BaseException:
                self.scheduler.push_front(reqs[j:])
                raise
            self.lanes[i] = _Lane(r, 0, [], pages=pages,
                                  gen=self._gen_pins.get(r.uid, self._gen))
            m["bt"][i] = 0
            m["bt"][i, :need] = pages
            m["offsets"][i] = 0
            m["frontier"][i] = r.prompt_len
            m["remaining"][i] = r.max_new_tokens - 1
            m["pending"][i] = 0
            m["live"][i] = False          # decodable once the tail lands
            self._prefilling[i] = 0
            self.stats["prompt_tokens"] += r.prompt_len
        if reqs:
            self._dirty = True
            self._note_admitted(reqs)

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
            try:
                ok = self._admit_one(free[0], r)
            except BaseException:
                self.scheduler.push_front(reqs[j:])
                raise
            if not ok:
                self.scheduler.push_front(reqs[j:])
                break
            tails.append(free.pop(0))
            self._note_admitted([r])
        if not self.mixed and tails:
            self._prefill_tails(tails)

    def _admit_one(self, i: int, r: Request) -> bool:
        """match -> pin the shared pages -> evict for room -> alloc own
        pages -> copy the boundary page -> register the tail prefill.
        False when the pool cannot cover the request (nothing held; an
        eviction already made is not undone)."""
        gen = self._gen_pins.get(r.uid, self._gen)
        if gen != self._gen:
            # a relaunch pinned to retired weights must not match: cached
            # KV always belongs to the current generation
            m, extent = Match([], 0), self._page_cost([r])
        else:
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
        try:
            own = self.pool.alloc(own_need)
        except BaseException:
            self.pool.release(m.pages + pin_tail)   # no pin leaks
            raise
        if m.tail_page is not None:
            # copy-on-write: the lane goes on writing this page, so it
            # gets a private copy; the shared original stays read-only
            self.cache = self._copy_pages(
                self.cache, self._tensor(np.asarray([m.tail_page], np.int32)),
                self._tensor(np.asarray([own[0]], np.int32)))
            self.pool.release(pin_tail)
            self.stats["cow_copies"] += 1
        pages = m.pages + own           # logical page order
        self.lanes[i] = _Lane(r, 0, [], pages=pages, gen=gen)
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
            self._run_mixed([], plan)

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
        """One engine iteration. Phased: evict, restore preempted lanes,
        admit (blocking on the new prompts' whole prefill, preempting for
        an urgent head when enabled), then one decode slab. Mixed: the
        same up to admission (non-blocking), then one fused decode+prefill
        call when the token budget planned prompt chunks, else a decode
        slab. Returns the requests finished during this step, failures
        included, and those parked by ``cancel`` or recovery since the
        last step (or swept by a step that then died).

        An installed ``FaultPlan`` fires host-side faults at the top,
        before any mutation, and device-side faults at the slab or mixed
        call."""
        idx = self._step_idx
        self._step_idx += 1
        if self._faults is not None:
            self._faults.on_step(idx, self)
        # results stay parked in ``_pending_results`` until the step
        # returns: a step that dies after its sweep loses none of them
        finished: list[GenResult] = self._pending_results
        self._sweep_finished(finished)
        if self.enforce_deadlines:
            self._cancel_expired(finished)
        if self._preempted:
            self._try_restore()    # older work first, unless outranked
        self._admit()
        self._sweep_finished(finished)   # e.g. max_new_tokens == 1
        if self.mixed:
            decode_lanes = [i for i in self.active_lanes
                            if self._mirror["live"][i]]
            tails = [(i, self.lanes[i].req.prompt_len - pos)
                     for i, pos in self._prefilling.items()]
            plan = self.scheduler.plan_chunks(tails, len(decode_lanes),
                                              self.chunk)
            if plan:
                self._run_mixed(decode_lanes, plan)
            elif decode_lanes:
                self._decode_slab()
        elif self.active_lanes:
            self._decode_slab()
        self._harvest_faults(finished)
        self._gc_generations()
        if self._swap_monitor is not None:
            self._swap_monitor.on_step_end(self)
        self._pending_results = []
        self._fold_digest()
        return finished

    def _fold_digest(self) -> None:
        parts = [self._mirror["frontier"], self._mirror["live"]]
        if self.paged:
            parts += [self._mirror["bt"], *self.pool.state()]
        for a in parts:
            self.lockstep_digest = zlib.crc32(
                np.ascontiguousarray(a).tobytes(), self.lockstep_digest)

    def check_lockstep(self) -> None:
        """Under ``dist``: all-gather every rank's ``lockstep_digest`` and
        raise ``RuntimeError`` unless they are all equal."""
        if self.dist is None:
            return
        d = torch.tensor([self.lockstep_digest], dtype=torch.int64,
                         device=self.device)
        got = self.dist.all_gather(d, dim=0).cpu().tolist()
        if len(set(got)) > 1:
            raise RuntimeError(
                f"ranks out of lockstep: block-table and page digests "
                f"{got} differ")

    def _gc_generations(self) -> None:
        """Drop the weight generations no lane, preempted record or
        relaunch pin uses any more: when the last lane admitted before a
        swap retires, the old params are freed. The current generation is
        always held."""
        if len(self._gen_params) == 1:
            return
        held = {self._gen}
        held.update(l.gen for l in self.lanes if l is not None)
        held.update(p.gen for p in self._preempted)
        held.update(self._gen_pins.values())
        for g in [g for g in self._gen_params if g not in held]:
            del self._gen_params[g]
        self.stats["weight_generations_held"] = len(self._gen_params)

    def swap_weights(self, artifact_dir: str, **kw):
        """Hot-swap the weights from a sealed artifact: validate, stage,
        canary, flip the generation, then a monitored commit or an
        automatic rollback (serving/hotswap.py). Call between steps."""
        if self.dist is not None:
            raise NotImplementedError(_REFUSED.format("hot-swap"))
        from repro_torch.serving import hotswap
        return hotswap.swap_weights(self, artifact_dir, **kw)

    def _decode_slab(self) -> None:
        """One slab of ``slab_k`` device-side decode steps, one host
        sync; paged, it reads ``read_pages`` = the power-of-two bucket
        covering every lane's frontier + slab_k.

        In a hot-swap window the live lanes may span several weight
        generations: the slab then runs once per generation, the other
        generations' lanes masked out of ``live`` (and ``poison``, which
        the slab zeroes) and restored after. A masked lane writes only at
        the park slot, and its pending token, frontier and budget come
        back unchanged, so its KV and state are bitwise untouched. Each
        call keeps all ``max_batch`` rows, so the kernels' split plans
        (``split_plan.choose`` sees the same M) and every lane's rows are
        bitwise those of a one-generation call. Outside a window there is
        one generation and one call."""
        self._sync_dstate()
        if self._faults is not None:
            self._faults.on_device_step(self._step_idx - 1, self)
        gens = sorted({self.lanes[i].gen for i in self.active_lanes
                       if self._mirror["live"][i]})
        if len(gens) <= 1:
            params = self._gen_params[gens[0]] if gens else self.params
            self._slab_call(params, self.active_lanes)
            return
        for g in gens:
            part = [i for i in self.active_lanes
                    if self._mirror["live"][i] and self.lanes[i].gen == g]
            mask = np.zeros(self.max_batch, bool)
            mask[part] = True
            save_live = self._mirror["live"].copy()
            save_poison = self._mirror["poison"].copy()
            self._mirror["live"] = save_live & mask
            self._mirror["poison"] = np.where(mask, save_poison,
                                              np.float32(0.0))
            self._dirty = True
            self._sync_dstate()
            self._slab_call(self._gen_params[g], part)
            m = self._mirror
            m["live"] = np.where(mask, m["live"], save_live)
            m["poison"] = np.where(mask, m["poison"], save_poison)
            self._dirty = True

    def _slab_call(self, params, lanes: list[int]) -> None:
        """One slab call with ``params`` and the host fold, for ``lanes``
        (the other rows ride along masked). The read width covers every
        active lane's frontier, not only ``lanes``': a call of one
        generation then reads the pages a one-generation call would, so
        paged decode picks the same split and its lanes' rows are bitwise
        equal."""
        t0 = time.monotonic()
        if self.paged:
            fmax = int(max(self._mirror["frontier"][i]
                           for i in self.active_lanes))
            need = min(fmax + self.slab_k, self.max_len)
            r = _pow2_bucket(self.pool.slots_for(need), self.max_pages)
            block, self._dstate, self.cache = self._slab(
                params, self.cache, self._dstate, read_pages=r)
            n = len(lanes) * self.slab_k
            self.stats["pages_read"] += r * n
            self.stats["pages_read_dense_equiv"] += (
                self.pool.slots_for(self.max_len) * n)
        else:
            block, self._dstate, self.cache = self._slab(
                params, self.cache, self._dstate)
        block = block.cpu().numpy()                        # host sync
        now = time.monotonic()
        self.stats["decode_s"] += now - t0
        self.stats["decode_slabs"] += 1
        self.stats["decode_steps"] += self.slab_k
        if self.tracer.enabled:
            self.tracer.span_at(
                "decode.slab", t0, now, k=self.slab_k, lanes=len(lanes),
                uids=[self.lanes[i].req.uid for i in lanes])
        self._replay(block, now)

    def _run_mixed(self, decode_lanes: list[int],
                   plan: dict[int, int]) -> None:
        """The fused decode+prefill call, once per weight generation of
        the lanes it carries (one call outside a hot-swap window; rows are
        independent, so the split is bitwise, as in ``_decode_slab``). A
        stalled decode step is one in which a chunk ran while a live lane
        got no token from any call of the step; it is counted here, once,
        so a window's split does not count the sibling call's lanes as
        stalled (the reference counts them, per call)."""
        covered = set(decode_lanes) | set(plan)
        if plan and any(self._mirror["live"][j] for j in self.active_lanes
                        if j not in covered):
            self.stats["stalled_decode_steps"] += 1
        gens = sorted({self.lanes[i].gen for i in decode_lanes}
                      | {self.lanes[i].gen for i in plan})
        if len(gens) <= 1:
            params = self._gen_params[gens[0]] if gens else self.params
            self._mixed_call(decode_lanes, plan, params)
            return
        for g in gens:
            dl = [i for i in decode_lanes if self.lanes[i].gen == g]
            pl = {i: c for i, c in plan.items() if self.lanes[i].gen == g}
            if dl or pl:
                self._mixed_call(dl, pl, self._gen_params[g], split=True)

    def _mixed_call(self, decode_lanes: list[int], plan: dict[int, int],
                    params, split: bool = False) -> None:
        """One fused decode+prefill call with ``params``: decode lanes give one token each
        (q_len 1 at their frontier), ``plan`` lanes a prompt chunk (q_len c
        at their prefill position), padded to a power-of-two width. The
        host folds the next tokens: decode lanes advance with the slab's
        stop logic, prefill lanes advance their prompt position and go
        live when the tail lands (their token is the request's first).
        The host reads the result only when some lane emits a token, so
        calls that carry only mid-prompt chunks queue without a sync (a
        fault in such a chunk poisons the KV it wrote, so the lane's next
        emitting call still catches it). With no decode lane (the phased
        tail prefill) the call time is prefill time. ``split`` (one call
        of several generations) masks the poison to this call's lanes and
        clears only theirs, so a poison aimed at another generation's
        lane reaches that lane's call."""
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
        r = _pow2_bucket(self.pool.slots_for(need), self.max_pages)
        if self._faults is not None:
            self._faults.on_device_step(self._step_idx - 1, self)
        if split:
            pmask = np.zeros(self.max_batch, bool)
            pmask[list(covered)] = True
            poison = np.where(pmask, m["poison"], np.float32(0.0))
        else:
            poison = m["poison"]
        t0 = time.monotonic()
        nxt, faulted, self.cache = self._mixed_fn(
            params, self.cache, self._tensor(tokens),
            self._tensor(starts), self._tensor(q_lens),
            self._tensor(m["offsets"]), self._tensor(m["bt"]),
            read_pages=r, poison=self._tensor(poison))
        if split:
            m["poison"] = np.where(pmask, np.float32(0.0), m["poison"])
        else:
            m["poison"][:] = 0.0     # one-shot, like the slab's
        fa = None
        if decode_lanes or any(self._prefilling[i] + c
                               >= self.lanes[i].req.prompt_len
                               for i, c in plan.items()):
            nxt = nxt.cpu().numpy()                        # host sync
            fa = faulted.cpu().numpy()
        now = time.monotonic()
        if self.tracer.enabled:
            self.tracer.span_at(
                "mixed.step", t0, now, decode_lanes=len(decode_lanes),
                prefill_lanes=len(plan), prefill_tokens=sum(plan.values()),
                uids=[self.lanes[i].req.uid for i in covered])
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
        """Drain the queue, the lanes and the preempted lanes;
        {uid: GenResult}, every data group's under a data axis (a
        collective over the batch axes)."""
        out: dict[int, GenResult] = {}
        while (len(self.scheduler) or self.active_lanes or self._preempted
               or self._pending_results):
            for r in self.step():
                out[r.uid] = r
        self.check_lockstep()
        self.finalize_stats()
        if self.data is not None:
            got = self.data.gather_objects((out, self.lockstep_digest))
            self.data_group_digests = [d for _, d in got]
            out = {u: r for part, _ in got for u, r in part.items()}
        return out

    def finalize_stats(self) -> dict:
        """Fold the counters into derived stats: decode throughput (decode
        tokens over decode time, fused mixed calls included; e2e adds
        prefill time and counts every token), TTFT and
        inter-token percentiles, KV peaks, the host store's peak and
        budget, and the prefix-cache hit rate."""
        st = self.stats
        dec_s = st["decode_s"] + st["mixed_s"]
        st["tok_per_s"] = st["decode_tokens"] / dec_s if dec_s > 0 else 0.0
        total_s = dec_s + st["prefill_s"]
        st["e2e_tok_per_s"] = (st["generated_tokens"] / total_s
                               if total_s > 0 else 0.0)
        for name, vals in (("ttft", self._ttft), ("itl", self._itl)):
            arr = np.asarray(vals, np.float64)
            for q in (50, 95):
                st[f"{name}_p{q}_s"] = (float(np.percentile(arr, q))
                                        if arr.size else 0.0)
        if self.paged:
            st["peak_kv_pages"] = self.pool.peak_in_use
            # pages live lanes pin at once, shared pages counted once
            st["peak_kv_bytes_referenced"] = (self.pool.peak_referenced
                                              * self.page_bytes)
            st["offload_bytes_peak"] = max(st["offload_bytes_peak"],
                                           self._offload.bytes_peak)
            st["offload_capacity_bytes"] = self._offload.capacity_bytes or 0
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
             prefill_token_budget: int | None = None, tracer=None,
             device="cuda", dist=None):
    """Ragged 1-D prompts -> (list of per-request token arrays, stats).
    A request that runs out of cache returns fewer than
    ``max_new_tokens`` tokens (``stats["truncated"]`` counts them).
    ``tracer`` and ``dist`` go to the ``Engine``."""
    prompts = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    max_len = max_len or (max(p.size for p in prompts) + max_new_tokens)
    eng = Engine(cfg, params, max_batch=max_batch or len(prompts),
                 max_len=max_len, prefill_chunk=prefill_chunk,
                 slab_k=slab_k, eos_id=eos_id, paged=paged,
                 page_size=page_size, n_pages=n_pages,
                 prefix_cache=prefix_cache, mixed=mixed,
                 prefill_token_budget=prefill_token_budget, tracer=tracer,
                 device=device, dist=dist)
    uids = [eng.submit(p, max_new_tokens) for p in prompts]
    res = eng.run()
    return [res[u].tokens for u in uids], eng.stats


_REFUSED = ("{} under dist= is not ported: tensor-parallel serving takes "
            "the paged engine, phased or mixed, with the prefix cache "
            "(ROADMAP §1 item 4)")


def _refuse_under_dist(cfg, dist, *, paged, preempt, enforce_deadlines,
                       faults, scheduler) -> None:
    """Raise for every engine option this slice does not serve
    tensor-parallel (the module docstring's list)."""
    check_serving(cfg, dist)
    for on, what in ((not paged, "the contiguous cache (paged=False)"),
                     (preempt, "preemption"),
                     (enforce_deadlines, "deadlines"),
                     (faults is not None, "fault plans"),
                     (isinstance(scheduler, SLAScheduler),
                      "SLA scheduling")):
        if on:
            raise NotImplementedError(_REFUSED.format(what))
