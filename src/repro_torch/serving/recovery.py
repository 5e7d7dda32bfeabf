"""Crash recovery: rebuild a dead engine's device state and keep its work
(port of ``repro/serving/recovery.py``).

What recovery may trust. The reference's steps are functional (``cache =
step(cache)`` rebinds only on success), so a dead step leaves the last
host sync's snapshot intact. The port updates its caches in place and
its slab is a loop of ``slab_k`` steps, so a step that dies partway
leaves writes behind. The host state is still that snapshot, because the
host mirror (frontiers, pending tokens, budgets, block tables) and the
lanes' token lists change only when a call's results are folded in after
its sync. And every write a dead call can have made lands where salvage
does not read, or where nothing is read before it is written again:

  * a decode lane writes at slots >= its mirrored frontier (the slab
    advances from there; the mixed step writes at the frontier);
  * a dead lane writes at the park slot, past its block table, dropped;
  * a prefilling lane writes in its own pages, and a lane whose prefill
    has not landed relaunches (below);
  * a copy-on-write copy writes a freshly allocated page, which a lane
    owns only once the admission completed.

Salvage copies pages covering slots ``[0, frontier)``; a slot >= the
frontier in its last page may hold a dead call's write, but a restored
lane writes slot ``frontier`` before it reads it and masks the slots
after it. Shared pages are never written (a lane copies its boundary
page first).

``Supervisor.recover`` turns that snapshot back into a running engine:

  1. **salvage** — every live decode lane whose prefill landed has its
     pages ``[0, frontier)`` downloaded to the host store and is parked
     as a ``_Preempted`` record (``recovered=True``) with its decode
     state; restore resumes at the saved frontier with no re-prefilled
     token. Skipped when the fault lost the device (``device_lost``);
  2. **relaunch** — lanes that could not be salvaged (device lost,
     mid-prefill, host store full) are re-queued at the head as
     ``prompt + emitted`` with the budget left; greedy decode is
     deterministic, so the continuation is the dead lane's, and results
     are re-split at the original prompt (``_recovered_prefix``). A
     salvaged or relaunched lane keeps the weight generation it was
     admitted under (the record's ``gen``, or a pin in
     ``Engine._gen_pins``), so a crash inside a hot-swap window resumes
     each stream on its own weights;
  3. **rebuild** — a fresh pool, zeroed cache, slab state and prefix
     cache; earlier preempted records keep their host KV (pages they
     held pinned on the device are salvaged into the record first, or
     the request relaunches if the device is gone);
  4. lanes that had finished but were not yet swept become normal
     results.

Queued requests are host state and stay queued. A broken CUDA context
(a sticky error such as an illegal address) cannot be recovered in the
process: ``recover`` then raises ``EngineCrashError(device_lost=True)``
without rebuilding. The watchdog of ``serving/frontend.py`` is the usual
caller. Before anything is touched, ``recover`` dumps the engine tracer's
flight recorder as a ``supervisor_recover`` postmortem (the uids on lanes
at the crash in its meta), and it records a ``recovery`` span.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.serving.engine import GenResult, _Preempted
from repro_torch.serving.faults import (EngineCrashError, LaneFaultError,
                                        OffloadCapacityError)
from repro_torch.serving.pages import PagePool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request


class Supervisor:
    """Owns crash recovery for one engine (see module docstring)."""

    def __init__(self, engine):
        if getattr(engine, "dist", None) is not None:
            from repro_torch.serving.engine import _REFUSED
            raise NotImplementedError(_REFUSED.format(
                "crash recovery"))
        self.engine = engine

    def _classify_lanes(self, device_lost: bool, results: list,
                        relaunch: list, salvaged: list) -> int:
        """Sort the lanes into finished results, quarantines, salvaged
        records and relaunches. Returns the bytes salvaged."""
        eng = self.engine
        m = eng._mirror
        nbytes = 0
        for i in eng.active_lanes:
            lane = eng.lanes[i]
            req, gen = lane.req, lane.generated
            done = (len(gen) >= req.max_new_tokens
                    or (eng.eos_id is not None and gen
                        and gen[-1] == eng.eos_id))
            trunc = not done and int(m["frontier"][i]) >= eng.max_len
            if done or trunc:
                # finished before the crash; the sweep never reached it
                prompt, full = req.prompt, list(gen)
                pre = eng._recovered_prefix.pop(req.uid, None)
                if pre is not None:
                    prompt, full = pre[0], list(pre[1]) + full
                tt = lane.token_times
                ttft = max(0.0, tt[0] - req.queued_at) if tt else 0.0
                results.append(GenResult(req.uid, prompt,
                                         np.asarray(full, np.int32),
                                         truncated=trunc, ttft_s=ttft))
                continue
            if m["faulted"][i]:
                # the finite check flagged it but the crash beat the
                # harvest: quarantine now
                eng.stats["lanes_quarantined"] += 1
                results.append(eng._failed_result(
                    req, gen, LaneFaultError(req.uid, i)))
                continue
            # a lane whose first token has not landed (its prefill died
            # with the step) has no trusted KV: it relaunches
            if (eng.paged and not device_lost and m["live"][i]
                    and i not in eng._prefilling and gen):
                n_live = eng.pool.slots_for(int(m["frontier"][i]))
                try:
                    k, v = eng._download_pages(lane.pages[:n_live])
                    eng._offload.save(req.uid, list(range(n_live)), k, v)
                except (OffloadCapacityError, RuntimeError):
                    # host store full, or the download failed: relaunch
                    relaunch.append((req, list(gen), lane.gen))
                    continue
                eng.stats["offloaded_pages"] += n_live
                nbytes += 2 * k.numel() * k.element_size()
                salvaged.append(_Preempted(
                    req=req, offset=lane.offset, generated=gen,
                    token_times=lane.token_times,
                    pending=int(m["pending"][i]),
                    frontier=int(m["frontier"][i]),
                    remaining=int(m["remaining"][i]),
                    n_pages=len(lane.pages), pinned={}, recovered=True,
                    gen=lane.gen))
                continue
            relaunch.append((req, list(gen), lane.gen))
        return nbytes

    def _resolve_preempted(self, device_lost: bool,
                           relaunch: list) -> list:
        """Earlier preempted records survive on the host; those holding
        pinned shared pages on the device get them downloaded (device
        alive) or relaunch (device lost)."""
        eng = self.engine
        keep = []
        for pre in eng._preempted:
            if not pre.pinned:
                keep.append(pre)
                continue
            if not device_lost:
                logical = sorted(pre.pinned)
                pages = [pre.pinned[j] for j in logical]
                try:
                    k, v = eng._download_pages(pages)
                    if pre.req.uid in eng._offload:
                        eng._offload.extend(pre.req.uid, logical, k, v)
                    else:
                        eng._offload.save(pre.req.uid, logical, k, v)
                except (OffloadCapacityError, RuntimeError):
                    pass
                else:
                    eng.stats["offloaded_pages"] += len(pages)
                    pre.pinned = {}
                    keep.append(pre)
                    continue
            eng._offload.drop(pre.req.uid)
            relaunch.append((pre.req, list(pre.generated), pre.gen))
        return keep

    def _rebuild(self, keep_preempted: list) -> None:
        eng = self.engine
        dtype = eng.cache["k"].dtype
        if eng.paged:
            eng.pool = PagePool(eng.n_pages, eng.page_size)
            if eng._faults is not None:
                eng.pool.fault_hook = eng._faults.on_alloc
            eng.cache = registry.init_paged_cache(
                eng.cfg, eng.n_pages, eng.page_size, dtype=dtype,
                device=eng.device)
            if eng.pcache is not None:
                # the old radix tree indexed pages of the dead pool
                eng.pcache = PrefixCache(eng.pool)
        else:
            eng.cache = registry.init_cache(eng.cfg, eng.max_batch,
                                            eng.max_len, dtype=dtype,
                                            device=eng.device)
        eng.lanes = [None] * eng.max_batch
        for key in eng._mirror:
            eng._mirror[key][:] = 0
        eng._prefilling.clear()
        eng._preempted = keep_preempted
        eng._dstate = None
        eng._dirty = True
        eng._condemned.clear()

    def _relaunch(self, relaunch: list) -> None:
        eng = self.engine
        reqs, deadlines = [], []
        for req, emitted, gen in relaunch:
            # remember the original split; it chains across repeated
            # crashes (the prompt may already hold earlier emissions)
            orig, prev = eng._recovered_prefix.get(req.uid,
                                                   (req.prompt, []))
            eng._recovered_prefix[req.uid] = (orig,
                                              list(prev) + list(emitted))
            # a relaunch re-prefills and goes on under its admission-time
            # weights: greedy determinism (the bitwise recovery promise)
            # holds only within one generation; the pin goes when the
            # lane retires
            eng._gen_pins[req.uid] = gen
            nr = Request(
                req.uid,
                np.concatenate([req.prompt,
                                np.asarray(emitted, np.int32)]),
                req.max_new_tokens - len(emitted),
                priority=req.priority, deadline_s=req.deadline_s)
            eng.stats["re_prefilled_tokens"] += nr.prompt_len
            reqs.append(nr)
            deadlines.append(req.deadline_at)
        eng.scheduler.reinstate(reqs)
        for nr, dl in zip(reqs, deadlines):
            if dl is not None:
                nr.deadline_at = dl   # the SLA clock does not reset

    @torch.inference_mode()
    def recover(self, exc: BaseException) -> dict:
        """Rebuild the engine after its stepper died with ``exc``. Returns
        a summary (latency, lanes salvaged, relaunched and finished,
        bytes salvaged); requests that had already finished join the
        engine's pending results. Safe to call again: each call recovers
        the current snapshot."""
        eng = self.engine
        device_lost = bool(getattr(exc, "device_lost", False))
        # the flight recorder holds the last N spans before the crash:
        # freeze them first (a broken CUDA context below included), so the
        # rebuild, which clears the lanes, cannot disturb the timeline
        eng.tracer.postmortem(
            "supervisor_recover", error=type(exc).__name__,
            device_lost=device_lost,
            active_uids=[eng.lanes[i].req.uid for i in eng.active_lanes])
        if eng.device.type == "cuda":
            try:
                torch.cuda.synchronize(eng.device)
            except RuntimeError as e:
                raise EngineCrashError(
                    f"CUDA context is broken, not recoverable in this "
                    f"process: {e}", device_lost=True) from e
        t0 = time.monotonic()
        results: list = []
        relaunch: list = []
        salvaged: list = []
        nbytes = self._classify_lanes(device_lost, results, relaunch,
                                      salvaged)
        keep = (self._resolve_preempted(device_lost, relaunch)
                if eng.paged else [])
        self._rebuild(keep + salvaged)
        self._relaunch(relaunch)
        eng._pending_results.extend(results)
        eng.stats["recoveries"] += 1
        if eng.paged:
            eng.stats["offload_bytes_peak"] = max(
                eng.stats["offload_bytes_peak"], eng._offload.bytes_peak)
        latency = time.monotonic() - t0
        if eng.tracer.enabled:
            eng.tracer.span_at("recovery", t0, t0 + latency,
                               error=type(exc).__name__,
                               device_lost=device_lost,
                               salvaged=len(salvaged),
                               relaunched=len(relaunch))
        return {"latency_s": latency,
                "device_lost": device_lost,
                "salvaged_lanes": len(salvaged),
                "salvaged_bytes": nbytes,
                "relaunched_lanes": len(relaunch),
                "finished_lanes": len(results)}
