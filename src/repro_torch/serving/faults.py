"""Deterministic fault injection and the serving failure taxonomy (port of
``repro/serving/faults.py``).

A fault must cost one request, not the batch: a non-finite logit, a hung
step or an exception on the engine thread must not kill every in-flight
request. ``FaultPlan`` is the seeded substrate chaos tests drive that
with; the error types are the one vocabulary every failure path raises.

Fault points, keyed by the engine step index (one ``Engine.step`` call,
the finest deterministic granularity):

  * ``poison_logits(step, lane)`` — NaN/Inf into one lane's logits at
    the first in-slab decode step (or the mixed call) of that step; the
    per-lane finite check must quarantine only that lane;
  * ``fail_alloc(step)`` — the next page allocation raises (an
    engine-thread crash);
  * ``crash(step)`` — raise from the step: host-side
    (``device_lost=False``: device KV intact, recovery may salvage it) or
    simulated device loss (``device_lost=True``: all device KV is gone);
  * ``stall(step, seconds)`` — the step hangs until the watchdog condemns
    the engine, then aborts with ``EngineHangError`` (a host-side poll:
    an in-process watchdog cannot kill a running CUDA call);
  * ``corrupt_offload(nth_save)`` — flip one bit of the nth record saved
    to the host offload store after its checksums were computed; the
    restore-side verify must fail only that request.

Every fault that fires adds one to the engine's ``faults_injected``. The
artifact corruption helpers of the reference are not ported here.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


# --------------------------------------------------------------- errors
class ServingFault(Exception):
    """Base class for every structured serving failure."""


class LaneFaultError(ServingFault):
    """One lane produced non-finite logits (or its restored KV failed
    verification): only this request fails; its lane is quarantined, its
    pages freed and never donated to the prefix cache."""

    def __init__(self, uid: int, lane: int,
                 reason: str = "non-finite logits"):
        self.uid, self.lane, self.reason = uid, lane, reason
        super().__init__(f"request {uid} quarantined on lane {lane}: "
                         f"{reason}")


class EngineCrashError(ServingFault):
    """The engine stepper died; ``device_lost`` says whether device KV
    survived (host-side crash) or not (device loss)."""

    def __init__(self, msg: str = "engine step crashed",
                 device_lost: bool = False):
        self.device_lost = device_lost
        super().__init__(msg)


class EngineHangError(EngineCrashError):
    """A step overran the watchdog's deadline and the supervisor
    condemned the engine (host arrays survive)."""

    def __init__(self, msg: str = "engine step exceeded the watchdog "
                 "deadline"):
        super().__init__(msg, device_lost=False)


class OffloadCorruptionError(ServingFault):
    """A host-offloaded KV page failed its checksum on restore."""

    def __init__(self, uid: int, logical: list[int]):
        self.uid, self.logical = uid, list(logical)
        super().__init__(
            f"offloaded KV for request {uid} failed checksum on "
            f"logical page(s) {self.logical}")


class OffloadCapacityError(ServingFault):
    """The host offload store's byte budget cannot hold another record;
    the preemption (or crash salvage) that needed it falls back."""

    def __init__(self, needed: int, capacity: int, used: int):
        self.needed, self.capacity, self.used = needed, capacity, used
        super().__init__(
            f"host KV store over capacity: record of {needed} bytes "
            f"does not fit ({used} of {capacity} bytes used)")


class BackpressureError(ServingFault):
    """Load shedding: the admission queue is at its bound; retry after
    ``retry_after_s`` (a service-rate estimate, not a promise)."""

    def __init__(self, queue_depth: int, limit: int,
                 retry_after_s: float):
        self.queue_depth, self.limit = queue_depth, limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"admission queue full ({queue_depth} >= {limit}); "
            f"retry after {retry_after_s:.2f}s")


class RequestCancelledError(ServingFault):
    """The request was cancelled (client cancel or engine shutdown)."""

    def __init__(self, uid: int, reason: str = "cancelled"):
        self.uid, self.reason = uid, reason
        super().__init__(f"request {uid} {reason}")


class DeadlineExceededError(RequestCancelledError):
    """The request's SLA deadline passed while it was still decoding; the
    engine cancelled it at the next host sync."""

    def __init__(self, uid: int):
        super().__init__(uid, "cancelled: SLA deadline exceeded "
                              "mid-decode")


# ------------------------------------------------------------ the plan
@dataclasses.dataclass
class _Poison:
    step: int
    lane: int
    kind: str          # "nan" | "inf"


@dataclasses.dataclass
class _Crash:
    step: int
    device_lost: bool


@dataclasses.dataclass
class _Stall:
    step: int
    seconds: float


class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    Arm faults at engine-step indices and hand the plan to
    ``Engine(faults=plan)`` or ``engine.install_faults(plan)``. The plan
    is consumed as it fires, so an A/B pair needs two plans built alike.
    ``rng`` (from ``seed``) is for tests that draw their targets; the
    plan never draws from it itself. ``fired`` audits, in order, every
    fault that fired."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._poisons: list[_Poison] = []
        self._crashes: list[_Crash] = []
        self._stalls: list[_Stall] = []
        self._alloc_steps: set[int] = set()
        self._alloc_armed = False
        self._corrupt_saves: dict[int, int] = {}   # nth save -> bit
        self._n_saves = 0
        self._engine = None            # set by Engine.install_faults
        self.fired: list[str] = []

    # ----------------------------------------------------------- arming
    def poison_logits(self, step: int, lane: int,
                      kind: str = "nan") -> "FaultPlan":
        if kind not in ("nan", "inf"):
            raise ValueError(f"poison kind {kind!r} is not nan or inf")
        self._poisons.append(_Poison(step, lane, kind))
        return self

    def fail_alloc(self, step: int) -> "FaultPlan":
        self._alloc_steps.add(step)
        return self

    def crash(self, step: int, device_lost: bool = False) -> "FaultPlan":
        self._crashes.append(_Crash(step, device_lost))
        return self

    def stall(self, step: int, seconds: float) -> "FaultPlan":
        self._stalls.append(_Stall(step, seconds))
        return self

    def corrupt_offload(self, nth_save: int = 0,
                        bit: int = 0) -> "FaultPlan":
        self._corrupt_saves[nth_save] = bit
        return self

    # ------------------------------------------------------ engine hooks
    def on_step(self, idx: int, engine) -> None:
        """At the top of ``Engine.step``, before any mutation: arms this
        step's logit poison into the host mirror, arms a one-shot
        allocation failure, and raises host-side crashes. Device-loss
        crashes and stalls fire at the device call (``on_device_step``)."""
        for p in [p for p in self._poisons if p.step == idx]:
            self._poisons.remove(p)
            engine._mirror["poison"][p.lane] = (np.nan if p.kind == "nan"
                                                else np.inf)
            engine._dirty = True
            engine.stats["faults_injected"] += 1
            self.fired.append(f"poison:{p.kind}@{idx}:lane{p.lane}")
        if idx in self._alloc_steps:
            self._alloc_steps.discard(idx)
            self._alloc_armed = True
            engine.stats["faults_injected"] += 1
            self.fired.append(f"alloc_fail@{idx}")
        for c in [c for c in self._crashes
                  if c.step == idx and not c.device_lost]:
            self._crashes.remove(c)
            engine.stats["faults_injected"] += 1
            self.fired.append(f"crash:host@{idx}")
            raise EngineCrashError(
                f"injected host-side crash at step {idx}",
                device_lost=False)

    def on_device_step(self, idx: int, engine) -> None:
        """Just before a slab or mixed call: simulated device loss raises;
        a stall sleeps until the deadline, aborting with
        ``EngineHangError`` as soon as the supervisor condemns the engine
        (``engine._condemned``)."""
        for c in [c for c in self._crashes
                  if c.step == idx and c.device_lost]:
            self._crashes.remove(c)
            engine.stats["faults_injected"] += 1
            self.fired.append(f"crash:device@{idx}")
            raise EngineCrashError(
                f"injected device loss at step {idx}", device_lost=True)
        for s in [s for s in self._stalls if s.step == idx]:
            self._stalls.remove(s)
            engine.stats["faults_injected"] += 1
            self.fired.append(f"stall@{idx}:{s.seconds}s")
            deadline = time.monotonic() + s.seconds
            while time.monotonic() < deadline:
                if engine._condemned.is_set():
                    raise EngineHangError()
                time.sleep(min(0.01, s.seconds))

    def on_alloc(self, n: int) -> bool:
        """Page-pool hook (pages.py): True fails this allocation."""
        if self._alloc_armed:
            self._alloc_armed = False
            return True
        return False

    def on_offload_save(self, rec) -> None:
        """Host-store hook (offload.py), called after the checksums were
        computed: flip one bit of the first byte of the record's K."""
        nth = self._n_saves
        self._n_saves += 1
        if nth not in self._corrupt_saves:
            return
        bit = self._corrupt_saves.pop(nth)
        k = rec.k.clone()
        flat = k.reshape(-1).view(torch.uint8)
        flat[0] ^= 1 << (bit % 8)
        rec.k = k
        if self._engine is not None:
            self._engine.stats["faults_injected"] += 1
        self.fired.append(f"bitflip:save{nth}")
