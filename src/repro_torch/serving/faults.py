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

Every fault that fires adds one to the engine's ``faults_injected``.

``FaultPlan.on_artifact(d, kind)`` corrupts a sealed artifact directory
with one of the ``ARTIFACT_FAULTS`` injectors (one per corruption class
of serving/artifact.py) and returns the typed ``ArtifactError`` the
corruption must raise at validate or canary time.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpointing.checkpoint import (crc32_array, decode_leaf,
                                                  encode_leaf)


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

    def on_artifact(self, d: str, kind: str) -> type:
        """Corrupt the sealed artifact at ``d`` with injector ``kind`` (see
        ``ARTIFACT_FAULTS``) and audit it. Returns the ``ArtifactError``
        subclass the corruption must raise."""
        expected = ARTIFACT_FAULTS[kind](d)
        self.fired.append(f"artifact:{kind}")
        return expected

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


# ----------------------------------------------- artifact corruption
# One injector per corruption class of the sealed-artifact layer
# (serving/artifact.py). Each takes an artifact directory, mutates it in
# place, and returns the typed ArtifactError subclass that validate() or
# load(run_canaries=True) must raise. The *_signed kinds recompute the
# checksum manifest after corrupting (a toolchain bug or an attacker that
# re-signs), so the structural and canary layers must catch what the
# byte layer cannot.

def _art_load(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        stored = {k: np.array(z[k]) for k in z.files}
    return manifest, stored


def _art_write(d, manifest, stored, resign=False):
    if resign:
        manifest["checksums"] = {k: crc32_array(v)
                                 for k, v in stored.items()}
    np.savez(os.path.join(d, "arrays.npz"), **stored)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _art_mutate(stored, manifest, key, fn):
    """Apply ``fn`` (float32 ndarray -> ndarray) to a stored array through
    its true dtype (bfloat16 leaves live in the npz as uint16 bits; the
    result rounds back to nearest even)."""
    arr = stored[key]
    if manifest["dtypes"][key] == "bfloat16":
        vals = decode_leaf(arr.copy(), "bfloat16").float().numpy()
        out = torch.from_numpy(np.asarray(fn(vals), np.float32))
        stored[key], _ = encode_leaf(out.to(torch.bfloat16))
    else:
        stored[key] = np.asarray(fn(arr), arr.dtype)


def _first_packed(manifest):
    return sorted(manifest["packed"])[0]


def _bitflip(d, suffix):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    a = stored[f"{_first_packed(manifest)}/{suffix}"]
    flat = a.reshape(-1).view(np.uint8)
    flat[len(flat) // 2] ^= np.uint8(1)
    _art_write(d, manifest, stored)
    return art.ArtifactChecksumError


def _fault_idx_bitflip(d):
    return _bitflip(d, "idx")


def _fault_block_bitflip(d):
    return _bitflip(d, "blocks")


def _fault_leaf_truncate(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    del stored[f"{_first_packed(manifest)}/blocks"]
    _art_write(d, manifest, stored)
    return art.ArtifactChecksumError


def _fault_config_mismatch(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    manifest["fingerprint"] = "0" * 64
    _art_write(d, manifest, stored)
    return art.ArtifactConfigError


def _fault_idx_oob_signed(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    path = _first_packed(manifest)
    kb = int(manifest["packed"][path]["kb"])
    stored[f"{path}/idx"].reshape(-1)[0] = kb + 7   # past the block-rows
    _art_write(d, manifest, stored, resign=True)
    return art.ArtifactStructureError


def _fault_idx_dup_signed(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    path = _first_packed(manifest)
    idx = stored[f"{path}/idx"]
    nnz = idx.shape[-1]
    if nnz < 2:
        raise ValueError("the duplicate fault needs nnz >= 2")
    flat = idx.reshape(-1, nnz)
    flat[0, 1] = flat[0, 0]             # one block-row twice in column 0
    # both duplicate slots must carry data for the double-count hazard
    _art_mutate(stored, manifest, f"{path}/blocks",
                lambda b: np.where(b == 0, np.float32(0.25), b))
    _art_write(d, manifest, stored, resign=True)
    return art.ArtifactStructureError


def _fault_nan_block_signed(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)

    def poison(b):
        b.reshape(-1)[0] = np.nan
        return b
    _art_mutate(stored, manifest, f"{_first_packed(manifest)}/blocks",
                poison)
    _art_write(d, manifest, stored, resign=True)
    return art.ArtifactNonFiniteError


def _fault_joint_break_signed(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    # claim a joint promise on a gate leaf whose idx table then differs
    # from its up partner's: the joint GLU would contract the wrong blocks
    gates = [p for p in manifest["packed"]
             if p.split("/")[-1] in ("w_gate", "ws_gate")]
    if not gates:
        raise ValueError("the joint fault needs a gate leaf")
    path = gates[0]
    manifest["packed"][path]["joint"] = True
    idx = stored[f"{path}/idx"]
    uidx = stored.get(f"{path.replace('gate', 'up')}/idx")
    if uidx is not None and np.array_equal(idx, uidx):
        kb = int(manifest["packed"][path]["kb"])
        idx.reshape(-1)[0] = (int(idx.reshape(-1)[0]) + 1) % kb
    _art_write(d, manifest, stored, resign=True)
    return art.ArtifactStructureError


def _fault_canary_weights_signed(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    # structurally sound, finite, correctly signed: only the golden
    # generations can tell these weights are not the sealed ones
    _art_mutate(stored, manifest, f"{_first_packed(manifest)}/blocks",
                lambda b: b * 1.5)
    _art_write(d, manifest, stored, resign=True)
    return art.ArtifactCanaryError


def _fault_canary_tamper(d):
    from repro_torch.serving import artifact as art
    manifest, stored = _art_load(d)
    manifest["canaries"][0]["tokens"][0] += 1
    _art_write(d, manifest, stored)
    return art.ArtifactChecksumError


ARTIFACT_FAULTS = {
    "idx_bitflip": _fault_idx_bitflip,
    "block_bitflip": _fault_block_bitflip,
    "leaf_truncate": _fault_leaf_truncate,
    "config_mismatch": _fault_config_mismatch,
    "idx_oob_signed": _fault_idx_oob_signed,
    "idx_dup_signed": _fault_idx_dup_signed,
    "nan_block_signed": _fault_nan_block_signed,
    "joint_break_signed": _fault_joint_break_signed,
    "canary_weights_signed": _fault_canary_weights_signed,
    "canary_tamper": _fault_canary_tamper,
}
