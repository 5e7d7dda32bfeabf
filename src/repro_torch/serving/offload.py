"""Host-side KV offload store for lane preemption and crash recovery (port
of ``repro/serving/offload.py``).

Under page pressure the engine may preempt a low-priority lane: its
exclusively owned pages are downloaded here, released to the pool, and
scattered back into fresh pages when the lane is restored, so decode
resumes at the saved frontier without re-prefilling a token. Crash
recovery (serving/recovery.py) salvages live lanes' KV through the same
store.

Records hold CPU tensors in the pool's own dtype (bf16 by default, which
numpy cannot hold), keyed by request uid, with the logical page indices
they came from. Every page is checksummed: crc32 over its K bytes, then
continued over its V bytes, read through an integer view of the same
width, so the bytes (and so the checksums) equal the reference's for the
same values. Two hard edges, both structured errors (serving/faults.py):

  * ``capacity_bytes`` bounds host residency: a ``save`` that would
    overrun raises ``OffloadCapacityError`` before any bookkeeping, so
    the caller can fall back;
  * a checksum that no longer matches at ``pop`` raises
    ``OffloadCorruptionError`` naming the bad logical pages, failing only
    that request.
"""
from __future__ import annotations

import dataclasses
import zlib

import torch

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.faults import (OffloadCapacityError,
                                        OffloadCorruptionError)

_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bytes(t: torch.Tensor) -> bytes:
    """The raw bytes of a CPU tensor in C order, any dtype."""
    t = t.contiguous()
    return t.view(_WORDS[t.element_size()]).numpy().tobytes()


@dataclasses.dataclass
class OffloadRecord:
    """One preempted lane's host-resident KV: ``logical`` are the block
    table positions the pages cover, in the order of axis 1 of ``k`` and
    ``v`` ((layers, n, page_size, KV, hd) CPU tensors); ``checksums``
    one crc32 per page over its K then V bytes."""
    logical: list[int]
    k: torch.Tensor
    v: torch.Tensor
    checksums: list[int] | None = None

    @property
    def nbytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def page_crc(self, i: int) -> int:
        return zlib.crc32(_bytes(self.v[:, i]),
                          zlib.crc32(_bytes(self.k[:, i])))


class HostKVStore:
    """uid -> OffloadRecord with a byte budget (``capacity_bytes``, None
    for unbounded) and per-page integrity checks. ``bytes_peak`` is the
    high-water of resident bytes; ``fault_hook`` (serving/faults.py) is
    called with each record after its checksums are computed."""

    def __init__(self, capacity_bytes: int | None = None):
        self._recs: dict[int, OffloadRecord] = {}
        self.capacity_bytes = capacity_bytes
        self.bytes_peak = 0
        self.fault_hook = None
        # span tracer (obs/trace.py), installed by the engine
        self.tracer = NULL_TRACER

    def __len__(self) -> int:
        return len(self._recs)

    def __contains__(self, uid: int) -> bool:
        return uid in self._recs

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self._recs.values())

    def _admit(self, add_bytes: int) -> None:
        if (self.capacity_bytes is not None
                and self.nbytes + add_bytes > self.capacity_bytes):
            raise OffloadCapacityError(add_bytes, self.capacity_bytes,
                                       self.nbytes)

    def _seal(self, uid: int, rec: OffloadRecord) -> None:
        rec.checksums = [rec.page_crc(i) for i in range(len(rec.logical))]
        if self.fault_hook is not None:
            self.fault_hook(rec)
        self._recs[uid] = rec
        self.bytes_peak = max(self.bytes_peak, self.nbytes)

    def save(self, uid: int, logical: list[int], k: torch.Tensor,
             v: torch.Tensor) -> None:
        """Stash a lane's downloaded pages (one record per uid). Raises
        ``OffloadCapacityError``, with no state change, when the budget
        cannot hold the record."""
        if uid in self._recs:
            raise ValueError(f"uid {uid} already offloaded")
        if k.shape[1] != len(logical) or v.shape[1] != len(logical):
            raise ValueError(f"{len(logical)} logical pages for K of "
                             f"{tuple(k.shape)} and V of {tuple(v.shape)}")
        rec = OffloadRecord(list(logical), k, v)
        self._admit(rec.nbytes)
        self._seal(uid, rec)
        if self.tracer.enabled:
            self.tracer.event("offload.save", uid=uid,
                              pages=len(logical), bytes=rec.nbytes)

    def pop(self, uid: int) -> OffloadRecord | None:
        """Take and drop the record for ``uid``, verifying every page;
        None when the lane had nothing offloaded (all its live pages were
        pinned shared). A failed verify raises ``OffloadCorruptionError``
        with the record already dropped."""
        rec = self._recs.pop(uid, None)
        if rec is None:
            return None
        if rec.checksums is not None:
            bad = [lg for i, lg in enumerate(rec.logical)
                   if rec.page_crc(i) != rec.checksums[i]]
            if bad:
                self.tracer.event("offload.corrupt", uid=uid,
                                  bad_pages=bad)
                raise OffloadCorruptionError(uid, bad)
        if self.tracer.enabled:
            self.tracer.event("offload.pop", uid=uid,
                              pages=len(rec.logical), bytes=rec.nbytes)
        return rec

    def extend(self, uid: int, logical: list[int], k: torch.Tensor,
               v: torch.Tensor) -> None:
        """Append pages to an existing record (crash salvage of a lane
        whose shared pages stayed pinned on the device at preemption).
        Same capacity and checksum discipline as ``save``."""
        rec = self._recs[uid]
        self._admit(k.numel() * k.element_size()
                    + v.numel() * v.element_size())
        self._seal(uid, OffloadRecord(rec.logical + list(logical),
                                      torch.cat([rec.k, k], dim=1),
                                      torch.cat([rec.v, v], dim=1)))

    def drop(self, uid: int) -> None:
        """Discard a record without restoring it (cancelled request)."""
        self._recs.pop(uid, None)

    def reset_peaks(self) -> None:
        self.bytes_peak = self.nbytes
