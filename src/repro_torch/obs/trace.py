"""Request-span tracing with a bounded flight recorder (port of
``repro/obs/trace.py``).

The serving and training hot paths sync with the host once per slab or
step, and the tracer adds no sync of its own: instrumented code hands
``span_at`` the ``t0``/``now`` monotonic timestamps it already took around
its device calls and their host read, and the tracer only remembers
them::

    tr.span_at("decode.slab", t0, now, lanes=4, k=8)     # completed span
    tr.event("request.finish", uid=3, tokens=17)         # point event
    with tr.span("ckpt.save", step=40):                  # host-only phase
        ...

Completed spans and events land in a ``deque(maxlen=capacity)``, the
flight recorder. Appends are atomic under the GIL, so the engine thread,
the asyncio front end, the watchdog and the ``/metrics`` thread share one
tracer without a lock; every read takes a snapshot (``list(...)``) first.
When a crash path fires (watchdog, supervisor, hot-swap rollback,
training rewind), ``postmortem()`` freezes the ring into a JSON dump: the
last N things that happened, the victim request's uid threaded through
its spans.

``NULL_TRACER`` is the disabled default. Its methods are no-ops that never
touch ``Span``, and instrumented sites that would build attribute
collections guard on ``tracer.enabled``, so an untraced engine does the
same work as one without tracing.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque


class Span:
    """One completed span (or point event: ``t1 == t0``): monotonic
    timestamps and small attrs (uids, counts, error names)."""
    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float, attrs: dict):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "attrs": self.attrs}

    def __repr__(self):
        return (f"Span({self.name!r}, t0={self.t0:.6f}, "
                f"dur={self.dur:.6f}, {self.attrs})")


class _SpanCtx:
    """Context manager for host-only phases (checkpoint restores) where
    the span may read the clock itself: they run between device calls,
    never inside the hot loop. An exception leaves its type name in the
    span's ``error`` attr and propagates."""
    __slots__ = ("_tr", "_name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tr = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = self._tr.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._attrs["error"] = exc_type.__name__
        self._tr.span_at(self._name, self._t0, self._tr.clock(),
                         **self._attrs)
        return False


class Tracer:
    """Span recorder, flight recorder and postmortem dumper.

    ``capacity`` bounds the ring (one small object per slab, step or
    event, not per token). ``postmortem_dir`` (optional) is where
    ``postmortem()`` writes its JSON dumps; the payloads also collect on
    ``self.postmortems``."""

    enabled = True

    def __init__(self, capacity: int = 4096,
                 postmortem_dir: str | None = None,
                 clock=time.monotonic):
        self.capacity = capacity
        self.clock = clock
        self.postmortem_dir = postmortem_dir
        self.records: deque[Span] = deque(maxlen=capacity)
        self.postmortems: list[dict] = []
        self._pm_seq = 0

    # -------------------------------------------------------- recording
    def span_at(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a span from timestamps the caller already took at its
        own host syncs."""
        self.records.append(Span(name, t0, t1, attrs))

    def event(self, name: str, t: float | None = None, **attrs) -> None:
        """Point event (admission, finish, preempt, quarantine...); ``t``
        defaults to now: events fire from host control flow, never
        between a device call and its read."""
        if t is None:
            t = self.clock()
        self.records.append(Span(name, t, t, attrs))

    def span(self, name: str, **attrs) -> _SpanCtx:
        return _SpanCtx(self, name, attrs)

    # ---------------------------------------------------- flight recorder
    def snapshot(self) -> list[dict]:
        """The ring as JSON-able dicts, oldest first, read from a copy of
        the deque (safe against the engine thread's appends)."""
        return [s.to_dict() for s in list(self.records)]

    def spans_for(self, uid) -> list[dict]:
        """A request's timeline: every retained span or event whose attrs
        carry ``uid`` (as ``uid`` or in a ``uids`` list)."""
        out = []
        for s in list(self.records):
            a = s.attrs
            if a.get("uid") == uid or uid in (a.get("uids") or ()):
                out.append(s.to_dict())
        return out

    def postmortem(self, reason: str, **meta) -> dict:
        """Freeze the flight recorder into a crash dump: appended to
        ``self.postmortems`` and, with a ``postmortem_dir``, written as
        ``postmortem_<seq>_<reason>.json``. An ``OSError`` while writing
        is swallowed, so a failing dump does not mask the crash it
        reports."""
        payload = {
            "reason": reason,
            "wall_time_unix": time.time(),
            "monotonic": self.clock(),
            "meta": meta,
            "spans": self.snapshot(),
        }
        self.postmortems.append(payload)
        if self.postmortem_dir is not None:
            try:
                os.makedirs(self.postmortem_dir, exist_ok=True)
                fname = f"postmortem_{self._pm_seq:04d}_{reason}.json"
                with open(os.path.join(self.postmortem_dir, fname),
                          "w") as f:
                    json.dump(payload, f, indent=2, default=str)
            except OSError:
                pass
        self._pm_seq += 1
        return payload

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> dict:
        from repro_torch.obs.export import to_chrome_trace
        return to_chrome_trace(list(self.records))


class _NullCtx:
    """Shared reusable no-op context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CTX = _NullCtx()


class _NullTracer:
    """Tracing off: every method is a no-op that constructs no ``Span``
    (nor anything else)."""

    enabled = False
    records = ()          # empty, iterable, immutable
    postmortems = ()

    def span_at(self, name, t0, t1, **attrs) -> None:
        pass

    def event(self, name, t=None, **attrs) -> None:
        pass

    def span(self, name, **attrs) -> _NullCtx:
        return _NULL_CTX

    def snapshot(self) -> list:
        return []

    def spans_for(self, uid) -> list:
        return []

    def postmortem(self, reason, **meta) -> None:
        return None

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACER = _NullTracer()
