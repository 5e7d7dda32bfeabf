"""Chrome trace-event JSON of span timelines (port of
``repro/obs/export.py``).

Open the output in https://ui.perfetto.dev or chrome://tracing. Spans
render as complete ("X") events with microsecond timestamps, point events
(``t1 == t0``) as instants ("i"). Rows (tids) group by request uid when a
span carries one, so each request reads as its own lane; engine-wide
spans (slabs, mixed steps, train steps) land on row 0. A uid that is not
an integer maps to a row through ``hash``, which differs between
processes.
"""
from __future__ import annotations

import json
from typing import Iterable


def _tid(attrs: dict) -> int:
    uid = attrs.get("uid")
    if uid is None:
        return 0
    try:
        return int(uid) + 1          # row 0 is the engine-wide lane
    except (TypeError, ValueError):
        return 1 + (hash(uid) % 997)


def _args(attrs: dict) -> dict:
    # JSON-safe shallow copy: other values are stringified
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [x if isinstance(x, (str, int, float, bool))
                      else str(x) for x in v]
        else:
            out[k] = str(v)
    return out


def chrome_trace_events(spans: Iterable, pid: int = 0) -> list[dict]:
    """Spans (``obs.trace.Span`` or their ``to_dict`` form) -> trace-event
    dicts, monotonic seconds converted to microseconds."""
    out = []
    for s in spans:
        if isinstance(s, dict):
            name, t0, t1, attrs = (s["name"], s["t0"], s["t1"],
                                   s.get("attrs") or {})
        else:
            name, t0, t1, attrs = s.name, s.t0, s.t1, s.attrs
        ev = {"name": name, "pid": pid, "tid": _tid(attrs),
              "ts": t0 * 1e6, "args": _args(attrs)}
        if t1 > t0:
            ev["ph"] = "X"
            ev["dur"] = (t1 - t0) * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"           # thread-scoped instant
        out.append(ev)
    return out


def to_chrome_trace(spans: Iterable, pid: int = 0) -> dict:
    return {"traceEvents": chrome_trace_events(spans, pid=pid),
            "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable, pid: int = 0) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(spans, pid=pid), f)
    return path
