"""Typed metrics registry with a dict view (port of
``repro/obs/metrics.py``).

Every metric is registered once with a kind (counter, gauge, histogram),
and reset, snapshot and Prometheus exposition all walk the registry: a
``reset_stats`` has no second list of names that could miss a new
metric.

``registry.view()`` returns a ``MutableMapping`` over the scalar metrics,
so call sites read and write it as a plain dict::

    stats["decode_tokens"] += k        # counter increment
    stats["queue_depth_peak"] = max(stats["queue_depth_peak"], d)
    dict(stats), stats.update(other), "x" in stats, len(stats)

An unknown key assigned through the view registers itself (an int as a
counter, a float as a gauge), so stats derived at finalize time take the
same reset and exposition path as the declared ones. Values are Python
``int`` or ``float``: a tensor or numpy scalar would misclassify, or
render as its repr in the exposition text.

The engine thread writes while the ``/metrics`` thread reads; each read
takes a snapshot of the registry's dict (``list(...)``) before it walks
it.
"""
from __future__ import annotations

from collections.abc import MutableMapping


class Counter:
    """Monotonic by convention. ``set`` is allowed (finalize overwrites
    derived values); the kind is exposition metadata and reset semantics,
    not an enforcement."""
    kind = "counter"
    __slots__ = ("name", "help", "value", "_zero")

    def __init__(self, name: str, help: str = "", value=0):
        self.name = name
        self.help = help
        self.value = value
        self._zero = value

    def inc(self, delta=1):
        self.value += delta

    def set(self, value):
        self.value = value

    def reset(self):
        self.value = self._zero

    def get(self):
        return self.value


class Gauge(Counter):
    """A point-in-time scalar (peaks, rates, derived stats)."""
    kind = "gauge"
    __slots__ = ()


class Histogram:
    """Sample-keeping distribution (latency lists) of Python floats;
    percentiles are folded at read time, never on the hot path."""
    kind = "histogram"
    __slots__ = ("name", "help", "samples")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.samples: list[float] = []

    def observe(self, v: float):
        self.samples.append(v)

    def reset(self):
        # in place: the engine exposes the list itself (``eng._ttft``),
        # and a caller may hold it across a reset
        self.samples.clear()

    def percentile(self, q: float) -> float:
        """numpy's default (linear interpolation) percentile."""
        s = sorted(self.samples)
        if not s:
            return 0.0
        if len(s) == 1:
            return float(s[0])
        pos = (q / 100.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))

    def get(self):
        s = list(self.samples)
        return {"count": len(s),
                "sum": float(sum(s)),
                "p50": self.percentile(50),
                "p95": self.percentile(95)}


class MetricsRegistry:
    """Get-or-create registry; reset, snapshot and exposition walk it."""

    def __init__(self, namespace: str = "blast"):
        self.namespace = namespace
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    # ------------------------------------------------- registration
    def _get_or_create(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help)
            self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, help)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    def names(self) -> list[str]:
        return list(self._metrics)

    def _items(self) -> list:
        return list(self._metrics.items())

    # ------------------------------------------------------ lifecycle
    def reset(self) -> None:
        """Reset every registered metric: declared, derived and
        auto-registered alike."""
        for _, m in self._items():
            m.reset()

    def snapshot(self) -> dict:
        """JSON-able {name: value}; histograms fold to summary dicts."""
        return {name: m.get() for name, m in self._items()}

    def view(self) -> "StatsView":
        return StatsView(self)

    # ----------------------------------------------------- exposition
    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4). Histograms render
        as summaries (quantile labels, ``_sum`` and ``_count``)."""
        out = []
        ns = self.namespace
        for name, m in sorted(self._items()):
            full = f"{ns}_{name}" if ns else name
            if m.help:
                out.append(f"# HELP {full} {m.help}")
            if isinstance(m, Histogram):
                s = list(m.samples)
                out.append(f"# TYPE {full} summary")
                out.append(f'{full}{{quantile="0.5"}} '
                           f"{m.percentile(50)}")
                out.append(f'{full}{{quantile="0.95"}} '
                           f"{m.percentile(95)}")
                out.append(f"{full}_sum {float(sum(s))}")
                out.append(f"{full}_count {len(s)}")
            else:
                out.append(f"# TYPE {full} {m.kind}")
                out.append(f"{full} {m.value}")
        return "\n".join(out) + "\n"


def parse_prometheus_text(text: str) -> dict:
    """Parser for the exposition format above: {metric_name: value} for
    plain samples, {metric_name: {labels: value}} for labelled ones.
    Raises ``ValueError`` on a malformed line."""
    out: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            continue
        try:
            name_part, value_part = line.rsplit(None, 1)
            value = float(value_part)
        except ValueError:
            raise ValueError(f"line {lineno}: bad sample {line!r}")
        if "{" in name_part:
            name, rest = name_part.split("{", 1)
            if not rest.endswith("}"):
                raise ValueError(f"line {lineno}: bad labels {line!r}")
            out.setdefault(name, {})[rest[:-1]] = value
        else:
            out[name_part] = value
    return out


class StatsView(MutableMapping):
    """Dict facade over a registry's scalar metrics (histograms are
    reached through the registry). Assigning an unknown key registers it:
    an int as a counter, a float as a gauge."""

    __slots__ = ("_reg",)

    def __init__(self, registry: MetricsRegistry):
        self._reg = registry

    def _scalars(self) -> dict:
        return {k: m for k, m in self._reg._items()
                if not isinstance(m, Histogram)}

    def __getitem__(self, key):
        m = self._reg._metrics[key]
        if isinstance(m, Histogram):
            raise KeyError(f"{key} is a histogram; use the registry")
        return m.value

    def __setitem__(self, key, value):
        m = self._reg._metrics.get(key)
        if m is None:
            cls = Gauge if isinstance(value, float) else Counter
            m = self._reg._get_or_create(cls, key, "")
        m.set(value)

    def __delitem__(self, key):
        del self._reg._metrics[key]

    def __iter__(self):
        return iter(self._scalars())

    def __len__(self):
        return len(self._scalars())

    def __contains__(self, key):
        return key in self._scalars()

    def __repr__(self):
        return repr({k: m.value for k, m in self._scalars().items()})
