"""Observability (port of ``repro/obs``): a typed metrics registry,
request-span tracing with a crash flight recorder, and Chrome/Perfetto
trace export.

  * ``metrics.MetricsRegistry``: counters, gauges and histograms behind a
    dict view (``registry.view()`` is ``Engine.stats``), with Prometheus
    text exposition and a JSON-able snapshot; reset derives from the
    registry, so no metric can be missed by ``reset_stats``;
  * ``trace.Tracer``: per-request and per-step spans recorded at the
    host syncs the instrumented code already makes (``span_at``), so
    tracing adds no device sync and changes no tensor: greedy tokens and
    ``TrainState`` are bitwise the same with tracing on or off. The last
    N spans live in a bounded ring, the flight recorder, which
    ``postmortem()`` dumps to JSON when a watchdog, supervisor, rollback
    or rewind fires. ``NULL_TRACER`` is the disabled default and never
    allocates a span;
  * ``export``: Chrome trace-event JSON from any span iterable.

Standard library only.
"""
from repro_torch.obs.metrics import MetricsRegistry, StatsView  # noqa: F401
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer     # noqa: F401
from repro_torch.obs.export import (chrome_trace_events,        # noqa: F401
                                    to_chrome_trace, write_chrome_trace)
