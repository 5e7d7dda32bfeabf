"""The port engine's metrics registry and tracer (``Engine.metrics``,
``Engine(tracer=)``) against the reference engine's, on the packed tiny
model with the same weights (crossed through ``interop``):

  * after a run in each mode (phased paged, contiguous, mixed, prefix
    cache, and preemption under the SLA scheduler) the port's registry
    holds the reference's metric names with the reference's kinds, and
    every value in ``stats`` is a Python ``int`` or ``float``;
  * ``reset_stats`` zeroes every metric and keeps every key;
  * with tracing off a whole workload constructs no ``Span``;
  * with a ``Tracer`` the streams and every count are bitwise those of
    the untraced run, and the spans reuse the engine's own timestamps:
    the ``decode.slab`` durations sum to ``decode_s``, the
    ``prefill.chunks`` durations (with the mixed calls that carried no
    decode lane) to ``prefill_s`` and the other ``mixed.step`` durations
    to ``mixed_s``, to 1e-9 s;
  * a request's timeline reads queued, admitted, finish from the ring,
    and the port's ring holds the reference's sequence of (name, attrs)
    on the same workload, times left out (the preemption scenario's
    offload and restore events included).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.metrics import Histogram  # noqa: E402
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

MODES = {"phased": {}, "contiguous": dict(paged=False),
         "mixed": dict(mixed=True), "prefix": dict(prefix_cache=True),
         "preempt_sla": dict(preempt=True, max_batch=2, max_len=32,
                             slab_k=2, n_pages=8)}
# seconds, and rates and percentiles over seconds: these differ run to run
TIMED = ("prefill_s", "decode_s", "mixed_s", "queued_s_total",
         "queued_s_max", "tok_per_s", "e2e_tok_per_s", "ttft_p50_s",
         "ttft_p95_s", "itl_p50_s", "itl_p95_s")


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


def _drive(e, mode, prompts):
    """The mode's workload on one engine: a shared prompt prefix for the
    prefix cache; under ``preempt_sla`` a batch request that an
    interactive one preempts after the second step."""
    if mode == "preempt_sla":
        e.submit(prompts[0], 20, priority=1)
        for n in range(200):
            if n == 2:
                e.submit(prompts[1], 4, priority=0)
                e.submit(prompts[2], 3, priority=1)
            if not ts.busy(e):
                break
            e.step()
        e.finalize_stats()
        return
    if mode == "prefix":
        prompts = [np.concatenate([prompts[0], p]) for p in prompts]
    for p in prompts:
        e.submit(p, 9)
    e.run()


def _pair(tiny, mode, jtracer=None, ttracer=None):
    kw = dict(MODES[mode])
    jkw, tkw = dict(tracer=jtracer), dict(tracer=ttracer)
    if mode == "preempt_sla":
        jkw["scheduler"] = jsched.SLAScheduler(2, 32, aging_s=None)
        tkw["scheduler"] = tsched.SLAScheduler(2, 32, aging_s=None)
    je, te = ts.engines(tiny, jkw=jkw, tkw=tkw, **kw)
    ps = ts.prompts(tiny[0].vocab_size, (8, 6, 4, 9), seed=2)
    for e in (je, te):
        _drive(e, mode, ps)
    return je, te


def _kinds(reg):
    return {n: reg[n].kind for n in reg.names()}


@pytest.fixture(scope="module", params=sorted(MODES))
def run(request, tiny):
    mode = request.param
    je, te = _pair(tiny, mode)
    return mode, je, te


def test_registry_names_and_kinds_equal_the_reference(run):
    mode, je, te = run
    assert _kinds(te.metrics) == _kinds(je.metrics)
    if mode == "preempt_sla":
        assert te.stats["preemptions"] == je.stats["preemptions"] == 1


def test_declared_metrics_equal_the_reference():
    """Names, kinds and order; help strings may name the port's own
    mechanism (no jit)."""
    from repro.serving import engine as jengine
    assert ([m[:2] for m in tengine._METRICS]
            == [m[:2] for m in jengine._METRICS])


def test_stats_values_are_python_numbers(run):
    _, _, te = run
    for k, v in te.stats.items():
        assert type(v) in (int, float), (k, type(v))
    for name in te.metrics.names():
        m = te.metrics[name]
        if isinstance(m, Histogram):
            assert all(type(x) is float for x in m.samples), name
            assert m.samples                    # ttft and itl observed


def test_counts_equal_the_reference(run):
    _, je, te = run
    js, tstats = dict(je.stats), dict(te.stats)
    for k in js:
        if k in TIMED:
            continue
        assert tstats[k] == js[k], k
    for h in ("ttft_s", "itl_s"):
        assert len(te.metrics[h].samples) == len(je.metrics[h].samples)


def test_reset_stats_zeroes_every_metric(run):
    """Every scalar and histogram forced non-zero, then reset: each is
    back at zero and no key is lost, auto-registered ones included."""
    _, _, te = run
    names = te.metrics.names()
    for name in names:
        m = te.metrics[name]
        if isinstance(m, Histogram):
            m.observe(1.0)
        else:
            m.set(m.get() + 1)
    held = te._ttft
    te.reset_stats()
    assert te.metrics.names() == names
    for name in names:
        m = te.metrics[name]
        if isinstance(m, Histogram):
            assert m.samples == [], name
        else:
            assert m.get() == 0, name
    assert te._ttft is held and te._ttft == []
    assert "tok_per_s" in te.stats


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tracing_off_constructs_no_span(tiny, mode, monkeypatch):
    calls = []
    orig = ttrace.Span

    class CountingSpan(orig):
        def __init__(self, *a, **kw):
            calls.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(ttrace, "Span", CountingSpan)
    kw = dict(MODES[mode])
    tkw = {}
    if mode == "preempt_sla":
        tkw["scheduler"] = tsched.SLAScheduler(2, 32, aging_s=None)
    te = tengine.Engine(tiny[1], tiny[3], device="cpu",
                        **dict(ts.KW, **kw), **tkw)
    assert te.tracer is NULL_TRACER and te.scheduler.tracer is NULL_TRACER
    if te.paged:
        assert te._offload.tracer is NULL_TRACER
    _drive(te, mode, ts.prompts(tiny[0].vocab_size, (8, 6, 4, 9), seed=2))
    assert te.stats["generated_tokens"] > 0 and calls == []
    # the same engine class records once a tracer is given
    tr = Tracer()
    te = tengine.Engine(tiny[1], tiny[3], device="cpu", tracer=tr, **ts.KW)
    te.submit(np.ones(5, np.int32), 3)
    te.run()
    assert calls and len(calls) == len(tr.records)


def _port_run(tiny, mode, tracer):
    tkw = {}
    if mode == "preempt_sla":
        tkw["scheduler"] = tsched.SLAScheduler(2, 32, aging_s=None)
    te = tengine.Engine(tiny[1], tiny[3], device="cpu", tracer=tracer,
                        **dict(ts.KW, **MODES[mode]), **tkw)
    out = {}
    orig = te.step

    def step():
        got = orig()
        out.update((r.uid, r) for r in got)
        return got

    te.step = step
    _drive(te, mode, ts.prompts(tiny[0].vocab_size, (8, 6, 4, 9), seed=2))
    return te, out


@pytest.fixture(scope="module", params=sorted(MODES))
def traced(request, tiny):
    mode = request.param
    off, out_off = _port_run(tiny, mode, None)
    tr = Tracer()
    on, out_on = _port_run(tiny, mode, tr)
    return dict(mode=mode, off=off, on=on, out_off=out_off, out_on=out_on,
                tr=tr)


def test_tracing_on_changes_no_stream_or_count(traced):
    off, on = traced["off"], traced["on"]
    assert sorted(traced["out_on"]) == sorted(traced["out_off"])
    for u, r in traced["out_off"].items():
        g = traced["out_on"][u]
        np.testing.assert_array_equal(g.tokens, r.tokens)
        assert g.truncated == r.truncated
    assert sorted(on.stats) == sorted(off.stats)
    for k, v in off.stats.items():
        if k not in TIMED:
            assert on.stats[k] == v, k


def test_span_sums_equal_the_engine_times(traced):
    st, recs = traced["on"].stats, list(traced["tr"].records)

    def total(keep):
        return sum(s.dur for s in recs if keep(s))

    slab = total(lambda s: s.name == "decode.slab")
    prefill = total(lambda s: s.name == "prefill.chunks" or (
        s.name == "mixed.step" and s.attrs["decode_lanes"] == 0))
    mixed = total(lambda s: s.name == "mixed.step"
                  and s.attrs["decode_lanes"] > 0)
    assert abs(slab - st["decode_s"]) <= 1e-9
    assert abs(prefill - st["prefill_s"]) <= 1e-9
    assert abs(mixed - st["mixed_s"]) <= 1e-9
    n = {k: sum(s.name == k for s in recs)
         for k in ("decode.slab", "prefill.chunks", "mixed.step")}
    assert n["decode.slab"] == st["decode_slabs"]
    if traced["mode"] == "mixed":
        assert n["mixed.step"] == st["mixed_steps"] > 0


def test_request_timelines(traced):
    tr = traced["tr"]
    for u in traced["out_on"]:
        names = [s["name"] for s in tr.spans_for(u)]
        assert names[0] == "request.queued", names
        assert "request.admitted" in names
        assert names[-1] == "request.finish", names
    if traced["mode"] == "preempt_sla":
        names = [s["name"] for s in tr.spans_for(0)]
        for n in ("offload.save", "request.preempt", "offload.pop",
                  "request.restore"):
            assert n in names, n


def test_ring_snapshot_and_chrome_trace(traced):
    tr = traced["tr"]
    doc = tr.chrome_trace()
    assert len(doc["traceEvents"]) == len(tr.records) > 0
    assert tr.snapshot()[0]["name"] == "request.queued"
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i"}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_event_sequences_equal_the_reference(tiny, mode):
    jt, tt = JTracer(), Tracer()
    _pair(tiny, mode, jt, tt)
    got, want = ts.events(tt.records), ts.events(jt.records)
    assert len(got) == len(want) > 0
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {n}: {g} != {w}"
