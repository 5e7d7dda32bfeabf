"""The port's observability layer (``repro_torch/obs``) against the
reference's (``repro/obs``): every case of ``tests/test_obs.py`` that
holds the registry, the Prometheus text, the tracer, the flight recorder
and the Chrome export, run against the port, and the two packages on the
same inputs: the same registry contents give byte-equal Prometheus text,
each package's parser reads the other's text, and the same span list
gives equal Chrome trace JSON (integer uids: ``export._tid`` hashes any
other uid, and string hashes differ between processes). Exact equality
throughout (the only float arithmetic is the same Python code)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import export as jexport  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.obs import export as texport  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: E402
                                     MetricsRegistry, parse_prometheus_text)
from repro_torch.obs.trace import NULL_TRACER, Tracer  # noqa: E402

PKGS = {"jax": (jmetrics, jtrace, jexport),
        "port": (tmetrics, ttrace, texport)}


# ------------------------------------------------------ metrics registry
def test_registry_kinds_and_reset():
    reg = MetricsRegistry()
    c = reg.counter("reqs", "requests")
    g = reg.gauge("depth")
    h = reg.histogram("lat_s")
    c.inc()
    c.inc(3)
    g.set(7.5)
    h.observe(0.1)
    h.observe(0.3)
    assert isinstance(c, Counter) and isinstance(g, Gauge)
    assert isinstance(h, Histogram)
    assert reg.counter("reqs") is c          # get-or-create
    snap = reg.snapshot()
    assert snap["reqs"] == 4 and snap["depth"] == 7.5
    assert snap["lat_s"]["count"] == 2
    assert snap["lat_s"]["sum"] == pytest.approx(0.4)
    reg.reset()
    snap = reg.snapshot()
    assert snap["reqs"] == 0 and snap["depth"] == 0
    assert snap["lat_s"]["count"] == 0


def test_histogram_reset_keeps_list_identity():
    h = Histogram("x")
    ref = h.samples
    h.observe(1.0)
    h.reset()
    h.observe(2.0)
    assert ref == [2.0] and h.samples is ref


@pytest.mark.parametrize("n", [1, 2, 6, 25])
def test_histogram_percentile_matches_numpy(n):
    vals = np.random.default_rng(n).random(n).tolist()
    h = Histogram("x")
    for v in vals:
        h.observe(v)
    for q in (0, 50, 95, 99, 100):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(vals, q)), rel=1e-12, abs=0)
    assert Histogram("empty").percentile(50) == 0.0


def test_stats_view_is_a_dict_facade():
    reg = MetricsRegistry()
    reg.counter("a")
    view = reg.view()
    view["a"] += 2                        # counter through the view
    view["b"] = 5                         # auto-registers a Counter
    view["r"] = 1.5                       # float auto-registers a Gauge
    reg.histogram("h").observe(1.0)
    assert view["a"] == 2 and view["b"] == 5
    assert reg["b"].kind == "counter" and reg["r"].kind == "gauge"
    assert "h" not in view                # histograms not in the facade
    with pytest.raises(KeyError):
        view["h"]
    assert dict(view) == {"a": 2, "b": 5, "r": 1.5}
    view.update({"a": 9})
    assert view["a"] == 9
    assert len(view) == 3 and sorted(view) == ["a", "b", "r"]
    del view["b"]
    assert "b" not in reg
    reg.reset()                           # auto-registered keys too
    assert dict(view) == {"a": 0, "r": 0}


# ------------------------------------------------------------ exposition
def test_prometheus_text_round_trip():
    reg = MetricsRegistry(namespace="blast")
    reg.counter("decode_tokens", "tokens emitted").inc(41)
    reg.gauge("queue_depth_peak").set(3)
    h = reg.histogram("ttft_s", "time to first token")
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    text = reg.prometheus_text()
    assert "# TYPE blast_decode_tokens counter" in text
    assert "# HELP blast_decode_tokens tokens emitted" in text
    assert "# TYPE blast_ttft_s summary" in text
    parsed = parse_prometheus_text(text)
    assert parsed["blast_decode_tokens"] == 41
    assert parsed["blast_queue_depth_peak"] == 3
    assert parsed["blast_ttft_s_count"] == 3
    assert parsed["blast_ttft_s_sum"] == pytest.approx(0.6)
    assert parsed["blast_ttft_s"]['quantile="0.5"'] == pytest.approx(0.2)


@pytest.mark.parametrize("text", [
    "not a sample line at all\n", "# BOGUS comment kind\n", "#\n",
    "metric{unclosed 1\n", "metric notanumber\n"])
def test_prometheus_parser_rejects_malformed(text):
    for mod in (tmetrics, jmetrics):
        with pytest.raises(ValueError):
            mod.parse_prometheus_text(text)


def _fill(mod, namespace):
    """The same registry contents in either package: every kind, help and
    no help, ints and floats, an auto-registered view key, an empty and a
    filled histogram."""
    reg = mod.MetricsRegistry(namespace=namespace)
    reg.counter("decode_tokens", "tokens emitted").inc(41)
    reg.counter("prefill_s", "seconds in prefill calls").inc(0.125)
    reg.gauge("queue_depth_peak", "queue high-water").set(3)
    reg.gauge("tok_per_s").set(171.33333333333334)
    reg.histogram("itl_s", "inter-token gaps")
    h = reg.histogram("ttft_s", "submit -> first token seconds")
    for v in np.random.default_rng(1).random(9).tolist():
        h.observe(v)
    view = reg.view()
    view["peak_kv_bytes"] = 50331648
    view["prefix_hit_rate"] = 0.4166666666666667
    view["decode_tokens"] += 7
    return reg


@pytest.mark.parametrize("namespace", ["blast", "blast_train", ""])
def test_prometheus_text_byte_equal_across_packages(namespace):
    jt = _fill(jmetrics, namespace).prometheus_text()
    tt = _fill(tmetrics, namespace).prometheus_text()
    assert tt == jt
    assert (_fill(tmetrics, namespace).snapshot()
            == _fill(jmetrics, namespace).snapshot())


@pytest.mark.parametrize("reader,writer", [("jax", "port"), ("port", "jax")])
def test_each_parser_reads_the_others_text(reader, writer):
    text = _fill(PKGS[writer][0], "blast").prometheus_text()
    got = PKGS[reader][0].parse_prometheus_text(text)
    assert got == PKGS[writer][0].parse_prometheus_text(text)
    assert got["blast_decode_tokens"] == 48
    assert got["blast_ttft_s_count"] == 9
    assert set(got["blast_ttft_s"]) == {'quantile="0.5"', 'quantile="0.95"'}


# --------------------------------------------------------------- tracing
def test_tracer_records_and_spans_for():
    clock = iter(float(i) for i in range(100))
    tr = Tracer(capacity=8, clock=lambda: next(clock))
    tr.span_at("decode.slab", 1.0, 2.0, k=4, uids=[1, 2])
    tr.event("request.finish", uid=1, tokens=5)
    with tr.span("ckpt.save", step=3):
        pass
    assert [s.name for s in tr.records] == [
        "decode.slab", "request.finish", "ckpt.save"]
    assert tr.records[0].dur == 1.0
    mine = tr.spans_for(1)
    assert [s["name"] for s in mine] == ["decode.slab", "request.finish"]
    assert tr.spans_for(99) == []
    for i in range(20):                   # bounded ring
        tr.event("e", t=float(i))
    assert len(tr.records) == 8


def test_span_ctx_records_error_name():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("ckpt.restore", step=1):
            raise RuntimeError("boom")
    assert tr.records[-1].attrs["error"] == "RuntimeError"


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    NULL_TRACER.span_at("x", 0.0, 1.0, uid=1)
    NULL_TRACER.event("y", uid=1)
    with NULL_TRACER.span("z"):
        pass
    assert NULL_TRACER.postmortem("r") is None
    assert list(NULL_TRACER.records) == [] and NULL_TRACER.snapshot() == []
    assert NULL_TRACER.spans_for(1) == []
    assert NULL_TRACER.chrome_trace() == jtrace.NULL_TRACER.chrome_trace()


def test_postmortem_payload_and_file(tmp_path):
    tr = Tracer(postmortem_dir=str(tmp_path))
    tr.event("request.queued", t=0.0, uid=7)
    pm = tr.postmortem("watchdog_crash", error="EngineCrashError")
    assert pm["reason"] == "watchdog_crash"
    assert pm["meta"]["error"] == "EngineCrashError"
    assert [s["name"] for s in pm["spans"]] == ["request.queued"]
    assert tr.postmortems == [pm]
    tr.postmortem("swap.rollback")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["postmortem_0000_watchdog_crash.json",
                     "postmortem_0001_swap.rollback.json"]
    with open(tmp_path / files[0]) as f:
        assert json.load(f)["reason"] == "watchdog_crash"


def test_postmortem_swallows_only_a_write_error(tmp_path):
    """A dump that cannot be written still returns and keeps its payload:
    it must not mask the crash it reports."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    tr = Tracer(postmortem_dir=str(blocker / "sub"))
    pm = tr.postmortem("supervisor_recover", active_uids=[1])
    assert tr.postmortems == [pm] and pm["meta"]["active_uids"] == [1]


def test_chrome_trace_export():
    tr = Tracer()
    tr.span_at("decode.slab", 1.0, 2.0, k=4, uids=[0, 1])
    tr.event("request.finish", t=2.5, uid=1, tokens=5)
    doc = tr.chrome_trace()
    ev = doc["traceEvents"]
    assert len(ev) == 2
    slab, fin = ev
    assert slab["ph"] == "X" and slab["dur"] == pytest.approx(1e6)
    assert slab["ts"] == pytest.approx(1e6)
    assert fin["ph"] == "i" and fin["s"] == "t"
    assert fin["tid"] == 2                # uid 1 -> row 2 (0 = engine)
    json.dumps(doc)
    again = texport.to_chrome_trace([s.to_dict() for s in tr.records])
    assert again["traceEvents"] == ev


def _spans(mod_trace):
    """The same span list in either package, integer uids only."""
    tr = mod_trace.Tracer(clock=lambda: 5.0)
    tr.span_at("prefill.chunks", 0.5, 0.75, lanes=2, chunks=3, tokens=40,
               uids=[0, 1])
    tr.event("request.queued", t=0.25, uid=0, prompt_len=7,
             max_new_tokens=12, priority=0)
    tr.event("request.admitted", t=0.5, uid=1, queued_s=0.25, priority=1)
    tr.span_at("decode.slab", 0.75, 1.125, k=8, lanes=2, uids=[0, 1])
    tr.event("request.finish", t=1.125, uid=1, lane=1, tokens=9,
             ttft_s=0.5, truncated=False)
    tr.event("train.anomaly", step=4, verdict="skip", loss=float("nan"),
             consecutive=1)
    tr.event("offload.corrupt", uid=3, bad_pages=(0, 2))
    tr.event("odd", uid=2, obj=np.float32(1.5), items=[np.int64(3), "a"])
    with tr.span("ckpt.restore", step=-1):
        pass
    return tr


def test_chrome_trace_equal_across_packages(tmp_path):
    jt, tt = _spans(jtrace), _spans(ttrace)
    got, want = tt.chrome_trace(), jt.chrome_trace()
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    # from the postmortem form too (NaN != NaN: compare the JSON text),
    # and through each writer
    assert (json.dumps(texport.to_chrome_trace(tt.snapshot(), pid=3))
            == json.dumps(jexport.to_chrome_trace(jt.snapshot(), pid=3)))
    a = texport.write_chrome_trace(str(tmp_path / "t.json"), tt.records)
    b = jexport.write_chrome_trace(str(tmp_path / "j.json"), jt.records)
    assert open(a).read() == open(b).read()


def test_span_dicts_equal_across_packages():
    jt, tt = _spans(jtrace), _spans(ttrace)
    assert (json.dumps(tt.snapshot(), default=str)
            == json.dumps(jt.snapshot(), default=str))
    assert tt.spans_for(1) == jt.spans_for(1)
    assert repr(tt.records[0]) == repr(jt.records[0])


def test_registry_and_ring_under_concurrent_threads():
    """The engine thread writes while the ``/metrics`` and watchdog
    threads read: one writer registers new keys and increments a counter
    while readers render, snapshot and walk the view, and eight threads
    append events while others snapshot the ring, with a 1 µs switch
    interval. No read raises, a counter never reads lower than it read
    before, and no append is lost."""
    import sys
    import threading
    reg = MetricsRegistry()
    view = reg.view()
    c = reg.counter("ticks")
    tr = Tracer(capacity=100_000)
    done = threading.Event()
    errors, seen = [], []

    def writer():
        for i in range(3000):
            view[f"k{i}"] = i
            c.inc()
            if i % 7 == 0:
                reg.histogram(f"h{i}").observe(float(i))
        done.set()

    def reader():
        last = 0
        try:
            while not done.is_set():
                got = parse_prometheus_text(reg.prometheus_text())
                now = got.get("blast_ticks", 0)
                assert now >= last
                last = now
                reg.snapshot()
                dict(view)
                len(view)
                tr.snapshot()
                tr.spans_for(3)
        except Exception as e:               # recorded, asserted below
            errors.append(e)
        seen.append(last)

    def appender(k):
        for i in range(500):
            tr.event("e", t=float(i), uid=k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = ([threading.Thread(target=writer)]
                   + [threading.Thread(target=reader) for _ in range(4)]
                   + [threading.Thread(target=appender, args=(k,))
                      for k in range(8)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert c.get() == 3000 and len(view) == 3001
    assert len(tr.records) == 8 * 500
    assert len(tr.spans_for(3)) == 500
