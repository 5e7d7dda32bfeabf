"""The flight recorder under the fault plans of ``serving/faults.py``:
the port's ring and postmortems against the reference's on the same
seeded plans, the engines driven in lockstep (``_torch_serving.py``)
with each crashed step recovered in place by that side's ``Supervisor``:

  * a poisoned lane (slab and mixed step) gives a ``request.quarantined``
    event, and its uid threads its whole timeline;
  * a corrupted offload record gives ``offload.corrupt`` and the
    victim's ``request.quarantined``;
  * a crash (host side, device loss, an allocation failure then two
    device losses) gives a ``supervisor_recover`` postmortem, written
    before the rebuild, whose meta (error, device loss, the uids on
    lanes) and spans equal the reference's, and a ``recovery`` span with
    the reference's salvage and relaunch counts;
  * a hung step behind ``AsyncEngine(watchdog_s=5)`` gives
    ``watchdog_hang`` first, then ``supervisor_recover``; a crashed
    stepper ``watchdog_crash`` (each drive under ``asyncio.wait_for``).

Spans compare as (name, attrs) without the seconds each side reads from
its own clock. Of the port's repairs in ROADMAP §3, two concern these
scenarios: swept results stay parked until the step returns,
which changes what a dead step returns but no event (``request.finish``
fires at the sweep on both sides); and a lane whose first token had not
landed relaunches, which no scenario here reaches: the
allocation failure hits a group's first lane, before any lane of the
group holds pages, so both sides relaunch."""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.frontend import AsyncEngine as JAsyncEngine  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving.frontend import AsyncEngine  # noqa: E402

BOUND_S = 60.0


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


def _run(tiny, ps, budget, build, hook=None, recover=False, share=False,
         **kw):
    """Both engines with the same plan and a tracer each, in lockstep."""
    jt, tt = JTracer(), Tracer()
    jplan, tplan = build(jfaults.FaultPlan(5)), build(tfaults.FaultPlan(5))
    je, te = ts.engines(tiny, jkw=dict(faults=jplan, tracer=jt),
                        tkw=dict(faults=tplan, tracer=tt), **kw)
    for p in ps:
        assert je.submit(p, budget) == te.submit(p, budget)
    out, snaps, errs = ts.lockstep(je, te, hook, recover=recover,
                                   share=share)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    assert tplan.fired == jplan.fired
    return jt, tt, out, errs


def _same_events(got, want):
    got, want = ts.events(got), ts.events(want)
    assert len(got) == len(want) > 0
    for n, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"record {n}: {g} != {w}"


@pytest.mark.parametrize("mixed,kind", [(False, "nan"), (True, "inf")],
                         ids=["slab", "mixed"])
def test_poisoned_lane_threads_its_timeline(tiny, mixed, kind):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=4)
    jt, tt, out, _ = _run(tiny, ps, 12,
                          lambda p: p.poison_logits(2, 0, kind=kind),
                          mixed=mixed)
    victim = next(u for u, r in out[1].items() if not r.ok)
    assert isinstance(out[1][victim].error, tfaults.LaneFaultError)
    mine = tt.spans_for(victim)
    names = [s["name"] for s in mine]
    assert names[0] == "request.queued" and "request.admitted" in names
    assert names[-1] == "request.quarantined"
    q = mine[-1]["attrs"]
    assert q["error"] == "LaneFaultError" and q["lane"] == 0
    _same_events(mine, jt.spans_for(victim))
    _same_events(tt.records, jt.records)
    for u, r in out[1].items():
        if r.ok:
            assert tt.spans_for(u)[-1]["name"] == "request.finish"


def test_corrupted_offload_record_is_recorded(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5), seed=8)
    done = []

    def hook(n, je, te):
        i = ts.live_lane_of(je, 0)
        if not done and i is not None:
            ts.share_kv(je, te)
            je.preempt(i)
            te.preempt(i)
            done.append(n)

    jt, tt, out, _ = _run(tiny, ps, 12,
                          lambda p: p.corrupt_offload(nth_save=0),
                          hook=hook, share=True)
    names = [s["name"] for s in tt.spans_for(0)]
    assert names[-4:] == ["offload.save", "request.preempt",
                          "offload.corrupt", "request.quarantined"]
    assert tt.spans_for(0)[-2]["attrs"]["bad_pages"] == [0]
    _same_events(tt.records, jt.records)


CRASHES = {"host": (lambda p: p.crash(2), {}),
           "host_mixed": (lambda p: p.crash(2), dict(mixed=True)),
           "device_lost": (lambda p: p.crash(2, device_lost=True), {}),
           "alloc_chain": (lambda p: p.fail_alloc(0).crash(
               2, device_lost=True).crash(4, device_lost=True), {})}


@pytest.mark.parametrize("name", sorted(CRASHES))
def test_recovered_crash_postmortem_equals_the_reference(tiny, name):
    build, kw = CRASHES[name]
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=0)
    jt, tt, out, errs = _run(tiny, ps, 12, build, recover=True, share=True,
                             **kw)
    assert [e[1] for e in errs] == [e[0] for e in errs]
    n_crash = sum(e[1] is not None for e in errs)
    got, want = tt.postmortems, jt.postmortems
    assert [p["reason"] for p in got] == ["supervisor_recover"] * n_crash
    assert [p["reason"] for p in want] == [p["reason"] for p in got]
    for g, w in zip(got, want):
        assert g["meta"] == w["meta"]
        _same_events(g["spans"], w["spans"])
        # frozen before the rebuild: the last record is not the recovery
        assert g["spans"][-1]["name"] != "recovery"
        for u in g["meta"]["active_uids"]:      # the victims' timelines
            assert any(u == s["attrs"].get("uid")
                       or u in (s["attrs"].get("uids") or ())
                       for s in g["spans"]), u
    rec = [s for s in tt.records if s.name == "recovery"]
    assert len(rec) == n_crash and all(s.dur > 0 for s in rec)
    _same_events(tt.records, jt.records)


def _hang_drive(make_engine, front_cls, tracer, ps, plan):
    async def drive():
        eng = make_engine(plan, tracer)
        front = front_cls(eng, watchdog_s=5.0, max_recoveries=1)
        async with front:
            streams = [await front.submit_async(p, 12) for p in ps]
            results = [await s.result() for s in streams]
        return eng, results

    return asyncio.run(asyncio.wait_for(drive(), BOUND_S))


@pytest.mark.parametrize("hang", [True, False], ids=["hang", "crash"])
def test_watchdog_postmortem_comes_first(tiny, hang):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=4)

    def build(p):
        return p.stall(2, seconds=BOUND_S) if hang else p.crash(2)

    def port(plan, tr):
        return tengine.Engine(tiny[1], tiny[3], device="cpu", faults=plan,
                              tracer=tr, **ts.KW)

    def ref(plan, tr):
        return JEngine(tiny[0], tiny[2], faults=plan, tracer=tr, **ts.KW)

    tt, jt = Tracer(), JTracer()
    te, tres = _hang_drive(port, AsyncEngine, tt, ps,
                           build(tfaults.FaultPlan()))
    je, jres = _hang_drive(ref, JAsyncEngine, jt, ps,
                           build(jfaults.FaultPlan()))
    first = "watchdog_hang" if hang else "watchdog_crash"
    reasons = [p["reason"] for p in tt.postmortems]
    assert reasons == [first, "supervisor_recover"]
    assert reasons == [p["reason"] for p in jt.postmortems]
    wd, sup = tt.postmortems
    jwd, jsup = jt.postmortems
    assert wd["meta"] == jwd["meta"]
    assert wd["meta"]["open_streams"] == [0, 1, 2]
    assert wd["meta"]["error"] == ("EngineHangError" if hang
                                   else "EngineCrashError")
    assert sup["meta"] == jsup["meta"] and sup["meta"]["active_uids"]
    # the victims' uids thread the spans each dump froze
    for u in sup["meta"]["active_uids"]:
        assert any(s["attrs"].get("uid") == u for s in wd["spans"])
    assert all(r.ok for r in tres)
    for r, w in zip(tres, jres):
        np.testing.assert_array_equal(r.tokens, np.asarray(w.tokens))
    assert te.stats["recoveries"] == 1
