"""Fault containment in the port's engine against the reference engine,
in lockstep (``_torch_serving.py``), under the same seeded ``FaultPlan``s:
a poisoned lane (decode slab and mixed step) fails only its own request
with ``LaneFaultError``, an injected allocation failure raises from the
step, a full queue sheds with a retry-after hint, an expired deadline
cancels mid-decode, ``cancel`` reaches a queued, live or preempted
request, and a corrupted offload record fails only its request at
restore. Error types, streams, page states and counters equal the
reference's, and the survivors' streams equal a fault-free run's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


def _plans(build):
    """The same plan built for each side."""
    return build(jfaults.FaultPlan(seed=0)), build(tfaults.FaultPlan(seed=0))


def _run(tiny, ps, budget, build=None, hook=None, share=False, **kw):
    jplan, tplan = _plans(build) if build else (None, None)
    je, te = ts.engines(tiny, jkw=dict(faults=jplan),
                        tkw=dict(faults=tplan), **kw)
    for p in ps:
        assert je.submit(p, budget) == te.submit(p, budget)
    out, snaps, _ = ts.lockstep(je, te, hook, share=share)
    return je, te, out, snaps, (jplan, tplan)


def _fault_free(tiny, ps, budget, **kw):
    eng = tengine.Engine(tiny[1], tiny[3], device="cpu", **dict(ts.KW, **kw))
    for p in ps:
        eng.submit(p, budget)
    return eng.run()


@pytest.mark.parametrize("mixed,kind", [(False, "nan"), (True, "inf")],
                         ids=["slab_nan", "mixed_inf"])
def test_poison_quarantines_only_its_lane(tiny, mixed, kind):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=4)
    je, te, out, snaps, (jp, tp) = _run(
        tiny, ps, 12, lambda p: p.poison_logits(2, 0, kind=kind),
        mixed=mixed)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    assert tp.fired == jp.fired == [f"poison:{kind}@2:lane0"]
    bad = out[1][0]
    assert isinstance(bad.error, tfaults.LaneFaultError)
    assert isinstance(bad.error, tfaults.ServingFault)
    assert (bad.error.uid, bad.error.lane) == (0, 0)
    assert bad.error.reason == "non-finite logits"
    base = _fault_free(tiny, ps, 12, mixed=mixed)
    for u in (1, 2):                # the lane's next tenant included
        np.testing.assert_array_equal(out[1][u].tokens, base[u].tokens)
    assert te.stats["lanes_quarantined"] == te.stats["faults_injected"] == 1
    assert ts.pool_consistent(te) and te.pool.referenced == 0


def test_poisoned_lane_never_donates_to_prefix_cache(tiny):
    [p] = ts.prompts(tiny[0].vocab_size, (8,), seed=5)
    je, te, out, _, _ = _run(tiny, [p], 8, lambda pl: pl.poison_logits(1, 0),
                             max_batch=1, prefix_cache=True)
    ts.check_results(tiny, *out)
    assert isinstance(out[1][0].error, tfaults.LaneFaultError)
    assert te.pool.cached_idle == je.pool.cached_idle == 0
    u = te.submit(p, 8)             # the same prompt: no hit from it
    assert te.run()[u].ok and te.stats["prefix_hits"] == 0


def test_alloc_failure_raises_from_step(tiny):
    jplan, tplan = _plans(lambda p: p.fail_alloc(0))
    je, te = ts.engines(tiny, jkw=dict(faults=jplan),
                        tkw=dict(faults=tplan))
    [p] = ts.prompts(tiny[0].vocab_size, (6,), seed=6)
    for e in (je, te):
        e.submit(p, 4)
        with pytest.raises(RuntimeError, match="injected page allocation"):
            e.step()
    assert tplan.fired == jplan.fired == ["alloc_fail@0"]
    # nothing was lost: the request sits on its half-built lane
    assert te.active_lanes == je.active_lanes == [0]
    assert len(te.scheduler) == len(je.scheduler) == 0


def test_load_shedding_with_retry_after(tiny):
    je, te = ts.engines(tiny, max_batch=1, admission_queue_limit=2)
    ps = ts.prompts(tiny[0].vocab_size, (4, 4, 4, 4), seed=7)
    for e in (je, te):
        e.submit(ps[0], 2)
        e.submit(ps[1], 2)
    errs = {}
    for side, e, mod in (("j", je, jfaults), ("t", te, tfaults)):
        for p in ps[2:]:
            with pytest.raises(mod.BackpressureError) as ei:
                e.submit(p, 2)
            errs[side] = ei.value
    assert (errs["t"].queue_depth, errs["t"].limit) == (2, 2)
    assert errs["t"].retry_after_s == errs["j"].retry_after_s == 1.0
    out, _, _ = ts.lockstep(je, te)
    ts.check_results(tiny, *out)
    ts.check_counters(je, te)
    assert te.stats["shed_requests"] == 2 and len(out[1]) == 2
    te.submit(ps[2], 2)             # capacity again: the retry lands
    assert all(r.ok for r in te.run().values())
    # after completions, the hint is the recent mean gap, clamped
    te.submit(ps[3], 2)
    te.submit(ps[3], 2)
    with pytest.raises(tfaults.BackpressureError) as ei:
        te.submit(ps[3], 2)
    assert 0.05 <= ei.value.retry_after_s <= 60.0


def test_expired_deadline_cancels_mid_decode(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5), seed=9)
    je, te = ts.engines(tiny, max_len=64, enforce_deadlines=True)
    for e in (je, te):
        e.submit(ps[0], 24, deadline_s=1e-6)   # expired at the first sync
        e.submit(ps[1], 24)
    out, snaps, _ = ts.lockstep(je, te)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    err = out[1][0].error
    assert isinstance(err, tfaults.DeadlineExceededError)
    assert isinstance(err, tfaults.RequestCancelledError)
    assert 0 < len(out[1][0].generated) < 24
    base = _fault_free(tiny, ps, 24, max_len=64)
    np.testing.assert_array_equal(out[1][1].tokens, base[1].tokens)
    assert te.stats["deadline_cancelled"] == te.stats["cancelled"] == 1
    assert ts.pool_consistent(te) and te.pool.referenced == 0


def test_deadline_on_the_injected_clock(tiny):
    """Deadlines read the scheduler's clock: nothing expires while it
    stands still, and the lane is cancelled at the first sync after it
    passes the deadline."""
    clock = [100.0]
    eng = tengine.Engine(
        tiny[1], tiny[3], device="cpu", enforce_deadlines=True,
        scheduler=tsched.FIFOScheduler(2, 48, clock=lambda: clock[0]),
        **ts.KW)
    u = eng.submit(np.arange(1, 6, dtype=np.int32), 20, deadline_s=5.0)
    assert eng.scheduler.head().deadline_at == 105.0
    for _ in range(2):
        assert eng.step() == []
    n = len(eng.lanes[0].generated)
    clock[0] = 105.5
    [res] = eng.step()
    assert res.uid == u and isinstance(res.error,
                                       tfaults.DeadlineExceededError)
    assert len(res.generated) == n
    assert eng.stats["queued_s_total"] == 0.0      # admitted at t = 100


def test_cancel_everywhere_and_idempotent(tiny):
    """``cancel`` reaches a queued, a preempted and a live request, frees
    everything and says False the second time; the reference agrees at
    every call."""
    ps = ts.prompts(tiny[0].vocab_size, (6, 5, 4), seed=10)
    je, te = ts.engines(tiny, max_batch=1)
    got = ({}, {})
    calls = []
    for e, o in zip((je, te), got):
        u0, u1, u2 = (e.submit(p, 10) for p in ps)
        seq = [e.cancel(u2), e.cancel(u2)]          # queued, then again
        o.update((r.uid, r) for r in e.step())      # u0 on lane 0
        e.preempt(e.active_lanes[0])
        seq.append(e.cancel(u0))                    # preempted
        seq.append(len(e._offload))
        o.update((r.uid, r) for r in e.step())      # u1 takes the lane
        seq.append(e.cancel(u1))                    # live
        o.update(e.run())
        seq += [e.cancel(u1), e.stats["cancelled"], ts.pool_consistent(e),
                e.pool.referenced]
        calls.append(seq)
    assert calls[1] == calls[0] == [True, False, True, 0, True, False, 3,
                                    True, 0]
    ts.check_results(tiny, *got)
    assert all(isinstance(r.error, tfaults.RequestCancelledError)
               for r in got[1].values()) and len(got[1]) == 3


def test_corrupted_restore_fails_only_its_request(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5), seed=8)
    done = []

    def hook(n, je, te):
        i = ts.live_lane_of(je, 0)
        if not done and i is not None:
            ts.share_kv(je, te)
            je.preempt(i)
            te.preempt(i)
            done.append(n)

    je, te, out, snaps, (jp, tp) = _run(
        tiny, ps, 12, lambda p: p.corrupt_offload(nth_save=0), hook=hook,
        share=True)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    assert tp.fired == jp.fired == ["bitflip:save0"]
    err = out[1][0].error
    assert isinstance(err, tfaults.LaneFaultError) and err.lane == -1
    assert "checksum" in err.reason
    base = _fault_free(tiny, ps, 12)
    np.testing.assert_array_equal(out[1][1].tokens, base[1].tokens)
    assert te.stats["lanes_quarantined"] == te.stats["faults_injected"] == 1
    assert ts.pool_consistent(te) and te.pool.referenced == 0
    assert len(te._offload) == 0


def test_reset_stats_covers_fault_counters(tiny):
    keys = ("faults_injected", "lanes_quarantined", "recoveries",
            "recovered_zero_reprefill", "re_prefilled_tokens",
            "shed_requests", "cancelled", "deadline_cancelled",
            "watchdog_hangs", "engine_crashes", "preemptions", "restores",
            "offloaded_pages", "restored_pages", "offload_bytes_peak",
            "queue_depth_peak", "queued_s_total", "queued_s_max")
    eng = tengine.Engine(tiny[1], tiny[3], device="cpu", max_batch=1,
                         admission_queue_limit=1,
                         faults=tfaults.FaultPlan().poison_logits(1, 0),
                         **{k: v for k, v in ts.KW.items()
                            if k != "max_batch"})
    ps = ts.prompts(tiny[0].vocab_size, (5, 4), seed=11)
    eng.submit(ps[0], 8)
    with pytest.raises(tfaults.BackpressureError):
        eng.submit(ps[1], 2)
    eng.run()
    st = eng.stats
    assert (st["faults_injected"], st["lanes_quarantined"],
            st["shed_requests"], st["queue_depth_peak"]) == (1, 1, 1, 1)
    for k in keys:
        eng.stats[k] = eng.stats[k] or 3
    eng.reset_stats()
    assert all(eng.stats[k] == 0 for k in keys)
    assert eng.finalize_stats()["offload_capacity_bytes"] == 0


def test_lane_fault_error_is_the_reference_taxonomy():
    """The port's ``LaneFaultError`` has the reference's signature and
    base class, and the engine raises the faults module's class."""
    e = tfaults.LaneFaultError(7, 2)
    j = jfaults.LaneFaultError(7, 2)
    assert str(e) == str(j) and (e.uid, e.lane, e.reason) == (7, 2,
                                                              j.reason)
    assert tengine.LaneFaultError is tfaults.LaneFaultError
    for name in ("EngineCrashError", "EngineHangError",
                 "OffloadCorruptionError", "OffloadCapacityError",
                 "BackpressureError", "RequestCancelledError",
                 "DeadlineExceededError"):
        assert issubclass(getattr(tfaults, name), tfaults.ServingFault)
    assert issubclass(tfaults.EngineHangError, tfaults.EngineCrashError)
    assert not tfaults.EngineHangError().device_lost
    assert str(tfaults.OffloadCapacityError(9, 8, 1)) == str(
        jfaults.OffloadCapacityError(9, 8, 1))
