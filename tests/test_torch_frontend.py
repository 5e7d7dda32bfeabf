"""The port's asyncio front door (``serving/frontend.py``): streamed tokens
and results equal the port's synchronous engine (and the reference
engine's, to a near-tie), SLA priority with preemption works through it,
a cancelled stream is isolated, ``aclose`` fails orphan streams, a submit
after close raises, a crash is recovered through the watchdog, and a
stalled step is condemned and recovered. Every drive is bounded by
``asyncio.wait_for``; the watchdog's deadline is many times the slowest
CPU step it guards. Each test runs its own loop with ``asyncio.run``."""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.frontend import AsyncEngine, TokenStream  # noqa: E402

BOUND_S = 60.0


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


def _engine(tiny, **kw):
    return tengine.Engine(tiny[1], tiny[3], device="cpu",
                          **dict(ts.KW, **kw))


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


def _sync(tiny, ps, budget, **kw):
    eng = _engine(tiny, **kw)
    uids = [eng.submit(p, budget) for p in ps]
    res = eng.run()
    return [res[u] for u in uids]


def test_streams_equal_the_sync_engines(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9, 4))
    base = _sync(tiny, ps, 12)
    je, _ = ts.engines(tiny)
    for p in ps:
        je.submit(p, 12)
    ref = je.run()

    async def drive():
        eng = _engine(tiny)
        async with AsyncEngine(eng) as front:
            streams = [await front.submit_async(p, 12) for p in ps]
            got = []
            for s in streams:
                toks = []
                async for batch in s:
                    toks.extend(batch)
                res = await s.result()
                assert toks == res.generated.tolist()   # nothing lost
                got.append(res)
        return got, eng

    got, eng = _run(drive())
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g.tokens, b.tokens)
    ts.check_results(tiny, {r.uid: r for r in ref.values()},
                     {r.uid: r for r in got})
    assert eng.stats["generated_tokens"] == 4 * 12
    assert "tok_per_s" in eng.stats          # finalized on close


def test_priority_preempts_through_the_front_door(tiny):
    """A batch job holding 7 of 8 pages is preempted for an interactive
    arrival; both streams finish with the synchronous engine's tokens."""
    rng = np.random.default_rng(2)
    p_batch = rng.integers(1, tiny[0].vocab_size, 8).astype(np.int32)
    p_inter = rng.integers(1, tiny[0].vocab_size, 6).astype(np.int32)
    # one step per sync: the batch lane is still decoding when the
    # interactive request lands, even on a loaded host
    kw = dict(max_len=32, slab_k=1, n_pages=8)
    [b_want] = _sync(tiny, [p_batch], 20, **kw)
    [i_want] = _sync(tiny, [p_inter], 4, **kw)

    async def drive():
        eng = _engine(tiny, preempt=True, **kw,
                      scheduler=tsched.SLAScheduler(2, 32, aging_s=None))
        async with AsyncEngine(eng) as front:
            sb = await front.submit_async(p_batch, 20,
                                          priority=tsched.BATCH)
            await sb.__anext__()                 # the batch lane decodes
            si = await front.submit_async(p_inter, 4,
                                          priority=tsched.INTERACTIVE,
                                          deadline_s=1.0)
            return await sb.result(), await si.result(), eng

    rb, ri, eng = _run(drive())
    np.testing.assert_array_equal(rb.tokens, b_want.tokens)
    np.testing.assert_array_equal(ri.tokens, i_want.tokens)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["restores"] == eng.stats["preemptions"]


def test_cancel_is_isolated_and_idempotent(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5), seed=6)
    base = _sync(tiny, ps, 40)

    async def drive():
        eng = _engine(tiny)
        async with AsyncEngine(eng) as front:
            s0 = await front.submit_async(ps[0], 40)
            s1 = await front.submit_async(ps[1], 40)
            await s0.__anext__()               # s0 is mid-decode
            await s0.cancel()
            await s0.cancel()                  # again: nothing
            with pytest.raises(tfaults.RequestCancelledError):
                await s0.result()
            r1 = await s1.result()
            await s1.cancel()                  # after completion: nothing
            assert (await s1.result()) is r1
        return eng, r1

    eng, r1 = _run(drive())
    np.testing.assert_array_equal(r1.tokens, base[1].tokens)
    assert eng.stats["cancelled"] == 1
    assert ts.pool_consistent(eng) and eng.pool.referenced == 0


def test_aclose_fails_orphan_streams(tiny):
    async def drive():
        front = AsyncEngine(_engine(tiny, max_batch=1)).start()
        s = await front.submit_async(np.ones(4, np.int32), 4)
        await s.result()
        await front.aclose()
        # what a dead stepper leaves behind: a registered stream and an
        # inbox entry that never submitted
        loop = asyncio.get_running_loop()
        orphan, inboxed = TokenStream(loop), TokenStream(loop)
        orphan._front = inboxed._front = front
        front._streams[999] = orphan
        front._inbox.append((np.ones(4, np.int32), 4, 0, None, inboxed))
        await front.aclose()                   # safe twice; sweeps both
        for stream in (orphan, inboxed):
            with pytest.raises(tfaults.RequestCancelledError):
                await stream.result()
            with pytest.raises(StopAsyncIteration):
                await stream.__anext__()

    _run(drive())


def test_submit_rejections_and_after_close(tiny):
    async def drive():
        front = AsyncEngine(_engine(tiny, max_batch=1, n_pages=8))
        with pytest.raises(RuntimeError, match="not running"):
            await front.submit_async(np.ones(4, np.int32), 4)
        front.start()
        with pytest.raises(ValueError, match="cannot fit"):
            await front.submit_async(np.ones(64, np.int32), 4)
        with pytest.raises(ValueError, match="oversized request"):
            await front.submit_async(np.ones(20, np.int32), 21)
        s = await front.submit_async(np.ones(4, np.int32), 4)
        assert len((await s.result()).generated) == 4
        await front.aclose()
        with pytest.raises(RuntimeError, match="not running"):
            await front.submit_async(np.ones(4, np.int32), 4)

    _run(drive())


@pytest.mark.parametrize("plan,hang", [
    (lambda p: p.crash(2), False),
    (lambda p: p.stall(2, seconds=BOUND_S), True)],
    ids=["crash", "stall"])
def test_watchdog_recovers_with_zero_reprefill(tiny, plan, hang):
    """A crashed stepper is recovered by the watchdog; a stalled step is
    condemned after ``watchdog_s`` (5 s, against CPU steps of tens of ms)
    and aborts. Either way the live lanes are salvaged, and the streams
    equal the fault-free run."""
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=4)
    base = _sync(tiny, ps, 12)

    async def drive():
        eng = _engine(tiny, faults=plan(tfaults.FaultPlan()))
        front = AsyncEngine(eng, watchdog_s=5.0 if hang else None,
                            max_recoveries=1)
        async with front:
            streams = [await front.submit_async(p, 12) for p in ps]
            results = [await s.result() for s in streams]
        return eng, front, results

    eng, front, results = _run(drive())
    for r, b in zip(results, base):
        np.testing.assert_array_equal(r.tokens, b.tokens)
    st = eng.stats
    assert (st["watchdog_hangs"], st["engine_crashes"]) == (
        (1, 0) if hang else (0, 1))
    assert st["recoveries"] == 1 and st["re_prefilled_tokens"] == 0
    assert st["recovered_zero_reprefill"] >= 1
    [summary] = front.recovery_log
    assert summary["salvaged_lanes"] >= 1 and summary["salvaged_bytes"] > 0
    assert ts.pool_consistent(eng) and eng.pool.referenced == 0


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_without_budget_fails_the_streams(tiny):
    """With no recovery budget the first crash fails the open streams
    with the structured error (the stepper thread re-raises it)."""
    async def drive():
        eng = _engine(tiny, max_batch=1,
                      faults=tfaults.FaultPlan().crash(1))
        front = AsyncEngine(eng).start()
        s = await front.submit_async(np.ones(6, np.int32), 12)
        with pytest.raises(tfaults.EngineCrashError):
            await s.result()
        await front.aclose()

    _run(drive())
