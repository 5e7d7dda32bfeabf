"""Crash recovery in the port (``Supervisor.recover``) against the
reference, in lockstep (``_torch_serving.py``) with each crashed step
recovered in place on both sides: a host-side crash salvages live lanes'
KV and restores them with no re-prefill, device loss relaunches them as
prompt + emitted, repeated allocation failures and crashes chain, queued
and preempted work survives, and the chaos oracle (a NaN lane, a crash
and a corrupted salvage record in one run) fails exactly its two victims.
The same exceptions fire at the same steps, and salvage versus relaunch,
streams, page states, records and counters equal the reference's.

The port writes its caches in place: a slab that dies after j of its k
steps leaves writes behind. Recovery must still give the uninterrupted
run's streams with no re-prefill (the argument is in the port's
``serving/recovery.py``); the last tests make the slab and the mixed call
raise after their writes landed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import recovery as jrecovery  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import recovery as trecovery  # noqa: E402
from repro_torch.serving import step as tstep  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


def _fault_free(tiny, ps, budget, **kw):
    eng = tengine.Engine(tiny[1], tiny[3], device="cpu", **dict(ts.KW, **kw))
    uids = [eng.submit(p, budget) for p in ps]
    res = eng.run()
    return {u: res[u] for u in uids}, eng.stats


def _chaos(tiny, ps, budget, build, share=True, **kw):
    jplan, tplan = build(jfaults.FaultPlan(5)), build(tfaults.FaultPlan(5))
    je, te = ts.engines(tiny, jkw=dict(faults=jplan),
                        tkw=dict(faults=tplan), **kw)
    for p in ps:
        assert je.submit(p, budget) == te.submit(p, budget)
    out, snaps, errs = ts.lockstep(je, te, recover=True, share=share)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    assert tplan.fired == jplan.fired
    assert [e[1] for e in errs] == [e[0] for e in errs]
    return je, te, out, errs


def _same_as(out, base):
    for u, r in base.items():
        assert out[u].ok, out[u].error
        np.testing.assert_array_equal(out[u].tokens, r.tokens)


@pytest.mark.parametrize("mixed", [False, True], ids=["phased", "mixed"])
def test_host_crash_salvages_with_zero_reprefill(tiny, mixed):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=0)
    je, te, out, errs = _chaos(tiny, ps, 12, lambda p: p.crash(2),
                               mixed=mixed)
    assert errs[2] == ("EngineCrashError",) * 2
    base, bst = _fault_free(tiny, ps, 12, mixed=mixed)
    _same_as(out[1], base)
    st = te.stats
    assert st["recoveries"] == 1 and st["recovered_zero_reprefill"] >= 1
    assert st["re_prefilled_tokens"] == 0
    assert st["prefill_tokens"] == bst["prefill_tokens"]
    assert ts.pool_consistent(te) and te.pool.referenced == 0
    assert len(te._offload) == 0


def test_device_loss_relaunches_deterministically(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=1)
    je, te, out, _ = _chaos(tiny, ps, 12,
                            lambda p: p.crash(2, device_lost=True))
    base, bst = _fault_free(tiny, ps, 12)
    _same_as(out[1], base)
    st = te.stats
    assert st["recovered_zero_reprefill"] == 0
    assert st["re_prefilled_tokens"] > 0
    assert st["prefill_tokens"] > bst["prefill_tokens"]
    assert te._recovered_prefix == {}
    assert ts.pool_consistent(te) and te.pool.referenced == 0


def test_alloc_failure_and_repeated_crashes_chain(tiny):
    ps = ts.prompts(tiny[0].vocab_size, (7, 5), seed=2)
    je, te, out, _ = _chaos(
        tiny, ps, 12, lambda p: (p.fail_alloc(0).crash(2, device_lost=True)
                                 .crash(4, device_lost=True)))
    base, _ = _fault_free(tiny, ps, 12)
    _same_as(out[1], base)
    fired = te._faults.fired
    assert len(fired) == 3 and te.stats["recoveries"] == 3
    assert te.stats["faults_injected"] == 3
    assert ts.pool_consistent(te) and te.pool.referenced == 0


def test_recovery_keeps_queued_and_preempted_work(tiny):
    """A request frozen on the host and two queued ones survive a crash:
    the record restores after the rebuild, nobody re-prefills; the two
    supervisors' summaries agree."""
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 6), seed=3)
    je, te = ts.engines(tiny, max_batch=1)
    out = ({}, {})
    summaries = []
    for e, o, sup, mod in ((je, out[0], jrecovery.Supervisor, jfaults),
                           (te, out[1], trecovery.Supervisor, tfaults)):
        for p in ps:
            e.submit(p, 10)
        o.update((r.uid, r) for r in e.step())
        e.preempt(e.active_lanes[0])
        e.install_faults(mod.FaultPlan().crash(e._step_idx))
        with pytest.raises(mod.EngineCrashError) as ei:
            e.step()
        summaries.append(sup(e).recover(ei.value))
        assert len(e._preempted) == 1 and len(e.scheduler) == 2
        o.update(e.run())
    ts.check_results(tiny, *out)
    ts.check_counters(je, te)
    for k in ("salvaged_lanes", "relaunched_lanes", "finished_lanes",
              "device_lost"):
        assert summaries[1][k] == summaries[0][k], k
    base, bst = _fault_free(tiny, ps, 10, max_batch=1)
    _same_as(out[1], base)
    assert te.stats["restores"] >= 1 and te.stats["re_prefilled_tokens"] == 0
    assert te.stats["prefill_tokens"] == bst["prefill_tokens"]
    assert ts.pool_consistent(te) and te.pool.referenced == 0


def test_recovery_salvages_pinned_pages_of_a_preempted_lane(tiny):
    """A preempted lane that holds prefix-shared pages pinned on the
    device: a host crash pulls them into its record (``extend``), the
    rebuilt engine restores it whole."""
    jcfg = tiny[0]
    rng = np.random.default_rng(1)
    pre = rng.integers(1, jcfg.vocab_size, 8).astype(np.int32)
    ps = [np.concatenate([pre, rng.integers(1, jcfg.vocab_size, k)
                          .astype(np.int32)]) for k in (3, 5)]
    je, te = ts.engines(tiny, max_batch=1, prefix_cache=True)
    for p in ps:
        assert je.submit(p, 10) == te.submit(p, 10)
    state = {}

    def hook(n, je, te):
        i = ts.live_lane_of(je, 1)
        if "pre" not in state and i is not None:
            ts.share_kv(je, te)
            je.preempt(i)
            te.preempt(i)
            je.install_faults(jfaults.FaultPlan().crash(je._step_idx))
            te.install_faults(tfaults.FaultPlan().crash(te._step_idx))
            state["pre"] = n

    out, snaps, errs = ts.lockstep(je, te, hook, recover=True, share=True)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    assert errs[state["pre"] + 1] == ("EngineCrashError",) * 2
    assert te.stats["preempt_pinned_pages"] >= 1
    assert te.stats["re_prefilled_tokens"] == 0
    assert te.stats["restored_pages"] == te.stats["offloaded_pages"]


def test_chaos_oracle(tiny):
    """A NaN lane at step 2, a host crash at step 4 and the first salvage
    record bit-flipped: exactly the two victims fail with
    ``LaneFaultError`` (one of them a checksum), the others stream as the
    fault-free run does, and the pool balances."""
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9, 6), seed=5)
    je, te, out, errs = _chaos(
        tiny, ps, 12, lambda p: (p.poison_logits(2, 1).crash(4)
                                 .corrupt_offload(nth_save=0)))
    assert len(te._faults.fired) == 3
    failed = {u: r.error for u, r in out[1].items() if not r.ok}
    assert len(failed) == 2
    assert all(isinstance(e, tfaults.LaneFaultError)
               for e in failed.values())
    assert sum("checksum" in e.reason for e in failed.values()) == 1
    base, _ = _fault_free(tiny, ps, 12)
    _same_as(out[1], {u: r for u, r in base.items() if u not in failed})
    st = te.stats
    assert st["faults_injected"] == 3 and st["lanes_quarantined"] == 2
    assert st["recoveries"] == 1
    assert ts.pool_consistent(te) and te.pool.referenced == 0
    assert len(te._offload) == 0


def _dying_slab(eng, j):
    """Replace the engine's slab by one that runs ``j`` of its steps,
    writing the cache in place as the real one does, then raises (once)."""
    real = eng._slab
    short = tstep.make_paged_decode_slab_step(
        eng.cfg, j, eng.max_len, eng.page_size, eng.eos_id)
    fired = []

    def slab(params, cache, state, read_pages):
        if fired:
            return real(params, cache, state, read_pages)
        fired.append(True)
        short(params, cache, state, read_pages)
        raise RuntimeError(f"slab died after {j} of its steps")
    eng._slab = slab
    return fired


@pytest.mark.parametrize("j", [1, 3])
def test_partial_slab_crash_recovers_the_uninterrupted_streams(tiny, j):
    """The third slab dies after ``j`` of its 4 steps wrote the live
    lanes' next slots; recovery salvages [0, frontier) and the streams
    are the uninterrupted run's, bitwise, with no re-prefill."""
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9), seed=0)
    base, bst = _fault_free(tiny, ps, 12)
    eng = tengine.Engine(tiny[1], tiny[3], device="cpu", **ts.KW)
    for p in ps:
        eng.submit(p, 12)
    out, crashes = {}, []
    for n in range(100):
        if not ts.busy(eng):
            break
        if n == 2:
            fired = _dying_slab(eng, j)
        try:
            out.update((r.uid, r) for r in eng.step())
        except RuntimeError as e:
            crashes.append(str(e))
            summary = trecovery.Supervisor(eng).recover(e)
            assert summary["salvaged_lanes"] == 2
            assert summary["relaunched_lanes"] == 0
    assert fired and crashes == [f"slab died after {j} of its steps"]
    _same_as(out, base)
    st = eng.finalize_stats()
    assert st["re_prefilled_tokens"] == 0
    assert st["recovered_zero_reprefill"] == 2
    assert st["prefill_tokens"] == bst["prefill_tokens"]


def test_partial_mixed_call_crash_recovers(tiny):
    """The same for the mixed engine: a fused call that wrote a decode
    lane's KV and a prompt chunk in place, then died. The decode lane is
    salvaged, the lane mid-prompt relaunches (its prompt prefills again,
    counted)."""
    ps = ts.prompts(tiny[0].vocab_size, (7, 5, 9, 6), seed=6)
    budgets = (10, 3, 10, 6)
    kw = dict(ts.KW, mixed=True, prefill_chunk=4)

    def engine():
        eng = tengine.Engine(tiny[1], tiny[3], device="cpu", **kw)
        for p, b in zip(ps, budgets):
            eng.submit(p, b)
        return eng

    base = engine().run()
    eng = engine()
    real, out, crashed = eng._mixed_fn, {}, []

    def mixed(*a, **kw):
        r = real(*a, **kw)
        if not crashed and eng._prefilling and any(
                eng._mirror["live"][i] for i in eng.active_lanes):
            crashed.append(dict(eng._prefilling))
            raise RuntimeError("mixed call died after its writes")
        return r
    eng._mixed_fn = mixed
    for _ in range(100):
        if not ts.busy(eng):
            break
        try:
            out.update((r.uid, r) for r in eng.step())
        except RuntimeError as e:
            summary = trecovery.Supervisor(eng).recover(e)
            assert summary["salvaged_lanes"] == 1
            assert summary["relaunched_lanes"] == 1
    assert crashed
    _same_as(out, base)
    st = eng.stats
    assert st["recovered_zero_reprefill"] == 1
    assert st["re_prefilled_tokens"] > 0
