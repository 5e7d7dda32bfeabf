"""Preemption with host KV offload in the port's engine against the
reference engine, in lockstep (``_torch_serving.py``): forced and
automatic (SLA) preemption, and a preempted lane holding prefix-shared
pages pinned. After every step the streams' state, block tables, page
states, preempted records and host-store records are equal (with the
pools' bytes shared, their crc32s bitwise); the finished streams equal
the reference's and an uninterrupted run's, with no token prefilled
twice."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import _torch_serving as ts  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.offload import OffloadRecord as JRecord  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.offload import _bytes  # noqa: E402

FORCED = {"tiny_phased": ("tiny", {}), "smoke_phased": ("smoke", {}),
          "tiny_mixed": ("tiny", dict(mixed=True))}


@pytest.fixture(scope="module")
def tiny():
    return ts.build("tiny")


@pytest.fixture(scope="module", params=sorted(FORCED))
def forced(request, tiny):
    """Three requests on two lanes; request 0 is preempted by hand the
    first time it decodes, and comes back when a lane frees. The pool
    pages it held are read just before the preemption, to hold the record
    against them."""
    name, mode = FORCED[request.param]
    model = tiny if name == "tiny" else ts.build(name)
    ps = ts.prompts(model[0].vocab_size, (7, 5, 9))
    je, te = ts.engines(model, **mode)
    for p in ps:
        assert je.submit(p, 12) == te.submit(p, 12)
    seen = {}

    def hook(n, je, te):
        i = ts.live_lane_of(je, 0)
        if seen or i is None:
            return
        assert ts.live_lane_of(te, 0) == i
        n_live = te.pool.slots_for(int(te.frontiers[i]))
        pages = te.lanes[i].pages[:n_live]
        seen["pool"] = (te.cache["k"][:, pages].clone(),
                        te.cache["v"][:, pages].clone())
        je.preempt(i)
        te.preempt(i)
        seen["rec"] = te._offload._recs[0]

    out, snaps, _ = ts.lockstep(je, te, hook)
    base = tengine.Engine(model[1], model[3], device="cpu", **ts.KW, **mode)
    for p in ps:
        base.submit(p, 12)
    return dict(model=model, je=je, te=te, out=out, snaps=snaps,
                seen=seen, base=base.run(), base_stats=base.stats)


def test_forced_streams_equal_reference(forced):
    ts.check_results(forced["model"], *forced["out"])


def test_forced_streams_equal_uninterrupted_run(forced):
    """Bitwise: the preempted lane resumes from its own KV, so nothing
    about its numerics changes."""
    for u, r in forced["out"][1].items():
        np.testing.assert_array_equal(r.tokens, forced["base"][u].tokens)


def test_forced_state_equal_after_every_step(forced):
    ts.check_snapshots(forced["snaps"])


def test_forced_counters(forced):
    je, te = forced["je"], forced["te"]
    ts.check_counters(je, te)
    st = te.stats
    assert st["preemptions"] == st["restores"] == 1
    assert st["restored_pages"] == st["offloaded_pages"] > 0
    # no re-prefill: the same prompt tokens computed as the plain run
    assert st["prefill_tokens"] == forced["base_stats"]["prefill_tokens"]
    assert st["re_prefilled_tokens"] == 0
    assert ts.pool_consistent(te) and te.pool.free_pages == te.pool.n_pages
    assert len(te._offload) == 0


def test_forced_record_is_the_pool_pages_bitwise(forced):
    """The record holds exactly the pool pages it left (raw bf16 words),
    and its crc32s are the reference algorithm's over the same bytes."""
    rec, (k, v) = forced["seen"]["rec"], forced["seen"]["pool"]
    assert rec.k.dtype == torch.bfloat16
    assert _bytes(rec.k) == _bytes(k) and _bytes(rec.v) == _bytes(v)
    ref = JRecord(rec.logical,
                  rec.k.view(torch.int16).numpy(),
                  rec.v.view(torch.int16).numpy())
    assert rec.checksums == [ref.page_crc(i)
                             for i in range(len(rec.logical))]
    assert rec.nbytes == ref.nbytes


@pytest.fixture(scope="module")
def auto(tiny):
    """``preempt=True`` with the SLA scheduler: a batch request pins 7 of
    8 pages, and an interactive one arriving mid-decode needs 3, so
    admission preempts the batch lane; a second batch request waits."""
    jcfg = tiny[0]
    rng = np.random.default_rng(2)
    p_batch = rng.integers(1, jcfg.vocab_size, 8).astype(np.int32)
    p_inter = rng.integers(1, jcfg.vocab_size, 6).astype(np.int32)
    p_late = rng.integers(1, jcfg.vocab_size, 4).astype(np.int32)
    kw = dict(max_batch=2, max_len=32, slab_k=2, n_pages=8, preempt=True)
    je, te = ts.engines(
        tiny, jkw=dict(scheduler=jsched.SLAScheduler(2, 32, aging_s=None)),
        tkw=dict(scheduler=tsched.SLAScheduler(2, 32, aging_s=None)), **kw)
    assert je.submit(p_batch, 20, priority=1) == te.submit(p_batch, 20,
                                                           priority=1)

    def hook(n, je, te):
        if n == 1:
            for e in (je, te):
                e.submit(p_inter, 4, priority=0)
                e.submit(p_late, 3, priority=1)

    out, snaps, _ = ts.lockstep(je, te, hook, share=True)
    return dict(je=je, te=te, out=out, snaps=snaps)


def test_auto_preempt_equal_reference(auto, tiny):
    ts.check_results(tiny, *auto["out"])
    ts.check_snapshots(auto["snaps"])
    ts.check_counters(auto["je"], auto["te"])
    st = auto["te"].stats
    assert st["preemptions"] >= 1 and st["restores"] == st["preemptions"]
    assert st["re_prefilled_tokens"] == 0


def test_full_host_store_leaves_the_victim_running(tiny):
    """The auto scenario with a host budget no record fits: preemption
    raises ``OffloadCapacityError`` before changing anything, the batch
    lane runs on and the interactive head waits, as in the reference."""
    jcfg = tiny[0]
    rng = np.random.default_rng(2)
    p_batch = rng.integers(1, jcfg.vocab_size, 8).astype(np.int32)
    p_inter = rng.integers(1, jcfg.vocab_size, 6).astype(np.int32)
    kw = dict(max_batch=2, max_len=32, slab_k=2, n_pages=8, preempt=True,
              offload_capacity_bytes=1024)
    je, te = ts.engines(
        tiny, jkw=dict(scheduler=jsched.SLAScheduler(2, 32, aging_s=None)),
        tkw=dict(scheduler=tsched.SLAScheduler(2, 32, aging_s=None)), **kw)
    for e in (je, te):
        e.submit(p_batch, 20, priority=1)

    def hook(n, je, te):
        if n == 1:
            for e in (je, te):
                e.submit(p_inter, 4, priority=0)

    out, snaps, _ = ts.lockstep(je, te, hook)
    ts.check_results(tiny, *out)
    ts.check_snapshots(snaps)
    ts.check_counters(je, te)
    st = te.stats
    assert st["preemptions"] == 0 and st["offloaded_pages"] == 0
    assert st["offload_capacity_bytes"] == 1024
    assert st["admission_rejections"] >= 1       # the head waited


@pytest.fixture(scope="module")
def shared(tiny):
    """The prefix cache on one lane: the second request shares an
    8-token prefix with the first, which finished; preempting it keeps
    the shared pages pinned and offloads only its own."""
    jcfg = tiny[0]
    rng = np.random.default_rng(1)
    pre = rng.integers(1, jcfg.vocab_size, 8).astype(np.int32)
    ps = [np.concatenate([pre, rng.integers(1, jcfg.vocab_size, k)
                          .astype(np.int32)]) for k in (3, 5)]
    je, te = ts.engines(tiny, max_batch=1, prefix_cache=True)
    for p in ps:
        assert je.submit(p, 10) == te.submit(p, 10)
    done = []

    def hook(n, je, te):
        i = ts.live_lane_of(je, 1)
        if not done and i is not None:
            ts.share_kv(je, te)
            je.preempt(i)
            te.preempt(i)
            done.append(n)

    out, snaps, _ = ts.lockstep(je, te, hook, share=True)
    return dict(je=je, te=te, out=out, snaps=snaps)


def test_shared_pages_stay_pinned(shared, tiny):
    ts.check_results(tiny, *shared["out"])
    ts.check_snapshots(shared["snaps"])
    ts.check_counters(shared["je"], shared["te"])
    st = shared["te"].stats
    assert st["preemptions"] == 1 and st["preempt_pinned_pages"] >= 1
    assert st["restored_pages"] == st["offloaded_pages"]
    assert any(s[1]["preempted"] and s[1]["preempted"][0][4]
               for s in shared["snaps"])        # pinned pages held


def test_engine_keeps_injected_empty_scheduler(tiny):
    """An empty scheduler is falsy (``__len__`` 0): the engine must keep
    it, and its SLA order reaches admission."""
    sched = tsched.SLAScheduler(2, 32, aging_s=None)
    eng = tengine.Engine(tiny[1], tiny[3], max_batch=2, max_len=32,
                         page_size=4, scheduler=sched, device="cpu")
    assert eng.scheduler is sched
    eng.submit(np.ones(4, np.int32), 2, priority=tsched.BATCH)
    eng.submit(np.ones(4, np.int32), 2, priority=tsched.INTERACTIVE)
    assert eng.scheduler.head().priority == tsched.INTERACTIVE


def test_preempt_requires_paged_and_a_live_lane(tiny):
    with pytest.raises(ValueError, match="preempt=True requires"):
        tengine.Engine(tiny[1], tiny[3], max_batch=1, max_len=32,
                       paged=False, preempt=True, device="cpu")
    eng = tengine.Engine(tiny[1], tiny[3], max_batch=1, max_len=32,
                         page_size=4, device="cpu")
    with pytest.raises(ValueError, match="not a live decode lane"):
        eng.preempt(0)
