"""Shared helpers of the preemption, fault and recovery parity tests
(``test_torch_engine_preempt.py``, ``test_torch_faults.py``,
``test_torch_recovery.py``): the reference engine and the port's are
built on the same packed weights (crossed through ``interop``) and driven
one step each in turn; after every step the lanes, frontiers, block
tables, the pool's page states, the queue, the preempted records and the
host store's records (logical pages and sizes) must be equal. The two
sides' bf16 pools may differ in the last bit of a value (their f32
arithmetic differs at ~1e-6), so a run that holds the records' crc32s
bitwise to the reference's first copies the reference's pool into the
port's at every step (``share_kv``).

Tokens must be equal; a divergence is accepted only where the
reference's top-2 logit margin at that step is below 1e-5 (both sides
agree to ~1e-6 in f32, so only such a near-tie can flip an argmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import (_assert_same_or_near_tie,  # noqa: E402
                               _ref_margin)
from test_torch_transformer import CFGS, port_cfg, serving_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import recovery as jrecovery  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import recovery as trecovery  # noqa: E402

KW = dict(max_batch=2, max_len=48, slab_k=4, page_size=4)
# counters the reference and the port must agree on in these scenarios
COUNTERS = ("generated_tokens", "decode_tokens", "prefill_tokens",
            "prompt_tokens", "admitted", "evicted", "truncated",
            "preemptions", "restores", "offloaded_pages", "restored_pages",
            "preempt_pinned_pages", "offload_bytes_peak", "queue_depth_peak",
            "faults_injected", "lanes_quarantined", "recoveries",
            "recovered_zero_reprefill", "re_prefilled_tokens",
            "shed_requests", "cancelled", "deadline_cancelled",
            "prefix_hits", "cow_copies", "cache_evicted_pages",
            "admission_rejections", "admission_rejected_steps")


def build(name="tiny"):
    """(jcfg, tcfg, reference params, port params), packed at s = 0.8."""
    jcfg = CFGS[name]()
    jp, tp = serving_params(jcfg, packed=True)
    return jcfg, port_cfg(jcfg), jp, tp


def prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def engines(model, *, jkw=None, tkw=None, **kw):
    """The reference engine and the port's with the same settings (``kw``
    over ``KW``; ``jkw``/``tkw`` for each side's own objects, such as a
    scheduler or a fault plan)."""
    jcfg, tcfg, jp, tp = model
    kw = dict(KW, **kw)
    return (jengine.Engine(jcfg, jp, **kw, **(jkw or {})),
            tengine.Engine(tcfg, tp, device="cpu", **kw, **(tkw or {})))


def busy(e) -> bool:
    return bool(len(e.scheduler) or e.active_lanes or e._preempted
                or e._pending_results)


def share_kv(je, te) -> None:
    """Give the port's pool the reference's bytes (bf16 bits)."""
    te.cache = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy())
                .view(te.cache[k].dtype) for k, v in je.cache.items()}


def snapshot(e, crc: bool) -> dict:
    snap = {"lanes": list(e.active_lanes),
            "frontier": e.frontiers.tolist(),
            "queue": [r.uid for r in e.scheduler._queue],
            "preempted": [(p.req.uid, p.frontier, p.remaining, p.n_pages,
                           sorted(p.pinned.items()), p.recovered,
                           len(p.generated)) for p in e._preempted]}
    if e.paged:
        snap.update(
            bt=e.block_tables.tolist(), free=e.pool.free_pages,
            referenced=e.pool.referenced, cached_idle=e.pool.cached_idle,
            offload={u: (r.logical, r.checksums if crc else r.nbytes)
                     for u, r in sorted(e._offload._recs.items())})
    return snap


def lockstep(je, te, hook=None, recover=False, share=False,
             max_steps=300):
    """Step both engines in turn until both drain. ``hook(n, je, te)``
    runs after step ``n`` of both; with ``recover`` an exception from a
    step is recovered in place by that side's ``Supervisor`` (the
    synchronous stand-in for the watchdog); with ``share`` each step
    starts from the reference's pool (``share_kv``) and the records'
    crc32s are compared. Returns (results of each side, per-step snapshot
    pairs, per-step exception names of each side)."""
    out = ({}, {})
    snaps, errs = [], []
    for n in range(max_steps):
        if not (busy(je) or busy(te)):
            break
        if share:
            share_kv(je, te)
        names = []
        for e, o, sup in ((je, out[0], jrecovery.Supervisor),
                          (te, out[1], trecovery.Supervisor)):
            try:
                o.update((r.uid, r) for r in e.step())
                names.append(None)
            except Exception as exc:
                if not recover:
                    raise
                names.append(type(exc).__name__)
                sup(e).recover(exc)
        errs.append(tuple(names))
        if hook is not None:
            hook(n, je, te)
        snaps.append((snapshot(je, share), snapshot(te, share)))
    else:
        raise AssertionError(f"engines did not drain in {max_steps} steps")
    je.finalize_stats()
    te.finalize_stats()
    return out, snaps, errs


def check_snapshots(snaps) -> None:
    for n, (j, t) in enumerate(snaps):
        for key in j:
            assert t[key] == j[key], f"step {n}: {key}"


def check_results(model, out_j, out_t) -> None:
    """Same uids, the same error types (and lanes and reasons), and the
    same tokens (or a reference near-tie) for every request."""
    jcfg, _, jp, _ = model
    assert sorted(out_t) == sorted(out_j)
    for u, want in out_j.items():
        got = out_t[u]
        assert type(got.error).__name__ == type(want.error).__name__, u
        for attr in ("uid", "lane", "reason", "logical"):
            if hasattr(want.error, attr):
                assert getattr(got.error, attr) == getattr(want.error,
                                                           attr), attr
        np.testing.assert_array_equal(got.prompt, want.prompt)
        if got.ok:
            assert got.truncated == want.truncated
            _assert_same_or_near_tie(
                got.tokens, np.asarray(want.tokens), got.prompt.size,
                lambda s: _ref_margin(jcfg, jp, s))
        else:
            n = min(got.generated.size, want.generated.size)
            assert got.generated.size == want.generated.size, u
            np.testing.assert_array_equal(got.generated[:n],
                                          want.generated[:n])


def check_counters(je, te, keys=COUNTERS) -> None:
    for k in keys:
        assert te.stats.get(k, 0) == je.stats.get(k, 0), k


# span attributes that are seconds on each side's own clock; the events'
# other attributes must be equal
TIME_ATTRS = ("queued_s", "ttft_s", "sec_per_step", "median_s")


def events(spans) -> list:
    """(name, attrs without the timed ones) of each span, oldest first;
    ``spans`` is a tracer's ring or a postmortem's ``spans`` list."""
    out = []
    for s in list(spans):
        name, attrs = ((s["name"], s["attrs"]) if isinstance(s, dict)
                       else (s.name, s.attrs))
        out.append((name, {k: v for k, v in attrs.items()
                           if k not in TIME_ATTRS}))
    return out


def pool_consistent(e) -> bool:
    p = e.pool
    return p.free_pages + p.referenced + p.cached_idle == p.n_pages


def live_lane_of(e, uid):
    """The lane on which request ``uid`` decodes, or None."""
    for i in e.active_lanes:
        if (e._mirror["live"][i] and i not in e._prefilling
                and e.lanes[i].req.uid == uid):
            return i
    return None
