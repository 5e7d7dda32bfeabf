"""Shared scenario of the engine-mode parity tests
(``test_torch_engine_{contiguous,mixed,prefix,mixed_prefix}.py``): one
traffic mix run through the reference engine and the port's in lockstep,
once per module, so each file asserts on it many times.

The traffic: 11 ragged requests on 3 lanes; prompts share an 8-token
(page-aligned) and a 10-token (mid-page) system prefix, diverge at page
boundaries and inside pages, repeat an earlier prompt whole (the match
stops at ``plen - 1``) and extend one; one request outgrows ``max_len``
(truncated). The pool of 14 pages is small enough that the page gate
blocks a head and, with the prefix cache, cached pages are evicted; the
mixed engine, whose lanes pin only their own extent, gets 10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import (_assert_same_or_near_tie,  # noqa: E402
                               _port_margin, _ref_margin)
from test_torch_transformer import CFGS, port_cfg, serving_params  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

KW = dict(max_batch=3, max_len=32, prefill_chunk=4, page_size=4, slab_k=4,
          n_pages=14)
# counters the reference and the port must agree on in every mode
COUNTERS = ("generated_tokens", "decode_tokens", "prefill_tokens",
            "prompt_tokens", "prefill_chunks", "decode_slabs",
            "decode_steps", "mixed_steps", "stalled_decode_steps",
            "admitted", "evicted", "truncated", "prefix_hits",
            "prefix_misses", "prefill_tokens_skipped", "cow_copies",
            "cache_evicted_pages", "pages_read", "pages_read_dense_equiv",
            "admission_rejections", "admission_rejected_steps",
            "peak_kv_bytes", "kv_bytes_contiguous_equiv")


def traffic(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)

    def r(n):
        return rng.integers(0, vocab, size=n).astype(np.int32).tolist()

    a, b = r(8), r(10)
    prompts = [a + r(3), b + r(2), a + r(5), b[:6] + r(4), r(7),
               a + r(3), b + r(1), a + r(9), r(12), b + r(6), r(20)]
    prompts[5] = list(prompts[0])               # a repeat: capped match
    prompts[7] = prompts[2] + r(2)              # extends an earlier one
    budgets = [5, 4, 6, 3, 7, 5, 2, 6, 4, 5, 20]
    return [np.asarray(p, np.int32) for p in prompts], budgets


def _snapshot(eng, paged):
    snap = {"lanes": list(eng.active_lanes),
            "frontier": eng.frontiers.tolist()}
    if paged:
        snap.update(bt=eng.block_tables.tolist(),
                    free=eng.pool.free_pages,
                    referenced=eng.pool.referenced,
                    cached_idle=eng.pool.cached_idle,
                    peak=eng.pool.peak_in_use)
    return snap


def lockstep(name: str, mode: dict, tracers=(None, None), **kw):
    """Run the scenario through both engines, one step each in turn
    (``kw`` overrides ``KW``; ``tracers`` are the reference's and the
    port's ``tracer=``).
    Returns a dict: per-step snapshots, results and stats per side, the
    prompts, and the port's phased paged streams on the same traffic."""
    jcfg = CFGS[name]()
    tcfg = port_cfg(jcfg)
    jp, tp = serving_params(jcfg, packed=True)
    prompts, budgets = traffic(jcfg.vocab_size)
    paged = mode.get("paged", True)
    kw = dict(KW, **kw)
    je = jengine.Engine(jcfg, jp, tracer=tracers[0], **kw, **mode)
    te = tengine.Engine(tcfg, tp, device="cpu", tracer=tracers[1], **kw,
                        **mode)
    for p, n in zip(prompts, budgets):
        assert je.submit(p, n) == te.submit(p, n)
    snaps_j, snaps_t, done_j, done_t = [], [], {}, {}
    for _ in range(500):
        if not (len(je.scheduler) or je.active_lanes or len(te.scheduler)
                or te.active_lanes):
            break
        done_j.update((r.uid, r) for r in je.step())
        done_t.update((r.uid, r) for r in te.step())
        snaps_j.append(_snapshot(je, paged))
        snaps_t.append(_snapshot(te, paged))
    js, ts = je.finalize_stats(), te.finalize_stats()
    phased = tengine.Engine(tcfg, tp, device="cpu", **kw)
    uids = [phased.submit(p, n) for p, n in zip(prompts, budgets)]
    ph = phased.run()
    return dict(name=name, jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                prompts=prompts, budgets=budgets, snaps_j=snaps_j,
                snaps_t=snaps_t, done_j=done_j, done_t=done_t,
                stats_j=dict(js), stats_t=dict(ts),
                phased=[ph[u].tokens for u in uids], te=te)


def check_streams(run) -> None:
    assert sorted(run["done_t"]) == sorted(run["done_j"])
    for u, p in enumerate(run["prompts"]):
        got, want = run["done_t"][u], run["done_j"][u]
        assert got.ok and want.ok and got.truncated == want.truncated
        _assert_same_or_near_tie(
            got.tokens, np.asarray(want.tokens), p.size,
            lambda s: _ref_margin(run["jcfg"], run["jp"], s))


def check_phased(run) -> None:
    for u, p in enumerate(run["prompts"]):
        _assert_same_or_near_tie(
            run["done_t"][u].tokens, run["phased"][u], p.size,
            lambda s: _port_margin(run["tcfg"], run["tp"], s))


def check_snapshots(run, key) -> None:
    assert len(run["snaps_t"]) == len(run["snaps_j"])
    for i, (t, j) in enumerate(zip(run["snaps_t"], run["snaps_j"])):
        assert t[key] == j[key], f"step {i}: {key}"
