"""The port's refcounted page pool, radix-tree prefix cache and token
budget planner against the reference's (``repro/serving/pages.py``,
``prefix_cache.py``, ``scheduler.py``): seeded random operation
sequences run against both, and every return value, raised error, free
list, refcount, cached flag, peak, ``Match``, tree node and
``reclaimable`` must be equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import pages as jpages  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.serving import pages as tpages  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402


def _pool_state(pool):
    return (list(pool._free), list(pool._rc), list(pool._cached),
            pool.free_pages, pool.in_use, pool.referenced, pool.cached_idle,
            pool.cached_pages, pool.peak_in_use, pool.peak_referenced)


def _both(fn_j, fn_t):
    """Run one operation on both sides: equal results, or both raise."""
    try:
        want = ("ok", fn_j())
    except (AssertionError, RuntimeError, ValueError):
        want = ("raised",)
    try:
        got = ("ok", fn_t())
    except (RuntimeError, ValueError):
        got = ("raised",)
    assert got == want
    return want[0] == "ok"


@pytest.mark.parametrize("seed", range(8))
def test_pool_random_walk_matches_reference(seed):
    """alloc / retain / release / cache_add / cache_drop / uncache at
    random, valid and invalid (double frees, retains of free pages,
    drops of referenced pages), on both pools."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 13))
    jp, tp = jpages.PagePool(n, 4), tpages.PagePool(n, 4)
    ops = ["alloc", "retain", "release", "cache_add", "cache_drop",
           "uncache", "reset_peaks"]
    for _ in range(300):
        op = ops[int(rng.integers(len(ops)))]
        if op == "alloc":
            k = int(rng.integers(0, 4))
            _both(lambda: jp.alloc(k), lambda: tp.alloc(k))
        elif op == "reset_peaks":
            _both(jp.reset_peaks, tp.reset_peaks)
        else:
            # mostly pages in a plausible state, sometimes any page
            if rng.random() < 0.8:
                cand = [p for p in range(n) if jp._rc[p] or jp._cached[p]]
            else:
                cand = list(range(n))
            if not cand:
                continue
            k = int(rng.integers(1, min(3, len(cand)) + 1))
            pages = [int(p) for p in rng.choice(cand, size=k, replace=False)]
            _both(lambda: getattr(jp, op)(list(pages)),
                  lambda: getattr(tp, op)(list(pages)))
        assert _pool_state(tp) == _pool_state(jp)
        for p in range(n):
            assert tp.exclusive(p) == jp.exclusive(p)
            assert tp.is_cached(p) == jp.is_cached(p)
            assert tp.refcount(p) == jp.refcount(p)


def test_pool_rejects_what_the_reference_rejects():
    for Pool in (jpages.PagePool, tpages.PagePool):
        pool = Pool(4, 2)
        a = pool.alloc(2)
        pool.release(a)
        with pytest.raises(RuntimeError, match="double free"):
            pool.release([a[0]])
        with pytest.raises(RuntimeError, match="retain of free page"):
            pool.retain([a[1]])
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(5)
        b = pool.alloc(1)
        pool.cache_add(b)
        with pytest.raises(RuntimeError, match="still referenced"):
            pool.cache_drop(b)
        assert pool.slots_for(5) == 3


def _tree(node):
    """A node and its subtree as plain data, children in insertion order
    (match scans them in that order)."""
    return (tuple(node.edge), tuple(node.pages), node.last_access,
            tuple((t.tokens, t.page, t.last_access) for t in node.tails),
            tuple((k, _tree(c)) for k, c in node.children.items()))


def _match(m):
    return (list(m.pages), m.matched_tokens, m.tail_page, m.tail_matched)


class _Side:
    """One pool + tree driven as the engine drives them: a request's
    match is pinned, its own pages allocated, the sequence inserted on
    finish and the lane's pages released."""

    def __init__(self, pages_mod, pc_mod, n_pages, ps):
        self.pool = pages_mod.PagePool(n_pages, ps)
        self.tree = pc_mod.PrefixCache(self.pool)

    def serve(self, seq, plen):
        m = self.tree.match(seq[:plen])
        pin = m.pages + ([m.tail_page] if m.tail_page is not None else [])
        self.pool.retain(pin)
        need = self.pool.slots_for(len(seq)) - len(m.pages)
        short = need - self.pool.free_pages
        evicted = self.tree.evict(short) if short > 0 else 0
        if need > self.pool.free_pages:
            self.pool.release(pin)
            return _match(m), evicted, None
        own = self.pool.alloc(need)
        if m.tail_page is not None:
            self.pool.release([m.tail_page])
        pages = m.pages + own
        donated = self.tree.insert(seq, pages)
        self.pool.release(pages)
        return _match(m), evicted, donated


@pytest.mark.parametrize("seed", range(8))
def test_radix_random_walk_matches_reference(seed):
    """match / insert / evict / flush at random over prompts built from a
    few shared stems (page-aligned and mid-page), so walks end at page
    boundaries, inside edges and inside tails, and the ``plen - 1`` cap
    bites on repeated prompts."""
    rng = np.random.default_rng(100 + seed)
    ps = int(rng.choice([2, 4]))
    n_pages = int(rng.integers(10, 24))
    stems = [rng.integers(0, 5, size=int(k)).tolist()
             for k in (ps * 2, ps * 3 - 1, ps + 1, 3)]
    j = _Side(jpages, jpc, n_pages, ps)
    t = _Side(tpages, tpc, n_pages, ps)
    seen = []
    for step in range(120):
        r = rng.random()
        if r < 0.6:
            if seen and rng.random() < 0.25:
                seq = list(seen[int(rng.integers(len(seen)))])
            else:
                stem = stems[int(rng.integers(len(stems)))]
                cut = int(rng.integers(0, len(stem) + 1))
                seq = stem[:cut] + rng.integers(
                    0, 5, size=int(rng.integers(1, 2 * ps + 2))).tolist()
            seen.append(seq)
            plen = int(rng.integers(1, len(seq) + 1))
            arr = np.asarray(seq, np.int32)
            assert t.serve(arr, plen) == j.serve(arr, plen)
        elif r < 0.8:
            k = int(rng.integers(1, 5))
            assert t.tree.evict(k) == j.tree.evict(k)
        elif r < 0.97:
            seq = np.asarray(seen[int(rng.integers(len(seen)))]
                             if seen else [1, 2, 3], np.int32)
            assert _match(t.tree.match(seq)) == _match(j.tree.match(seq))
        else:
            assert t.tree.flush() == j.tree.flush()
        assert _tree(t.tree.root) == _tree(j.tree.root)
        assert t.tree.reclaimable() == j.tree.reclaimable()
        assert len(t.tree) == len(j.tree)
        assert _pool_state(t.pool) == _pool_state(j.pool)


@pytest.mark.parametrize("case", ["page_boundary", "mid_edge", "tail",
                                  "cap", "split"])
def test_radix_named_cases_match_reference(case):
    """Divergence at a page boundary, inside an edge's page, inside a
    tail; a repeated prompt capped at ``plen - 1``; an edge split by a
    second insert."""
    ps = 4
    base = list(range(1, 11))                       # 2 full pages + 2
    probe = {"page_boundary": base[:8] + [40, 41],
             "mid_edge": base[:5] + [40, 41, 42],
             "tail": base[:9] + [40],
             "cap": base,
             "split": base[:4] + [40] * 6}[case]
    out = []
    for pages_mod, pc_mod in ((jpages, jpc), (tpages, tpc)):
        side = _Side(pages_mod, pc_mod, 12, ps)
        res = [side.serve(np.asarray(base, np.int32), len(base))]
        res.append(side.serve(np.asarray(probe, np.int32), len(probe)))
        res.append(_match(side.tree.match(np.asarray(probe, np.int32))))
        out.append((res, _tree(side.tree.root), _pool_state(side.pool)))
    assert out[1] == out[0]
    # the probe's own match, made before it was inserted
    _, matched, tail_page, tail_matched = out[1][0][1][0]
    assert (matched, tail_matched) == {
        "page_boundary": (8, 0), "mid_edge": (5, 1), "tail": (9, 1),
        "cap": (9, 1), "split": (4, 0)}[case]
    assert (tail_page is None) == (tail_matched == 0)


@pytest.mark.parametrize("seed", range(6))
def test_plan_chunks_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        budget = (None if rng.random() < 0.15
                  else int(rng.integers(1, 40)))
        js = jsched.FIFOScheduler(8, 64, prefill_token_budget=budget)
        ts = tsched.FIFOScheduler(8, 64, prefill_token_budget=budget)
        lanes = rng.permutation(8)[:int(rng.integers(0, 8))]
        tails = [(int(i), int(rng.integers(1, 50))) for i in lanes]
        n_dec = int(rng.integers(0, 9))
        cap = int(rng.integers(1, 17))
        got = ts.plan_chunks(tails, n_dec, cap)
        assert got == js.plan_chunks(tails, n_dec, cap)
        assert list(got) == [i for i, _ in tails][:len(got)]


def test_admit_counts_rejections_and_push_front_like_reference():
    """A page-gated head counts once per distinct head and once per
    attempt; ``push_front`` restores the queue order; ``head`` peeks."""
    outs = []
    for mod in (jsched, tsched):
        s = mod.FIFOScheduler(4, 64)
        reqs = [mod.Request(u, np.arange(1, 2 + u, dtype=np.int32), 4)
                for u in range(5)]
        for r in reqs:
            s.submit(r)
        cost = lambda g: sum(r.prompt_len for r in g)  # noqa: E731
        trace = []
        for free_pages in (3, 3, 1, 9, 9):
            got = s.admit(4, free_pages, cost)
            trace.append(([r.uid for r in got], s.rejections,
                          s.rejected_steps, s.head().uid if s.head()
                          else None))
            if len(got) > 1:
                s.push_front(got[1:])
        s.reset_stats()
        trace.append((s.rejections, s.rejected_steps, len(s)))
        outs.append(trace)
    assert outs[1] == outs[0]
