"""The port's serving engine against the reference engine
(``repro.serving.engine``, paged, phased FIFO): greedy token streams,
block tables and page accounting on ``tiny_cfg`` and ``LLAMA32_1B_SMOKE``
with packed weights, ragged prompts and more requests than lanes.

Tokens must be equal. A divergence is accepted only where the test
shows the reference's top-2 logit margin at that step to be below 1e-5
(both sides agree to ~1e-6, so only such a near-tie can flip an argmax).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_transformer import CFGS, port_cfg, serving_params  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

KW = dict(max_batch=2, max_len=32, prefill_chunk=4, page_size=4)
NEAR_TIE = 1e-5


def _prompts(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(int(p),)).astype(np.int32)
            for p in rng.integers(3, 13, size=n)]


def _margin(logits) -> float:
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def _ref_margin(jcfg, jp, seq, ps=4) -> float:
    """Top-2 margin of the reference's next-token logits after ``seq``,
    through its paged prefill with a bf16 pool, as its engine computes."""
    pages = -(-len(seq) // ps)
    logits, _ = jtr.paged_prefill_chunk(
        jcfg, jp, jtr.init_paged_cache(jcfg, pages, ps),
        jnp.asarray(seq)[None], 0, jnp.zeros((1,), jnp.int32),
        jnp.arange(pages, dtype=jnp.int32)[None], read_pages=pages)
    return _margin(logits[0, -1])


def _port_margin(tcfg, tp, seq, ps=4) -> float:
    pages = -(-len(seq) // ps)
    logits, _ = ttr.paged_prefill_chunk(
        tcfg, tp, ttr.init_paged_cache(tcfg, pages, ps, device="cpu"),
        torch.as_tensor(seq)[None], 0, torch.zeros(1, dtype=torch.int32),
        torch.arange(pages, dtype=torch.int32)[None], read_pages=pages)
    return _margin(logits[0, -1])


def _assert_same_or_near_tie(got, want, plen, margin_at):
    if np.array_equal(got, want):
        return
    assert got.shape == want.shape
    t = int(np.argmax(got[plen:] != want[plen:]))
    m = margin_at(want[:plen + t])
    assert m < NEAR_TIE, (f"diverged at generated token {t} where the "
                          f"reference's top-2 margin is {m:.3g}")


@pytest.mark.parametrize("name,slab_k,backend", [
    ("tiny", 1, "xla"), ("tiny", 4, "xla"), ("smoke", 1, "xla"),
    ("smoke", 4, "xla"), ("tiny", 4, "pallas_interp")])
def test_tokens_match_reference_engine(name, slab_k, backend):
    jcfg = CFGS[name]()
    tcfg = port_cfg(jcfg)
    jp, tp = serving_params(jcfg, packed=True)
    prompts = _prompts(jcfg.vocab_size)
    want, jst = jengine.generate(jcfg, jp, prompts, max_new_tokens=7,
                                 slab_k=slab_k, paged=True,
                                 attn_backend=backend, **KW)
    got, tst = tengine.generate(tcfg, tp, prompts, max_new_tokens=7,
                                slab_k=slab_k, device="cpu", **KW)
    for p, g, w in zip(prompts, got, want):
        _assert_same_or_near_tie(g, np.asarray(w), p.size,
                                 lambda s: _ref_margin(jcfg, jp, s))
    for key in ("decode_slabs", "prefill_chunks", "generated_tokens",
                "peak_kv_bytes", "truncated"):
        assert tst[key] == jst[key], key


def test_block_tables_and_pages_in_lockstep():
    """Stepping both engines together: the same admissions, block
    tables, free pages and peaks after every step (finishing depends only
    on counts, so the host bookkeeping must agree exactly)."""
    jcfg = CFGS["tiny"]()
    tcfg = port_cfg(jcfg)
    jp, tp = serving_params(jcfg, packed=True)
    kw = dict(KW, max_len=24, slab_k=4)
    je = jengine.Engine(jcfg, jp, paged=True, **kw)
    te = tengine.Engine(tcfg, tp, device="cpu", **kw)
    budgets = (3, 9, 5, 2, 7, 4)
    for p, n in zip(_prompts(jcfg.vocab_size, n=6, seed=7), budgets):
        assert je.submit(p, n) == te.submit(p, n)
    done_j, done_t = {}, {}
    while len(je.scheduler) or je.active_lanes:
        done_j.update((r.uid, r) for r in je.step())
        done_t.update((r.uid, r) for r in te.step())
        np.testing.assert_array_equal(te.block_tables, je.block_tables)
        assert te.active_lanes == je.active_lanes
        assert te.pool.free_pages == je.pool.free_pages
        assert te.pool.peak_in_use == je.pool.peak_in_use
    assert not (len(te.scheduler) or te.active_lanes)
    assert sorted(done_t) == sorted(done_j)
    for u in done_j:
        assert done_t[u].truncated == done_j[u].truncated
        assert done_t[u].generated.size == done_j[u].generated.size


@pytest.mark.parametrize("name", ["tiny", "smoke"])
def test_packed_equals_pruned_dense_in_port(name):
    jcfg = CFGS[name]()
    tcfg = port_cfg(jcfg)
    _, tpk = serving_params(jcfg, packed=True)
    _, tdn = serving_params(jcfg, packed=False)
    prompts = _prompts(jcfg.vocab_size, seed=3)
    got, _ = tengine.generate(tcfg, tpk, prompts, max_new_tokens=7,
                              slab_k=4, device="cpu", **KW)
    want, _ = tengine.generate(tcfg, tdn, prompts, max_new_tokens=7,
                               slab_k=4, device="cpu", **KW)
    for p, g, w in zip(prompts, got, want):
        _assert_same_or_near_tie(g, w, p.size,
                                 lambda s: _port_margin(tcfg, tdn, s))


def test_submit_gates_and_eos():
    jcfg = CFGS["tiny"]()
    _, tp = serving_params(jcfg, packed=True)
    eng = tengine.Engine(port_cfg(jcfg), tp, max_batch=2, max_len=60,
                         prefill_chunk=8, slab_k=4, page_size=4, n_pages=8,
                         device="cpu")
    with pytest.raises(ValueError, match=r"10 pages .* only 8 pages"):
        eng.submit(np.ones(20, np.int32), 20)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(np.ones(60, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.ones(5, np.int32), 0)
    # eos: a request stops at the first eos it emits
    p = _prompts(jcfg.vocab_size, n=1, seed=11)[0]
    full, _ = tengine.generate(port_cfg(jcfg), tp, [p], max_new_tokens=8,
                               device="cpu", page_size=4)
    eos = int(full[0][p.size + 2])
    cut, _ = tengine.generate(port_cfg(jcfg), tp, [p], max_new_tokens=8,
                              eos_id=eos, device="cpu", page_size=4)
    gen = full[0][p.size:]
    stop = int(np.argmax(gen == eos)) + 1
    np.testing.assert_array_equal(cut[0][p.size:], gen[:stop])
