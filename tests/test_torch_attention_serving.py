"""The port's serving attention beyond paged decode, against the
reference: ``decode_attention`` over the contiguous cache with a scalar
or per-lane ``pos`` (parked lanes, ``offsets``), ``chunk_attention``
with ``lane_mask``, and ``paged_chunk_attention`` with per-lane start
slots and ``q_lens`` (the mixed step's shape).

Outputs in f32 within 1e-5 of their magnitude (``_close``: the output
projection sums heads of magnitude ~4 into entries that may cancel
towards 0, where f32 summation order alone leaves ~1e-5). The caches
after the writes: every entry the reference does not write (a parked or
masked lane, a pad token, the rest of the cache) is bitwise the input,
and the written entries are within 1e-5; with rope off and integer-valued weights and inputs the written
values are exact on both sides, so there the whole cache must be
bitwise-equal (``test_cache_writes_bitwise``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.models import attention as jattn, registry as jreg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

B, SMAX, KV, HD = 3, 12, 2, 16


def _attn_params(cfg, seed=0, integer=False):
    p = jreg.init_params(cfg, jax.random.PRNGKey(seed))["layers"]["attn"]
    p = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), p)
    if integer:
        rng = np.random.default_rng(seed)
        p = {k: rng.integers(-2, 3, size=v.shape).astype(np.float32)
             for k, v in p.items()}
    return (jax.tree_util.tree_map(jnp.asarray, p),
            interop.to_torch(p, device="cpu"))


def _x(seed, c, d, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-2, 3, size=(B, c, d)).astype(np.float32)
    return rng.normal(size=(B, c, d)).astype(np.float32)


def _cache(seed, shape=(B, SMAX, KV, HD)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs err {err} > {tol}"


def _check_cache(got, want, before, written):
    """``written`` (bool, the cache's leading dims): entries outside it
    are bitwise ``before`` on both sides; inside, ``_close``."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(want[~written], before[~written])
    np.testing.assert_array_equal(got[~written], before[~written])
    _close(got[written], want[written])


def _decode(cfg, jp, tp, x, ck, cv, pos, offsets, window=0):
    jpos = pos if np.ndim(pos) == 0 else jnp.asarray(pos)
    tpos = pos if np.ndim(pos) == 0 else torch.from_numpy(pos)
    joff = None if offsets is None else jnp.asarray(offsets)
    toff = None if offsets is None else torch.from_numpy(offsets)
    want = jattn.decode_attention(cfg, jp, jnp.asarray(x), jnp.asarray(ck),
                                  jnp.asarray(cv), jpos, window=window,
                                  offsets=joff)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tattn.decode_attention(cfg, tp, torch.from_numpy(x), tk, tv, tpos,
                                 window=window, offsets=toff)
    assert got[1] is tk and got[2] is tv                 # in place
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("offsets", [None, [1, 0, 3]], ids=["sync", "ragged"])
@pytest.mark.parametrize("pos", [5, 11, [6, 11, 12], [4, 12, 30]],
                         ids=["scalar", "scalar_last", "lanes_parked",
                              "lanes_two_parked"])
def test_decode_attention_matches(pos, offsets, window):
    cfg = tiny_cfg(sliding_window=window)
    jp, tp = _attn_params(cfg)
    x = _x(1, 1, cfg.d_model)
    ck, cv = _cache(2), _cache(3)
    pos = np.asarray(pos, np.int32) if isinstance(pos, list) else pos
    off = None if offsets is None else np.asarray(offsets, np.int32)
    want, got = _decode(cfg, jp, tp, x, ck, cv, pos, off, window)
    _close(got[0], want[0])
    written = np.zeros((B, SMAX), bool)
    for b in range(B):
        s = pos if np.ndim(pos) == 0 else pos[b]
        if s < SMAX:
            written[b, s] = True
    _check_cache(got[1], want[1], ck, written)
    _check_cache(got[2], want[2], cv, written)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("mask", [None, [True, False, True],
                                  [False, False, False]],
                         ids=["all", "lane_mask", "none_kept"])
@pytest.mark.parametrize("slot", [0, 4, 8])
def test_chunk_attention_matches(slot, mask, window):
    """Lanes outside ``lane_mask`` keep their cache rows bitwise."""
    cfg = tiny_cfg(sliding_window=window)
    jp, tp = _attn_params(cfg, seed=1)
    c = 4
    x = _x(4, c, cfg.d_model)
    ck, cv = _cache(5), _cache(6)
    offsets = np.asarray([2, 0, 5], np.int32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    want = jattn.chunk_attention(cfg, jp, jnp.asarray(x), jnp.asarray(ck),
                                 jnp.asarray(cv), slot, jnp.asarray(offsets),
                                 window=window, lane_mask=jm)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tattn.chunk_attention(cfg, tp, torch.from_numpy(x), tk, tv, slot,
                                torch.from_numpy(offsets), window=window,
                                lane_mask=tm)
    assert got[1] is tk and got[2] is tv
    _close(got[0].numpy(), want[0])
    written = np.zeros((B, SMAX), bool)
    keep = np.ones(B, bool) if mask is None else np.asarray(mask)
    written[keep, slot:slot + c] = True
    _check_cache(tk.numpy(), want[1], ck, written)
    _check_cache(tv.numpy(), want[2], cv, written)


def _paged_chunk(cfg, jp, tp, x, pk, pv, bt, slot, offsets, lane_mask,
                 q_lens, read_pages, window=0):
    arg = lambda a, f: None if a is None else f(np.asarray(a))  # noqa: E731
    want = jattn.paged_chunk_attention(
        cfg, jp, jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(bt), arg(slot, jnp.asarray) if np.ndim(slot) else slot,
        jnp.asarray(offsets), read_pages=read_pages, window=window,
        lane_mask=arg(lane_mask, jnp.asarray), q_lens=arg(q_lens,
                                                          jnp.asarray))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    got = tattn.paged_chunk_attention(
        cfg, tp, torch.from_numpy(x), tk, tv, torch.from_numpy(bt),
        arg(slot, torch.from_numpy) if np.ndim(slot) else slot,
        torch.from_numpy(offsets), read_pages=read_pages, window=window,
        lane_mask=arg(lane_mask, torch.from_numpy),
        q_lens=arg(q_lens, torch.from_numpy))
    assert got[1] is tk and got[2] is tv
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


def _written_pages(bt, starts, q_lens, keep, ps, n_pages):
    w = np.zeros((n_pages, ps), bool)
    for b in range(bt.shape[0]):
        if not keep[b]:
            continue
        for t in range(q_lens[b]):
            s = starts[b] + t
            if s // ps < bt.shape[1]:
                w[bt[b, s // ps], s % ps] = True
    return w


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", ["mixed", "mixed_lane_mask", "scalar_q_lens",
                                  "all_idle"])
def test_paged_chunk_attention_per_lane_slots_and_q_lens(case, window):
    """A decode lane (q_len 1 at its frontier), a prefill lane (a chunk
    from its prompt position), an idle lane (q_len 0) and a lane whose
    table ends mid-chunk; pad tokens and idle lanes write nothing."""
    cfg = tiny_cfg(sliding_window=window)
    jp, tp = _attn_params(cfg, seed=2)
    ps, n_pages, c, b = 4, 12, 4, 4
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, c, cfg.d_model)).astype(np.float32)
    pk = _cache(8, (n_pages, ps, KV, HD))
    pv = _cache(9, (n_pages, ps, KV, HD))
    bt = np.asarray([[1, 3, 0], [2, 4, 5], [6, 7, 0], [8, 9, 10]], np.int32)
    offsets = np.zeros(b, np.int32)
    starts = np.asarray([6, 4, 0, 10], np.int32)
    q_lens = np.asarray([1, 4, 0, 4], np.int32)
    lane_mask = None
    slot = starts
    if case == "mixed_lane_mask":
        lane_mask = np.asarray([True, True, False, False])
    elif case == "scalar_q_lens":
        slot, starts = 4, np.full(b, 4, np.int32)
        offsets = np.asarray([0, 1, 0, 2], np.int32)
    elif case == "all_idle":
        q_lens = np.zeros(b, np.int32)
    want, got = _paged_chunk(cfg, jp, tp, x, pk, pv, bt, slot, offsets,
                             lane_mask, q_lens, 3, window)
    for lane in range(b):
        rows = slice(0, q_lens[lane])
        _close(got[0][lane, rows], want[0][lane, rows])
    keep = np.ones(b, bool) if lane_mask is None else lane_mask
    written = _written_pages(bt, starts, q_lens, keep, ps, n_pages)
    _check_cache(got[1], want[1], pk, written)
    _check_cache(got[2], want[2], pv, written)


@pytest.mark.parametrize("what", ["decode_lanes", "decode_scalar", "chunk",
                                  "paged_mixed"])
def test_cache_writes_bitwise(what):
    """Rope off and integer-valued weights and inputs: the written K/V
    are exact on both sides, so the caches after the writes must be
    bitwise-equal (drops, clamps and masks in the same places)."""
    cfg = dataclasses.replace(tiny_cfg(), rope_theta=0.0)
    jp, tp = _attn_params(cfg, seed=3, integer=True)
    if what == "paged_mixed":
        x = np.random.default_rng(10).integers(
            -2, 3, size=(4, 4, cfg.d_model)).astype(np.float32)
        pk = _cache(11, (12, 4, KV, HD))
        pv = _cache(12, (12, 4, KV, HD))
        bt = np.asarray([[1, 3, 0], [2, 4, 5], [6, 7, 0], [8, 9, 10]],
                        np.int32)
        want, got = _paged_chunk(
            cfg, jp, tp, x, pk, pv, bt, np.asarray([6, 4, 0, 10], np.int32),
            np.zeros(4, np.int32), None, np.asarray([1, 4, 0, 4], np.int32),
            3)
    elif what == "chunk":
        x = _x(13, 4, cfg.d_model, integer=True)
        ck, cv = _cache(14), _cache(15)
        off = np.asarray([2, 0, 5], np.int32)
        mask = [True, False, True]
        want = jattn.chunk_attention(
            cfg, jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), 8,
            jnp.asarray(off), lane_mask=jnp.asarray(mask))
        got = tattn.chunk_attention(
            cfg, tp, torch.from_numpy(x), torch.from_numpy(ck.copy()),
            torch.from_numpy(cv.copy()), 8, torch.from_numpy(off),
            lane_mask=torch.tensor(mask))
        want, got = [np.asarray(a) for a in want], [a.numpy() for a in got]
    else:
        x = _x(16, 1, cfg.d_model, integer=True)
        ck, cv = _cache(17), _cache(18)
        pos = (np.asarray([3, 12, 40], np.int32) if what == "decode_lanes"
               else 11)
        want, got = _decode(cfg, jp, tp, x, ck, cv, pos,
                            np.asarray([0, 1, 2], np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
