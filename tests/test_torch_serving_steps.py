"""The port's contiguous-cache transformer steps, serving steps and the
``serve_loop`` oracle against the reference, on ``tiny_cfg`` and
``LLAMA32_1B_SMOKE`` with packed serving weights: ``decode_step``,
``prefill_chunk`` and ``paged_prefill_chunk(q_lens=)`` logits and caches
in f32 within 1e-5 of their magnitude on ``tiny_cfg`` and 1e-4 on
``LLAMA32_1B_SMOKE`` (the bar of ``test_torch_transformer.py``: its K/V
grow to about 6 by the fourth layer, where f32 summation order alone
reaches about 1.4e-5); the mixed step's next tokens, the
contiguous decode slab's tokens and state, and ``serve_loop.generate``'s
greedy tokens equal (a divergence only at a reference top-2 margin below
1e-5); the copy-on-write page copy bitwise; temperature sampling
repeatable from one ``torch.Generator`` seed (no parity asked: the two
sides draw from different generators)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _ref_margin  # noqa: E402
from test_torch_transformer import CFGS, port_cfg, serving_params  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serving import serve_loop as jsl, step as jstep  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serving import serve_loop as tsl, step as tstep  # noqa: E402

NAMES = ["tiny", "smoke"]


FRAC = {"tiny": 1e-5, "smoke": 1e-4}


def _close(got, want, frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = frac * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs err {err} > {tol}"


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    jcfg = CFGS[request.param]()
    jp, tp = serving_params(jcfg, packed=True)
    return request.param, jcfg, port_cfg(jcfg), jp, tp


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("pos_kind", ["scalar", "lanes"])
def test_prefill_chunk_then_decode_step_logits(model, pos_kind):
    """Two right-aligned chunks into an f32 contiguous cache (one lane
    masked out of the second), then one decode step at a shared slot or
    per-lane slots with a parked lane."""
    name, jcfg, tcfg, jp, tp = model
    frac = FRAC[name]
    b, smax, c = 3, 16, 4
    toks = _tokens(jcfg.vocab_size, (b, 2 * c), 0)
    offsets = np.asarray([0, 2, 5], np.int32)
    mask = np.asarray([True, False, True])
    jc = jtr.init_cache(jcfg, b, smax, dtype=jnp.float32)
    tc = ttr.init_cache(tcfg, b, smax, dtype=torch.float32, device="cpu")
    for i, m in ((0, None), (1, mask)):
        jl, jc = jtr.prefill_chunk(
            jcfg, jp, jc, jnp.asarray(toks[:, i * c:(i + 1) * c]), i * c,
            jnp.asarray(offsets),
            lane_mask=None if m is None else jnp.asarray(m))
        tl, tc = ttr.prefill_chunk(
            tcfg, tp, tc, torch.from_numpy(toks[:, i * c:(i + 1) * c]),
            i * c, torch.from_numpy(offsets),
            lane_mask=None if m is None else torch.from_numpy(m))
        _close(tl.numpy(), jl, frac)
        for k in ("k", "v"):
            _close(tc[k].numpy(), jc[k], frac)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    if pos_kind == "scalar":
        jpos, tpos, live = 2 * c, 2 * c, slice(None)
    else:
        pos = np.asarray([2 * c, 2 * c + 3, smax], np.int32)   # parked
        jpos, tpos, live = jnp.asarray(pos), torch.from_numpy(pos), slice(2)
    jl2, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(nxt), jpos,
                              offsets=jnp.asarray(offsets))
    tl2, tc = ttr.decode_step(tcfg, tp, tc, torch.from_numpy(nxt), tpos,
                              offsets=torch.from_numpy(offsets))
    _close(tl2.numpy()[live], np.asarray(jl2)[live], frac)
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k], frac)


@pytest.mark.parametrize("case", ["mixed", "scalar_slot"])
def test_paged_prefill_chunk_q_lens_logits(model, case):
    """The mixed batch's shape through every layer: a decode lane, two
    prefill lanes at their own starts, an idle lane."""
    name, jcfg, tcfg, jp, tp = model
    frac = FRAC[name]
    b, c, ps, n_pages = 4, 4, 4, 16
    toks = _tokens(jcfg.vocab_size, (b, 3 * c), 1)
    bt = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11],
                     [12, 13, 14, 15]], np.int32)
    offsets = np.zeros(b, np.int32)
    jc = jtr.init_paged_cache(jcfg, n_pages, ps, dtype=jnp.float32)
    tc = ttr.init_paged_cache(tcfg, n_pages, ps, dtype=torch.float32,
                              device="cpu")
    # seed every lane's first 8 slots
    jl, jc = jtr.paged_prefill_chunk(
        jcfg, jp, jc, jnp.asarray(toks[:, :8]), 0, jnp.asarray(offsets),
        jnp.asarray(bt), read_pages=2)
    tl, tc = ttr.paged_prefill_chunk(
        tcfg, tp, tc, torch.from_numpy(toks[:, :8]), 0,
        torch.from_numpy(offsets), torch.from_numpy(bt), read_pages=2)
    _close(tl.numpy(), jl, frac)
    if case == "mixed":
        starts = np.asarray([8, 8, 5, 0], np.int32)
        q_lens = np.asarray([1, 4, 3, 0], np.int32)
        jslot, tslot = jnp.asarray(starts), torch.from_numpy(starts)
    else:
        starts = np.full(b, 8, np.int32)
        q_lens = np.asarray([4, 1, 2, 3], np.int32)
        jslot = tslot = 8
    chunk = np.stack([toks[i, s:s + c] if s + c <= toks.shape[1]
                      else toks[i, :c] for i, s in enumerate(starts)])
    jl, jc = jtr.paged_prefill_chunk(
        jcfg, jp, jc, jnp.asarray(chunk), jslot, jnp.asarray(offsets),
        jnp.asarray(bt), read_pages=4, q_lens=jnp.asarray(q_lens))
    tl, tc = ttr.paged_prefill_chunk(
        tcfg, tp, tc, torch.from_numpy(chunk), tslot,
        torch.from_numpy(offsets), torch.from_numpy(bt), read_pages=4,
        q_lens=torch.from_numpy(q_lens))
    for i in range(b):
        _close(tl.numpy()[i, :q_lens[i]], np.asarray(jl)[i, :q_lens[i]],
               frac)
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k], frac)


def test_mixed_step_next_tokens(model):
    """``make_mixed_step``: equal next tokens for every lane that emits,
    and the same finite verdicts."""
    _, jcfg, tcfg, jp, tp = model
    b, ps, n_pages = 4, 4, 16
    toks = _tokens(jcfg.vocab_size, (b, 8), 2)
    bt = np.arange(n_pages, dtype=np.int32).reshape(b, 4)
    offsets = np.zeros(b, np.int32)
    starts = np.asarray([0, 0, 0, 0], np.int32)
    q_lens = np.asarray([8, 5, 1, 0], np.int32)
    jfn = jstep.make_mixed_step(jcfg)
    tfn = tstep.make_mixed_step(tcfg)
    jn, jf, jc = jfn(jp, jtr.init_paged_cache(jcfg, n_pages, ps),
                     jnp.asarray(toks), jnp.asarray(starts),
                     jnp.asarray(q_lens), jnp.asarray(offsets),
                     jnp.asarray(bt), read_pages=2,
                     poison=jnp.zeros(b, jnp.float32))
    tn, tf, tc = tfn(tp, ttr.init_paged_cache(tcfg, n_pages, ps,
                                              device="cpu"),
                     torch.from_numpy(toks), torch.from_numpy(starts),
                     torch.from_numpy(q_lens), torch.from_numpy(offsets),
                     torch.from_numpy(bt), read_pages=2,
                     poison=torch.zeros(b, dtype=torch.float32))
    assert tn.dtype == torch.int32 and tn.shape == (b,)
    np.testing.assert_array_equal(tf.numpy()[:3], np.asarray(jf)[:3])
    for i in range(3):
        seq = toks[i, :q_lens[i]]
        if int(tn[i]) != int(jn[i]):
            assert _ref_margin(jcfg, jp, seq) < 1e-5


def test_copy_pages_step_is_bitwise():
    rng = np.random.default_rng(3)
    shape = (3, 10, 4, 2, 8)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    src = np.asarray([7, 2, 2], np.int32)
    dst = np.asarray([1, 9, 4], np.int32)
    want = jstep.make_copy_pages_step()(
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.asarray(src),
        jnp.asarray(dst))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = tstep.make_copy_pages_step()({"k": tk, "v": tv},
                                       torch.from_numpy(src),
                                       torch.from_numpy(dst))
    assert got["k"] is tk and got["v"] is tv
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_decode_slab_step_tokens_and_state(model):
    """The contiguous decode slab: tokens, frontiers, budgets and live
    flags equal, with a lane that stops on its budget and a dead lane."""
    _, jcfg, tcfg, jp, tp = model
    b, smax, k = 3, 16, 4
    toks = _tokens(jcfg.vocab_size, (b, 4), 4)
    offsets = np.zeros(b, np.int32)
    jc = jtr.init_cache(jcfg, b, smax)
    tc = ttr.init_cache(tcfg, b, smax, device="cpu")
    jl, jc = jtr.prefill_chunk(jcfg, jp, jc, jnp.asarray(toks), 0,
                               jnp.asarray(offsets))
    tl, tc = ttr.prefill_chunk(tcfg, tp, tc, torch.from_numpy(toks), 0,
                               torch.from_numpy(offsets))
    first = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    state = {"pending": first, "frontier": np.full(b, 4, np.int32),
             "offsets": offsets,
             "remaining": np.asarray([10, 2, 10], np.int32),
             "live": np.asarray([True, True, False]),
             "faulted": np.zeros(b, bool)}
    jstate = dict({k_: jnp.asarray(v) for k_, v in state.items()},
                  poison=jnp.zeros(b, jnp.float32))
    jt, jst, _ = jstep.make_decode_slab_step(jcfg, k, smax)(jp, jc, jstate)
    tt, tst, _ = tstep.make_decode_slab_step(tcfg, k, smax)(
        tp, tc, dict({k_: torch.from_numpy(v) for k_, v in state.items()},
                     poison=torch.zeros(b, dtype=torch.float32)))
    for key in ("frontier", "remaining", "live", "faulted"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))
    kept = np.asarray(jst["frontier"]) - 4
    for i in range(b):
        np.testing.assert_array_equal(tt.numpy()[i, :kept[i]],
                                      np.asarray(jt)[i, :kept[i]])


def test_prefill_step_matches(model):
    name, jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg.vocab_size, (2, 6), 5)
    want = jstep.make_prefill_step(jcfg)(jp, jnp.asarray(toks))
    got = tstep.make_prefill_step(tcfg)(tp, torch.from_numpy(toks))
    _close(got.detach().numpy(), want, FRAC[name])


@pytest.mark.parametrize("plen,new", [(5, 6), (9, 4)])
def test_serve_loop_generate_matches_reference(model, plen, new):
    name, jcfg, tcfg, jp, tp = model
    prompts = _tokens(jcfg.vocab_size, (3, plen), 6 + plen)
    want, _ = jsl.generate(jcfg, jp, jnp.asarray(prompts),
                           max_new_tokens=new)
    got, st = tsl.generate(tcfg, tp, prompts, max_new_tokens=new,
                           device="cpu")
    assert got.shape == (3, plen + new) and got.dtype == np.int32
    assert st["decode_s"] >= 0 and "tok_per_s" in st
    for g, w in zip(got, np.asarray(want)):
        _assert_same_or_near_tie(g, w, plen,
                                 lambda s: _ref_margin(jcfg, jp, s))


def test_serve_loop_prefill_logits_match(model):
    name, jcfg, tcfg, jp, tp = model
    prompts = _tokens(jcfg.vocab_size, (2, 5), 7)
    jl, _ = jsl.prefill_with_decode(jcfg, jp, jnp.asarray(prompts), 8)
    tl, cache = tsl.prefill_with_decode(tcfg, tp, prompts, 8, device="cpu")
    assert cache["k"].shape[1:3] == (2, 8)
    _close(tl.numpy(), jl, FRAC[name])


def test_decode_step_temperature_is_repeatable():
    """Sampling draws from the caller's ``torch.Generator``: the same
    seed gives the same tokens, and temperature 0 is the argmax."""
    jcfg = CFGS["tiny"]()
    tcfg = port_cfg(jcfg)
    _, tp = serving_params(jcfg, packed=True)
    prompts = _tokens(jcfg.vocab_size, (4, 5), 8)
    runs = [tsl.generate(tcfg, tp, prompts, max_new_tokens=12,
                         temperature=1.5,
                         generator=torch.Generator().manual_seed(s),
                         device="cpu")[0] for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < jcfg.vocab_size)).all()
    cache = ttr.init_cache(tcfg, 4, 8, device="cpu")
    nxt, _, last, gen = tstep.make_decode_step(tcfg)(
        tp, cache, torch.from_numpy(prompts[:, :1]), 0, None)
    assert gen is None and nxt.shape == (4, 1) and nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt[:, 0].numpy(),
                                  last.argmax(-1).numpy())


def test_serve_loop_refuses_what_is_not_ported():
    """``frames`` are whisper's (``audio``): accepted there, and required,
    where the reference only asserts; a text family ignores them, as the
    reference does."""
    jcfg = CFGS["tiny"]()
    tcfg = port_cfg(jcfg)
    _, tp = serving_params(jcfg, packed=True)
    prompts = np.ones((1, 3), np.int32)
    want, _ = tsl.generate(tcfg, tp, prompts, max_new_tokens=2,
                           device="cpu")
    got, _ = tsl.generate(tcfg, tp, prompts, max_new_tokens=2,
                          frames=np.ones(1), device="cpu")
    np.testing.assert_array_equal(got, want)
    wcfg = port_cfg(jconfigs.get_config("whisper-large-v3", smoke=True))
    wp = treg.init_params(wcfg, 0, "cpu")
    with pytest.raises(ValueError, match="frames"):
        tsl.generate(wcfg, wp, prompts, max_new_tokens=2, device="cpu")
    frames = np.full((1, 5, wcfg.d_model), 0.02, np.float32)
    toks, _ = tsl.generate(wcfg, wp, prompts, max_new_tokens=2,
                           frames=frames, device="cpu")
    assert toks.shape == (1, 5)
    cache = treg.init_cache(wcfg, 1, 4, device="cpu")
    assert set(cache) == {"k", "v"}
    assert tuple(cache["k"].shape[:3]) == (wcfg.num_layers, 1, 4)
    assert treg.supports_prefill_chunk(tcfg) and treg.supports_mixed(tcfg)
    assert not treg.supports_prefill_chunk(wcfg)