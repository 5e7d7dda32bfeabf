"""The port's transformer on the two MoE ``--arch`` smoke configs against
the reference, with the packed serving weights of the launcher's
one-shot prune at s = 0.8 (and the pruned-dense export for the training
forward): ``forward`` logits and aux loss, ``prefill_chunk`` then
``decode_step`` over the contiguous cache, ``paged_prefill_chunk`` then
``paged_decode_step`` over the paged pool, and the mixed batch's
``paged_prefill_chunk(q_lens=)``. f32 caches on both sides, logits and
caches within 1e-5 of their magnitude. Every call routes all of its
tokens, idle and parked lanes included, so the per-expert capacity and
its drops are the same on both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_serving_steps import _close, _tokens  # noqa: E402
from test_torch_transformer import port_cfg, serving_params  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

MOE = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module", params=MOE)
def model(request):
    jcfg = jconfigs.get_config(request.param, smoke=True)
    jp, tp = serving_params(jcfg, packed=True)
    return jcfg, port_cfg(jcfg), jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_forward_logits_and_aux(model, packed):
    jcfg, tcfg, jp, tp = model
    if not packed:
        jp, tp = serving_params(jcfg, packed=False)
    toks = _tokens(jcfg.vocab_size, (3, 10), 0)
    jl, ja = jreg.forward(jcfg, jp, jnp.asarray(toks))
    tl, ta = treg.forward(tcfg, tp, _t(toks))
    _close(tl.numpy(), jl)
    assert float(ta) > 0
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("pos_kind", ["scalar", "lanes"])
def test_prefill_chunk_then_decode_step(model, pos_kind):
    """Two right-aligned chunks into the contiguous cache (one lane
    masked out of the second), then one decode step at a shared slot or
    at per-lane slots with a parked lane."""
    jcfg, tcfg, jp, tp = model
    b, smax, c = 3, 16, 4
    toks = _tokens(jcfg.vocab_size, (b, 2 * c), 1)
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
            tcfg, tp, tc, _t(toks[:, i * c:(i + 1) * c]), i * c,
            _t(offsets), lane_mask=None if m is None else _t(m))
        _close(tl.numpy(), jl)
        for k in ("k", "v"):
            _close(tc[k].numpy(), jc[k])
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    if pos_kind == "scalar":
        jpos, tpos, live = 2 * c, 2 * c, slice(None)
    else:
        pos = np.asarray([2 * c, 2 * c + 3, smax], np.int32)   # parked
        jpos, tpos, live = jnp.asarray(pos), _t(pos), slice(2)
    jl2, jc = jtr.decode_step(jcfg, jp, jc, jnp.asarray(nxt), jpos,
                              offsets=jnp.asarray(offsets))
    tl2, tc = ttr.decode_step(tcfg, tp, tc, _t(nxt), tpos,
                              offsets=_t(offsets))
    _close(tl2.numpy()[live], np.asarray(jl2)[live])
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k])


def test_paged_prefill_then_decode_and_mixed_chunk(model):
    """A paged prefill chunk, one paged decode step with a parked lane,
    then the mixed batch's shape (a decode lane, a prefill lane at its
    own start, an idle lane) through ``paged_prefill_chunk(q_lens=)``."""
    jcfg, tcfg, jp, tp = model
    b, c, ps, n_pages = 3, 6, 4, 12
    toks = _tokens(jcfg.vocab_size, (b, c), 2)
    offsets = np.asarray([0, 2, 5], np.int32)
    bt = np.asarray([[0, 1, 2, 11], [3, 4, 5, 11], [6, 7, 8, 11]], np.int32)
    jc = jtr.init_paged_cache(jcfg, n_pages, ps, dtype=jnp.float32)
    tc = ttr.init_paged_cache(tcfg, n_pages, ps, dtype=torch.float32,
                              device="cpu")
    jl, jc = jtr.paged_prefill_chunk(
        jcfg, jp, jc, jnp.asarray(toks), 0, jnp.asarray(offsets),
        jnp.asarray(bt), read_pages=2)
    tl, tc = ttr.paged_prefill_chunk(
        tcfg, tp, tc, _t(toks), 0, _t(offsets), _t(bt), read_pages=2)
    _close(tl.numpy(), jl)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = np.asarray([c, c, 4 * ps], np.int32)              # lane 2 parked
    jl2, jc = jtr.paged_decode_step(
        jcfg, jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jnp.asarray(bt),
        read_pages=2, offsets=jnp.asarray(offsets))
    tl2, tc = ttr.paged_decode_step(
        tcfg, tp, tc, _t(nxt), _t(pos), _t(bt), read_pages=2,
        offsets=_t(offsets))
    _close(tl2.numpy()[:2], np.asarray(jl2)[:2])
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k])
    starts = np.asarray([c + 1, 3, 0], np.int32)
    q_lens = np.asarray([1, 4, 0], np.int32)
    chunk = _tokens(jcfg.vocab_size, (b, 4), 3)
    zero = np.zeros(b, np.int32)
    jl3, jc = jtr.paged_prefill_chunk(
        jcfg, jp, jc, jnp.asarray(chunk), jnp.asarray(starts),
        jnp.asarray(zero), jnp.asarray(bt), read_pages=3,
        q_lens=jnp.asarray(q_lens))
    tl3, tc = ttr.paged_prefill_chunk(
        tcfg, tp, tc, _t(chunk), _t(starts), _t(zero), _t(bt), read_pages=3,
        q_lens=_t(q_lens))
    for i in range(2):
        _close(tl3.numpy()[i, :q_lens[i]], np.asarray(jl3)[i, :q_lens[i]])
    for k in ("k", "v"):
        _close(tc[k].numpy(), jc[k])
