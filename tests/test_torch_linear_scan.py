"""The port's chunked linear scan (``repro_torch/models/linear_scan.py``)
against the reference's on the same numpy-seeded inputs, f32 outputs and
states within 1e-5 of their magnitude: the RWKV "bonus" and SSD "full"
modes with and without the ``u`` bonus, chunks shorter than, equal to
and longer than the sequence, with and without an initial state, and
decays below the floor (the floor binds); the grouped SSD; both O(1)
decode steps; ``decay_floor``; and the port's chunked path against its
own token-by-token recurrence."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.models import linear_scan as jls  # noqa: E402
from repro_torch.models import linear_scan as tls  # noqa: E402

B, S, H, DK, DV = 2, 16, 3, 8, 5
DS = 6


def _close(got, want, frac=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = frac * max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol, f"max abs err {err} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, floor_binds):
    """q, k, v, log_w, u and a state, f32. ``floor_binds``: per-step
    log-decays far below any floor of these chunks (-RANGE/4 = -17.5)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, S, H, DK), f(B, S, H, DK), f(B, S, H, DV)
    log_w = -np.exp(f(B, S, H, DK) * 0.7 - 1.0).astype(np.float32)
    if floor_binds:
        log_w = log_w - 40.0 * (rng.random((B, S, H, DK)) < 0.5)
    return (q, k, v, log_w.astype(np.float32), f(H, DK) * 0.5,
            f(B, H, DK, DV))


@pytest.mark.parametrize("floor_binds", [False, True],
                         ids=["decay", "floor"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("chunk", [4, 16, 32], ids=["c<S", "c=S", "c>S"])
@pytest.mark.parametrize("mode,with_u", [("bonus", True), ("bonus", False),
                                         ("full", False), ("full", True)])
def test_chunked_linear_attention(mode, with_u, chunk, init, floor_binds):
    q, k, v, log_w, u, s0 = _inputs(chunk + 7 * init, floor_binds)
    kw = dict(chunk=chunk, include_diag=mode)
    jy, js = jls.chunked_linear_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(log_w),
        u=jnp.asarray(u) if with_u else None,
        initial_state=jnp.asarray(s0) if init else None, **kw)
    ty, ts = tls.chunked_linear_attention(
        _t(q), _t(k), _t(v), _t(log_w), u=_t(u) if with_u else None,
        initial_state=_t(s0) if init else None, **kw)
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


def test_chunked_linear_attention_casts_back_to_the_input_dtype():
    q, k, v, log_w, u, _ = _inputs(3, False)
    bf = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    y, st = tls.chunked_linear_attention(bf(q), bf(k), bf(v), _t(log_w),
                                         u=_t(u), chunk=8,
                                         include_diag="bonus")
    jy, js = jls.chunked_linear_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(log_w), u=jnp.asarray(u), chunk=8, include_diag="bonus")
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    _close(st.numpy(), js)
    _close(y.float().numpy(), np.asarray(jy, np.float32), 2 ** -7)


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("chunk", [4, 16, 32], ids=["c<S", "c=S", "c>S"])
def test_chunked_ssd(chunk, init, strong):
    rng = np.random.default_rng(chunk + 3 * init + strong)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(B, S, DS), f(B, S, DS), f(B, S, H, DV)
    log_a = (-np.exp(f(B, S, H) - (-4.0 if strong else 1.0))
             ).astype(np.float32)
    s0 = f(B, H, DS, DV)
    jy, js = jls.chunked_ssd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(log_a),
        chunk=chunk, initial_state=jnp.asarray(s0) if init else None)
    ty, ts = tls.chunked_ssd(_t(q), _t(k), _t(v), _t(log_a), chunk=chunk,
                             initial_state=_t(s0) if init else None)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("floor_binds", [False, True],
                         ids=["decay", "floor"])
@pytest.mark.parametrize("mode", ["bonus", "full"])
def test_recurrent_step(mode, floor_binds):
    q, k, v, log_w, u, s0 = _inputs(11, floor_binds)
    a = [x[:, 0] for x in (q, k, v, log_w)]
    jy, js = jls.recurrent_step(*(jnp.asarray(x) for x in a),
                                jnp.asarray(s0), u=jnp.asarray(u), chunk=4,
                                include_diag=mode)
    ty, ts = tls.recurrent_step(*(_t(x) for x in a), _t(s0), u=_t(u),
                                chunk=4, include_diag=mode)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


def test_ssd_recurrent_step():
    rng = np.random.default_rng(12)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, s0 = f(B, DS), f(B, DS), f(B, H, DV), f(B, H, DS, DV)
    log_a = -np.exp(f(B, H)).astype(np.float32)
    jy, js = jls.ssd_recurrent_step(*(jnp.asarray(x)
                                      for x in (q, k, v, log_a, s0)))
    ty, ts = tls.ssd_recurrent_step(*(_t(x) for x in (q, k, v, log_a, s0)))
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)


@pytest.mark.parametrize("chunk", [0, 1, 4, 16, 64, 1 << 30])
def test_decay_floor(chunk):
    assert tls.RANGE == jls.RANGE
    assert tls.decay_floor(chunk) == jls.decay_floor(chunk)


def test_chunk_must_divide_the_sequence():
    q, k, v, log_w, _, _ = _inputs(0, False)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tls.chunked_linear_attention(_t(q), _t(k), _t(v), _t(log_w),
                                     chunk=5)


@pytest.mark.parametrize("mode", ["bonus", "full"])
def test_chunked_equals_its_own_recurrence(mode):
    """The chunked path (chunk 4 < S, so both floor at the chunk's) and
    S recurrent steps give the same outputs and final state."""
    q, k, v, log_w, u, s0 = _inputs(5, True)
    uu = _t(u) if mode == "bonus" else None
    y, st = tls.chunked_linear_attention(
        _t(q), _t(k), _t(v), _t(log_w), u=uu, chunk=4,
        initial_state=_t(s0), include_diag=mode)
    state, ys = _t(s0), []
    for t in range(S):
        yt, state = tls.recurrent_step(
            _t(q[:, t]), _t(k[:, t]), _t(v[:, t]), _t(log_w[:, t]), state,
            u=uu, chunk=4, include_diag=mode)
        ys.append(yt)
    _close(torch.stack(ys, 1).numpy(), y.numpy())
    _close(state.numpy(), st.numpy())
