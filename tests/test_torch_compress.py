"""``optim/compress.py`` against the reference's on the same inputs:
int8 quantization with error feedback and the traffic report bitwise,
and the one-rank reduction (the reference's ``compressed_psum`` on a
one-device mesh) bitwise. Bitwise against the reference as its train
step runs it, jitted, where XLA fuses the residual's multiply-subtract;
run eagerly it rounds the product first, and the residual moves by at
most that rounding (one f32 step of ``g + err``). With several ranks
the port quantizes at the ranks' shared scale where the reference uses
each rank's own; the two-rank case is in ``test_torch_dist_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jc  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402


def _inputs(case):
    rng = np.random.default_rng(case)
    shape = [(1000,), (64, 48), (3, 16, 16)][case % 3]
    g = rng.standard_normal(shape).astype(np.float32) * 10.0 ** (case - 3)
    e = (rng.standard_normal(shape) * 1e-3 * 10.0 ** (case - 3)
         ).astype(np.float32)
    if case == 5:
        g[:] = 0.0
        e[:] = 0.0                 # the 1e-12 floor of the scale
    return g, e


def _t(a):
    return interop.tensor(a, device="cpu")


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("case", range(6))
def test_quantize_int8_bitwise(case, jit):
    g, e = _inputs(case)
    fn = jax.jit(jc.quantize_int8) if jit else jc.quantize_int8
    jq, js, je = fn(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = tc.quantize_int8(_t(g), _t(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if jit:
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    else:
        # the eager product's own rounding: half a step of q * scale
        step = np.spacing(np.abs((g + e).astype(np.float32)))
        assert (np.abs(te.numpy() - np.asarray(je)) <= step).all()
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(
        tc.dequantize(tq, ts).numpy(),
        np.asarray(jc.dequantize(jq, js)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((32, 16)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32) * 1e-3,
                  "d": rng.standard_normal((4, 8, 8)).astype(np.float32)}}


@pytest.mark.parametrize("steps", [1, 3])
def test_one_rank_reduction_bitwise(steps):
    """The port's reduction with one rank (no group) against the
    reference's jitted ``compressed_psum`` on a one-device mesh, the
    error feedback carried over ``steps`` steps."""
    mesh = jax.make_mesh((1,), ("data",))
    psum = jax.jit(lambda g, e: jc.compressed_psum(g, e, mesh, ("data",)))
    je = jc.init_error_feedback(jax.tree_util.tree_map(jnp.asarray,
                                                       _tree(0)))
    te = tc.init_error_feedback(interop.to_torch(_tree(0), device="cpu"))
    for s in range(steps):
        g = _tree(s + 1)
        jr, je = psum(jax.tree_util.tree_map(jnp.asarray, g), je)
        tr, te = tc.compressed_psum(interop.to_torch(g, device="cpu"), te,
                                    None)
        for a, b in zip(jax.tree_util.tree_leaves(jr),
                        _flat(interop.to_numpy(tr))):
            np.testing.assert_array_equal(b, np.asarray(a))
        for a, b in zip(jax.tree_util.tree_leaves(je),
                        _flat(interop.to_numpy(te))):
            np.testing.assert_array_equal(b, np.asarray(a))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_error_feedback_unbiased_over_steps():
    """A constant gradient below one quantization step of its leaf still
    arrives: the residual carries it until it rounds up, so the mean of
    the reduced values tends to the gradient."""
    g = torch.tensor([1.0, 0.003, -0.002])
    e = torch.zeros(3)
    total = torch.zeros(3)
    n = 400
    for _ in range(n):
        r, e = tc.reduce_leaf_int8(g, e, None)
        total += r
    np.testing.assert_allclose((total / n).numpy(), g.numpy(),
                               atol=1.0 / 127 / n * 2)


@pytest.mark.parametrize("with_masks", [False, True])
def test_traffic_report_matches_reference(with_masks):
    """The reference's keys and numbers, bitwise; the port adds the
    bytes of its per-leaf scales."""
    rng = np.random.default_rng(3)
    grads = {"layers": {"mlp": {
        "w_gate": rng.standard_normal((2, 64, 128)).astype(np.float32),
        "w_down": rng.standard_normal((2, 128, 64)).astype(np.float32)}},
        "embed": rng.standard_normal((100, 64)).astype(np.float32)}
    masks = None
    if with_masks:
        masks = {"layers/mlp/w_gate": rng.random((2, 4, 8)) < 0.3,
                 "layers/mlp/w_down": rng.random((2, 8, 4)) < 0.3}
    want = jc.traffic_report(
        jax.tree_util.tree_map(jnp.asarray, grads),
        None if masks is None else {k: jnp.asarray(v)
                                    for k, v in masks.items()})
    got = tc.traffic_report(
        interop.to_torch(grads, device="cpu"),
        None if masks is None else interop.to_torch(masks, device="cpu"))
    assert got.pop("scale_bytes") == 4 * 3
    assert got == want
