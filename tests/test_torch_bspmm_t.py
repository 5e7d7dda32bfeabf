"""The port's transposed BSpMM and trainable packed matmul against the
reference: the host-built transposed table, ``bspmm_t_plain`` against the
Pallas kernel in interpret mode and against ``ops.bspmm_t_xla``, and the
gradients of ``make_bspmm_trainable`` against the reference's custom VJP
and against dense autograd. Same numpy inputs on both sides; packed
weights cross through ``interop``. f32 tolerances as in
``tests/test_kernels_bspmm_t.py`` (the sums run in other orders). The
CUDA kernel itself is held against ``bspmm_t_plain`` on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpacking, topk as jtopk  # noqa: E402
from repro.core.prune_grow import BlastSpec as JSpec  # noqa: E402
from repro.core.prune_grow import generate_mask as jgenerate  # noqa: E402
from repro.kernels import bspmm_t as jbt, ops as jops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.packing import PackedBCSC  # noqa: E402
from repro_torch.kernels import bspmm_t as tbt, ops as tops  # noqa: E402

TOL = dict(atol=2e-4, rtol=1e-4)

# tests/test_kernels_bspmm_t.py SHAPES: (m, k, n, b_in, b_out, sparsity)
SHAPES = [
    (16, 32, 32, 8, 8, 0.0),
    (32, 64, 96, 16, 16, 0.5),
    (64, 128, 64, 32, 16, 0.75),
    (8, 256, 128, 64, 32, 0.9),
]


def _packed(seed, k, n, bi, bo, s, selection="balanced"):
    """A reference prune-and-grow mask on seeded numpy weights; the
    reference's packed weight, the pruned dense weight and the mask."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((k, n), np.float32))
    g = jnp.asarray(rng.standard_normal((k, n), np.float32))
    spec = JSpec(b_in=bi, b_out=bo, s_max=s, total_steps=1,
                 selection=selection)
    m = jgenerate(spec, w, g, 1)
    wm = jtopk.apply_block_mask(w, m, bi, bo)
    return jpacking.pack(wm, m, bi, bo), np.asarray(wm), np.asarray(m)


def _port(p) -> PackedBCSC:
    return interop.to_torch(jax.device_get(p))


def test_transposed_table_lists_every_slot_once():
    idx = np.asarray([[0, 2], [0, 3], [2, 0]], np.int32)
    table = tbt.transposed_table(idx, kb=5)
    # (j, k) order within a row; rows 1 and 4 are never visited
    np.testing.assert_array_equal(table, [[0, 2, 5], [-1, -1, -1],
                                          [1, 4, -1], [3, -1, -1],
                                          [-1, -1, -1]])


@pytest.mark.parametrize("case", ["balanced", "global"])
def test_transposed_table_against_a_reference_mask(case):
    p, _, mask = _packed(3, 256, 128, 32, 16, 0.75, case)
    idx = np.asarray(p.idx)
    table = tbt.transposed_table(torch.tensor(idx), p.kb)
    slots = table[table >= 0]
    assert sorted(slots.tolist()) == list(range(idx.size))
    for r in range(p.kb):
        listed = table[r][table[r] >= 0]
        assert (idx.reshape(-1)[listed] == r).all()
        assert list(listed) == sorted(listed)
        if r > 0:   # padding blocks sit at idx 0 only
            assert listed.size == int(mask[r].sum())
    assert (table[:, -1] >= 0).any()     # padded to the largest count


@pytest.mark.parametrize("m,k,n,bi,bo,s", SHAPES)
def test_bspmm_t_plain_matches_reference(m, k, n, bi, bo, s):
    p, wm, _ = _packed(m + k + n, k, n, bi, bo, s)
    dy = np.random.default_rng(m).standard_normal((m, n), np.float32)
    want_k = jbt.bspmm_t(jnp.asarray(dy), p, blk_m=min(m, 16),
                         interpret=True)
    want_x = jops.bspmm_t_xla(jnp.asarray(dy), p)
    got = tops.bspmm_t(torch.from_numpy(dy), _port(p))
    assert got.dtype == torch.float32 and got.shape == (m, k)
    for want in (want_k, want_x, dy @ wm.T):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bspmm_t_plain_global_padding_and_ragged_m():
    """Global-selection masks pack zero padding blocks at idx 0, so row 0
    sees duplicate visits; M = 13 is no multiple of any tile (the
    reference kernel needs M % blk_m == 0, so it runs at M = 16 and its
    first 13 rows are compared)."""
    p, wm, _ = _packed(7, 64, 128, 8, 16, 0.7, "global")
    assert (np.asarray(p.idx) == 0).sum() > p.idx.shape[0]   # padded
    dy = np.random.default_rng(1).standard_normal((16, 128), np.float32)
    want = jbt.bspmm_t(jnp.asarray(dy), p, blk_m=16, interpret=True)
    got = tops.bspmm_t_plain(torch.from_numpy(dy[:13]), _port(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:13], **TOL)
    np.testing.assert_allclose(got.numpy(), dy[:13] @ wm.T, **TOL)


def test_bspmm_t_plain_bf16_rounds_once():
    """bf16 dY and blocks: f32 sums rounded once to bf16, as the XLA
    twin does (the interpret-mode kernel rounds after every visit)."""
    p, _, _ = _packed(2, 128, 64, 16, 16, 0.5)
    dy = np.random.default_rng(2).standard_normal((8, 64), np.float32)
    jb = jpacking.PackedBCSC(blocks=p.blocks.astype(jnp.bfloat16),
                             idx=p.idx, kb=p.kb)
    want = jops.bspmm_t_xla(jnp.asarray(dy, jnp.bfloat16), jb)
    tp = _port(p)
    got = tops.bspmm_t(torch.from_numpy(dy).bfloat16(),
                       PackedBCSC(tp.blocks.bfloat16(), tp.idx, tp.kb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("selection", ["balanced", "global"])
def test_trainable_grads_match_reference_and_dense(selection):
    """dX everywhere and dBlocks against the reference's custom VJP; dX
    and dW at kept blocks against autograd of the pruned dense product.
    The kept blocks of a column come first in its packed slots; the rest
    of a global-selection column is zero padding at idx 0, whose
    gradient no dense weight holds."""
    m, k, n, b = 24, 64, 96, 16
    p, wm, mask = _packed(11, k, n, b, b, 0.5, selection)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, k), np.float32)
    c = rng.standard_normal((m, n), np.float32)

    jf = jops.make_bspmm_trainable(p.idx, p.kb)
    jdx, jdb = jax.grad(lambda x_, b_: (jf(x_, b_) * c).sum(),
                        argnums=(0, 1))(jnp.asarray(x), p.blocks)

    tp = _port(p)
    f = tops.make_bspmm_trainable(tp.idx, tp.kb)
    xt = torch.from_numpy(x).requires_grad_()
    bt = tp.blocks.clone().requires_grad_()
    dx, db = torch.autograd.grad((f(xt, bt) * torch.from_numpy(c)).sum(),
                                 (xt, bt))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), **TOL)

    wd = torch.tensor(wm).requires_grad_()
    dx_d, dw_d = torch.autograd.grad(
        ((xt @ wd) * torch.from_numpy(c)).sum(), (xt, wd))
    np.testing.assert_allclose(dx.numpy(), dx_d.numpy(), **TOL)
    dwb = dw_d.numpy().reshape(k // b, b, n // b, b)
    idx = tp.idx.numpy()
    for j in range(n // b):
        for s in range(int(mask[:, j].sum())):
            np.testing.assert_allclose(db[j, s].numpy(),
                                       dwb[idx[j, s], :, j], **TOL)


def test_trainable_forward_matches_bspmm_and_builds_no_table_on_cpu():
    p, wm, _ = _packed(5, 64, 64, 16, 16, 0.75)
    tp = _port(p)
    f = tops.make_bspmm_trainable(tp.idx, tp.kb)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((5, 64), np.float32))
    y = f(x, tp.blocks)
    np.testing.assert_array_equal(y.numpy(), tops.bspmm_plain(x, tp).numpy())
    np.testing.assert_allclose(y.numpy(), x.numpy() @ wm, **TOL)
    assert tbt.LAUNCHES["bspmm_t"] == 0
