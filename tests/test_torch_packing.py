"""Pruning and packing in the port against the reference: keep counts,
block norms, masks, and the packed ``idx``/``blocks`` (bitwise)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpk, prune_grow as jpg, schedule as jsc  # noqa: E402
from repro.core import topk as jtk  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import packing as tpk, prune_grow as tpg  # noqa: E402
from repro_torch.core import schedule as tsc, topk as ttk  # noqa: E402


@pytest.mark.parametrize("s", [0.5, 0.75, 0.8, 0.9])
@pytest.mark.parametrize("n", [10, 16, 64])
def test_keep_count(s, n):
    want = int(jsc.keep_count(jnp.float32(s), n))
    assert tsc.keep_count(s, n) == want


def test_sparsity_at():
    for step in (0, 3, 10, 25):
        want = float(jsc.sparsity_at(step, s_init=0.1, s_max=0.8,
                                     total_steps=20, decay=2))
        assert tsc.sparsity_at(step, s_init=0.1, s_max=0.8, total_steps=20,
                               decay=2) == pytest.approx(want, rel=1e-6)


def _w(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_block_norms():
    w = _w((3, 64, 128))
    want = np.asarray(jtk.block_norms(jnp.asarray(w), 16, 32))
    got = ttk.block_norms(torch.from_numpy(w), 16, 32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 4, 13])
def test_topk_mask_per_col_bitwise(k):
    s = _w((2, 64, 16), seed=k)
    want = np.asarray(jtk.topk_mask_per_col(jnp.asarray(s), k))
    got = ttk.topk_mask_per_col(torch.from_numpy(s), k).numpy()
    np.testing.assert_array_equal(got, want)


# the serving prune of repro/launch/serve.py: gate/up have 16 block-rows,
# down 64, so s=0.8 keeps 4 and 13 of them
@pytest.mark.parametrize("shape,bi,bo", [((4, 256, 1024), 16, 16),
                                         ((4, 1024, 256), 16, 16),
                                         ((2, 128, 64), 16, 8)])
@pytest.mark.parametrize("selection", ["balanced", "global"])
def test_initial_mask_bitwise(shape, bi, bo, selection):
    w = _w(shape, seed=shape[1])
    jspec = jpg.BlastSpec(b_in=bi, b_out=bo, s_init=0.8, s_max=0.8,
                          selection=selection)
    tspec = tpg.BlastSpec(**dataclasses.asdict(jspec))
    want = np.asarray(jax.vmap(lambda x: jpg.initial_mask(jspec, x))(
        jnp.asarray(w)))
    got = tpg.initial_mask(tspec, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


def _masked(seed, k=128, n=96, bi=16, bo=16, s=0.75, dtype=jnp.bfloat16,
            balanced=True):
    w = _w((k, n), seed)
    spec = jpg.BlastSpec(b_in=bi, b_out=bo, s_init=s,
                         selection="balanced" if balanced else "global")
    m = jpg.initial_mask(spec, jnp.asarray(w))
    wm = jtk.apply_block_mask(jnp.asarray(w), m, bi, bo).astype(dtype)
    return wm, m


def _port(wm, m):
    return (interop.tensor(np.asarray(wm), device="cpu"),
            interop.tensor(np.asarray(m), device="cpu"))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_pack_unpack_bitwise(balanced, dtype):
    wm, m = _masked(1, dtype=dtype, balanced=balanced)
    jp = jpk.pack(wm, m, 16, 16)
    tw, tm = _port(wm, m)
    tp = tpk.pack(tw, tm, 16, 16)
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    np.testing.assert_array_equal(interop.array(tp.blocks),
                                  np.asarray(jp.blocks))
    assert tp.kb == jp.kb
    np.testing.assert_array_equal(interop.array(tpk.unpack(tp)),
                                  np.asarray(jpk.unpack(jp)))
    assert tpk.pad_fraction(tm) == jpk.pad_fraction(m)
    assert tpk.storage_bytes(tp) == jpk.storage_bytes(jp)


def test_pack_stacked_pad_nnz_bitwise():
    parts = [_masked(s, s=0.5) for s in range(3)]
    wm = jnp.stack([p[0] for p in parts])
    m = jnp.stack([p[1] for p in parts])
    nnz = jpk.max_nnz_per_col(m)
    jp = jpk.pack_stacked(wm, m, 16, 16, nnz)
    tp = tpk.pack_stacked(*_port(wm, m), 16, 16, nnz)
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    np.testing.assert_array_equal(interop.array(tp.blocks),
                                  np.asarray(jp.blocks))
    jq = jpk.pad_nnz(jp, nnz + 3)
    tq = tpk.pad_nnz(tp, nnz + 3)
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    np.testing.assert_array_equal(interop.array(tq.blocks),
                                  np.asarray(jq.blocks))


def test_mark_joint():
    wg, m = _masked(4)
    wu, _ = _masked(5)
    wu = jtk.apply_block_mask(wu, m, 16, 16)       # up takes gate's mask
    wo, mo = _masked(6)
    j = jpk.mark_joint(jpk.pack(wg, m, 16, 16), jpk.pack(wu, m, 16, 16))
    t = tpk.mark_joint(tpk.pack(*_port(wg, m), 16, 16),
                       tpk.pack(*_port(wu, m), 16, 16))
    assert [p.joint for p in t] == [p.joint for p in j] == [True, True]
    j = jpk.mark_joint(jpk.pack(wg, m, 16, 16), jpk.pack(wo, mo, 16, 16))
    t = tpk.mark_joint(tpk.pack(*_port(wg, m), 16, 16),
                       tpk.pack(*_port(wo, mo), 16, 16))
    assert [p.joint for p in t] == [p.joint for p in j] == [False, False]
    assert not tpk.pad_nnz(tpk.dataclasses.replace(t[0], joint=True),
                           t[0].nnz + 1).joint
