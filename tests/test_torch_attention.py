"""Paged attention in the port against the reference: the block-table
write drops parked and masked entries exactly as ``mode="drop"`` does
(bitwise), and decode / chunked-prefill attention outputs and pools match
(f32, 1e-5)."""
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

TOL = dict(rtol=1e-5, atol=1e-5)


def _pool(seed, n_pages=6, ps=4, kv=2, hd=16, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        size=(n_pages, ps, kv, hd)).astype(dtype)


@pytest.mark.parametrize("case", ["parked", "lane_mask", "token_mask",
                                  "all_dropped", "chunk"])
def test_paged_write_drops_bitwise(case):
    """Parked lanes (slot >= max_pages*ps) and masked lanes/tokens never
    write; lane 1's table is all page 0, which lane 0 owns, so a clamp
    or a stray write would show up there."""
    pool = _pool(0)
    bt = np.asarray([[0, 2], [0, 0], [3, 4]], np.int32)
    rng = np.random.default_rng(1)
    mask = None
    if case == "chunk":
        slots = np.asarray([[1, 2, 3], [5, 6, 7], [4, 5, 6]], np.int32)
        mask = np.asarray([True, False, True])
    elif case == "token_mask":
        slots = np.asarray([[0, 1, 2], [1, 2, 3], [6, 7, 8]], np.int32)
        mask = np.asarray([[True, True, False], [False, False, False],
                           [True, False, True]])
    else:
        slots = {"parked": [3, 8, 5], "lane_mask": [3, 2, 5],
                 "all_dropped": [8, 8, 8]}[case]
        slots = np.asarray(slots, np.int32)
        if case == "lane_mask":
            mask = np.asarray([True, False, True])
    vals = rng.normal(size=slots.shape + (2, 16)).astype(np.float32)
    want = np.asarray(jattn.paged_write(
        jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(slots),
        jnp.asarray(vals), None if mask is None else jnp.asarray(mask)))
    tp = torch.from_numpy(pool.copy())
    out = tattn.paged_write(tp, torch.from_numpy(bt), torch.from_numpy(slots),
                            torch.from_numpy(vals),
                            None if mask is None else torch.from_numpy(mask))
    assert out is tp                                   # in place
    np.testing.assert_array_equal(out.numpy(), want)
    if case == "all_dropped":
        np.testing.assert_array_equal(out.numpy(), pool)


def _attn_params(cfg, seed=0):
    p = jreg.init_params(cfg, jax.random.PRNGKey(seed))["layers"]["attn"]
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    return p, interop.to_torch(jax.device_get(p), device="cpu")


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_matches(window, pool_dtype):
    cfg = tiny_cfg(sliding_window=window)
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    pool_k = jnp.asarray(_pool(3), pool_dtype)
    pool_v = jnp.asarray(_pool(4), pool_dtype)
    bt = np.asarray([[1, 3, 0], [2, 4, 5], [0, 0, 0]], np.int32)
    pos = np.asarray([6, 9, 12], np.int32)             # lane 2 parked
    offsets = np.asarray([1, 0, 0], np.int32)
    y, nk, nv = jattn.paged_decode_attention(
        cfg, jp, jnp.asarray(x), pool_k, pool_v, jnp.asarray(bt),
        jnp.asarray(pos), read_pages=3, window=window,
        offsets=jnp.asarray(offsets))
    tk = interop.tensor(np.asarray(pool_k), device="cpu")
    tv = interop.tensor(np.asarray(pool_v), device="cpu")
    ty, tk2, tv2 = tattn.paged_decode_attention(
        cfg, tp, torch.from_numpy(x), tk, tv, torch.from_numpy(bt),
        torch.from_numpy(pos), read_pages=3, window=window,
        offsets=torch.from_numpy(offsets))
    np.testing.assert_allclose(ty[:2].numpy(), np.asarray(y)[:2], **TOL)
    np.testing.assert_allclose(interop.array(tk2).astype(np.float32),
                               np.asarray(nk, np.float32), **TOL)
    np.testing.assert_allclose(interop.array(tv2).astype(np.float32),
                               np.asarray(nv, np.float32), **TOL)


@pytest.mark.parametrize("slot", [0, 4])
def test_paged_chunk_attention_matches(slot):
    cfg = tiny_cfg()
    jp, tp = _attn_params(cfg, seed=1)
    rng = np.random.default_rng(3)
    c = 4
    x = rng.normal(size=(3, c, cfg.d_model)).astype(np.float32)
    pool_k, pool_v = _pool(5, n_pages=8), _pool(6, n_pages=8)
    bt = np.asarray([[1, 3, 0], [2, 4, 5], [6, 7, 0]], np.int32)
    offsets = np.asarray([2, 0, 5], np.int32)
    lane_mask = np.asarray([True, True, False])
    y, nk, nv = jattn.paged_chunk_attention(
        cfg, jp, jnp.asarray(x), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(bt), slot, jnp.asarray(offsets), read_pages=3,
        lane_mask=jnp.asarray(lane_mask))
    ty, tk, tv = tattn.paged_chunk_attention(
        cfg, tp, torch.from_numpy(x), torch.from_numpy(pool_k.copy()),
        torch.from_numpy(pool_v.copy()), torch.from_numpy(bt), slot,
        torch.from_numpy(offsets), read_pages=3,
        lane_mask=torch.from_numpy(lane_mask))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(nk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(nv), **TOL)


def test_gather_pages_and_cache_positions():
    pool = _pool(7)
    bt = np.asarray([[3, 1, 2], [0, 5, 4]], np.int32)
    np.testing.assert_array_equal(
        tattn.gather_pages(torch.from_numpy(pool), torch.from_numpy(bt),
                           2).numpy(),
        np.asarray(jattn.gather_pages(jnp.asarray(pool), jnp.asarray(bt), 2)))
    off = np.asarray([0, 3], np.int32)
    np.testing.assert_array_equal(
        tattn._cache_positions(8, torch.from_numpy(off)).numpy(),
        np.asarray(jattn._cache_positions(8, jnp.asarray(off))))
