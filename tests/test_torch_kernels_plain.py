"""The plain PyTorch versions of the port's kernels against the
reference: its XLA twins and its Pallas kernels in interpret mode, f32,
rtol/atol 1e-5 (only the summation order differs). The CUDA kernels
against these plain versions on the card: test_torch_kernels_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import packing as jpk, prune_grow as jpg, topk as jtk  # noqa: E402
from repro.kernels import bspmm as jbs, ops as jops  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import bspmm as tbs, ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _packed(seed, k, n, bi, bo, s, dtype=jnp.float32):
    # fan-in scaled, as the models initialise, so outputs are O(1)
    w = (np.random.default_rng(seed).normal(size=(k, n))
         / np.sqrt(k)).astype(np.float32)
    spec = jpg.BlastSpec(b_in=bi, b_out=bo, s_init=s)
    m = jpg.initial_mask(spec, jnp.asarray(w))
    return jpk.pack(jtk.apply_block_mask(jnp.asarray(w), m, bi, bo)
                    .astype(dtype), m, bi, bo)


def _t(p):
    return interop.to_torch(p, device="cpu")


def _x(seed, m, k):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


SHAPES = [(16, 64, 96, 16, 16, 0.5), (8, 128, 64, 32, 16, 0.75),
          (32, 64, 64, 16, 64, 0.8)]


@pytest.mark.parametrize("m,k,n,bi,bo,s", SHAPES)
@pytest.mark.parametrize("wdtype", [jnp.float32, jnp.bfloat16])
def test_bspmm_plain(m, k, n, bi, bo, s, wdtype):
    x = _x(m, m, k)
    jp = _packed(k, k, n, bi, bo, s, wdtype)
    got = tops.bspmm_plain(torch.from_numpy(x), _t(jp)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.bspmm_xla(
        jnp.asarray(x), jp)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jbs.bspmm(
        jnp.asarray(x), jp, blk_m=8, interpret=True)), **TOL)
    # the device dispatch of a CPU tensor is the plain version
    np.testing.assert_array_equal(
        tops.bspmm(torch.from_numpy(x), _t(jp)).numpy(), got)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("joint", [False, True])
def test_fused_glu_plain(act, joint):
    x = _x(3, 16, 64)
    pg = _packed(1, 64, 64, 16, 16, 0.5)
    # unequal nnz in the split case: gate keeps 2 of 4, up 1 of 4
    pu = _packed(2, 64, 64, 16, 16, 0.75 if not joint else 0.5)
    if joint:
        pu = jpk.PackedBCSC(blocks=pu.blocks, idx=pg.idx, kb=pg.kb)
        pg, pu = jpk.mark_joint(pg, pu)
        assert pg.joint
    else:
        assert pg.nnz != pu.nnz
    got = tops.fused_glu_plain(torch.from_numpy(x), _t(pg), _t(pu),
                               act).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.fused_glu(
        jnp.asarray(x), pg, pu, act=act)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jbs.fused_glu(
        jnp.asarray(x), pg, pu, act=act, blk_m=16, interpret=True)), **TOL)
    pd = _packed(4, 64, 64, 16, 16, 0.5)
    np.testing.assert_allclose(
        tops.sparse_mlp_apply(torch.from_numpy(x), _t(pg), _t(pu), _t(pd),
                              act=act).numpy(),
        np.asarray(jops.sparse_mlp_apply(jnp.asarray(x), pg, pu, pd,
                                         act=act)), **TOL)


def test_flops_bspmm():
    jp = _packed(0, 64, 96, 16, 16, 0.5)
    assert tops.flops_bspmm(8, _t(jp)) == jops.flops_bspmm(8, jp)


def _decode_case(seed, b, r, ps=4, kvh=2, g=2, hd=16, n_pages=9):
    rng = np.random.default_rng(seed)
    q4 = rng.normal(size=(b, kvh, g, hd)).astype(np.float32)
    pk = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    return q4, pk, pv


def _both(q4, pk, pv, bt, bias, softcap=0.0):
    scale = 1.0 / np.sqrt(q4.shape[-1])
    want = np.asarray(jpa.paged_flash_decode(
        jnp.asarray(q4), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(bias), scale=scale, softcap=softcap, interpret=True))
    got = tpa.paged_flash_decode_plain(
        *(interop.tensor(a, device="cpu") for a in (q4, pk, pv, bt, bias)),
        scale=scale,
        softcap=softcap).numpy()
    return got, want


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_flash_decode_plain(softcap):
    """Ragged offsets, a window, a fully masked page (lane 0's second
    page is all left-pad) and the softcap."""
    q4, pk, pv = _decode_case(0, 2, 3)
    bt = np.asarray([[3, 1, 7], [0, 5, 2]], np.int32)
    offsets = jnp.asarray([5, 2], jnp.int32)
    posb = (jnp.asarray([10, 9], jnp.int32) - offsets)[:, None]
    kpos = jattn._cache_positions(12, offsets)
    for window in (0, 3):
        bias = np.array(jpa.mask_bias(posb, kpos, window))
        if window == 0:
            bias[0, 4:8] = jpa.NEG_INF           # a whole page masked
        got, want = _both(q4, pk, pv, bt, bias, softcap)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            tpa.mask_bias(interop.tensor(posb, device="cpu"),
                          interop.tensor(kpos, device="cpu"),
                          window).numpy(),
            np.asarray(jpa.mask_bias(posb, kpos, window)))


def test_paged_flash_decode_plain_mixed_read_buckets():
    """A one-page lane beside a many-page lane under one shared R: the
    short lane's table rows alias pool page 0 (the long lane's) and must
    contribute nothing."""
    q4, pk, pv = _decode_case(5, 2, 4, n_pages=8)
    bt = np.asarray([[2, 0, 0, 0], [0, 1, 5, 7]], np.int32)
    offsets = jnp.asarray([0, 0], jnp.int32)
    posb = jnp.asarray([[2], [14]], jnp.int32)
    bias = np.array(jpa.mask_bias(posb, jattn._cache_positions(16, offsets)))
    got, want = _both(q4, pk, pv, bt, bias)
    np.testing.assert_allclose(got, want, **TOL)
    solo, _ = _both(q4[:1], pk, pv, bt[:1, :1], bias[:1, :4])
    np.testing.assert_allclose(got[0], solo[0], rtol=1e-6, atol=1e-6)


def test_paged_decode_attn_adapter():
    """(B,1,H,hd) in, same out, q's dtype kept; block tables narrower
    than the pool's table width arrive as a strided view."""
    from conftest import tiny_cfg
    cfg = tiny_cfg()
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    pk = rng.normal(size=(6, 4, 2, 16)).astype(np.float32)
    pv = rng.normal(size=(6, 4, 2, 16)).astype(np.float32)
    bt = np.asarray([[3, 1, 4], [0, 5, 2]], np.int32)
    posb = np.asarray([[6], [5]], np.int32)
    kpos = np.asarray(jattn._cache_positions(8, jnp.asarray([0, 1])))
    want = np.asarray(jpa.paged_decode_attn(
        cfg, jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(bt[:, :2]), jnp.asarray(posb), jnp.asarray(kpos),
        interpret=True))
    got = tpa.paged_decode_attn(
        cfg, torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(bt)[:, :2], torch.from_numpy(posb),
        interop.tensor(kpos, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cuda_launchers_refuse_cpu_tensors():
    """The kernel launchers never compute on the CPU: only the device
    dispatch in ops / paged_flash_decode picks the plain version."""
    jp = _packed(0, 64, 64, 16, 16, 0.5)
    x = torch.from_numpy(_x(0, 8, 64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbs.bspmm(x, _t(jp))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tbs.fused_glu(x, _t(jp), _t(jp))
    assert tbs.LAUNCHES == dict.fromkeys(tbs.LAUNCHES, 0)


def _merge_chunks(q4, pk, pv, bt, bias, splits, scale, softcap):
    """The kernel's algebra in torch: the pages cut into ``splits``
    contiguous chunks (``split_plan.split_bounds``), each folded on its
    own, the (m, l, acc) partials merged in chunk order."""
    from repro_torch.kernels import split_plan
    args = [interop.tensor(a, device="cpu") for a in (q4, pk, pv, bt, bias)]
    bounds = split_plan.split_bounds([bt.shape[1]], splits)[0]
    parts = [tpa.fold_pages(*args, range(bounds[c], bounds[c + 1]),
                            scale=scale, softcap=softcap)
             for c in range(splits)]
    m_star = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(m_star)
    acc = torch.zeros_like(parts[0][2])
    for m, lc, ac in parts:
        f = torch.exp(m - m_star)
        l = l + lc * f
        acc = acc + ac * f
    return (acc / l.clamp_min(1e-30)).numpy(), parts


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_split_merge_matches_reference(splits, softcap):
    """Chunked partials merged as the kernel's cluster merges them equal
    the reference's Pallas kernel (interpret mode): ragged lanes, a
    window, a fully masked lane (lane 2) and a lane whose later chunks
    are fully masked (lane 1: one live page of five)."""
    q4, pk, pv = _decode_case(11, 3, 5, n_pages=12)
    bt = np.asarray([[3, 1, 7, 2, 9], [0, 5, 2, 11, 4], [6, 6, 8, 10, 1]],
                    np.int32)
    ps, r = pk.shape[1], bt.shape[1]
    offsets = jnp.asarray([2, 0, 0], jnp.int32)
    posb = jnp.asarray([[r * ps - 1], [3], [r * ps - 1]], jnp.int32) \
        - offsets[:, None]
    bias = np.array(jpa.mask_bias(posb, jattn._cache_positions(r * ps,
                                                               offsets), 9))
    bias[2] = jpa.NEG_INF                            # a fully masked lane
    scale = 1.0 / np.sqrt(q4.shape[-1])
    want = np.asarray(jpa.paged_flash_decode(
        jnp.asarray(q4), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(bias), scale=scale, softcap=softcap, interpret=True))
    got, parts = _merge_chunks(q4, pk, pv, bt, bias, splits, scale, softcap)
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[2].any()                          # masked lane gives 0
    for m, l, acc in parts[1:]:                      # lane 1's dead chunks
        if splits > 1:
            assert (m[1] == jpa.NEG_INF).all() and not l[1].any()
            assert not acc[1].any()
    # one chunk is the plain version itself
    if splits == 1:
        plain = tpa.paged_flash_decode_plain(
            *(interop.tensor(a, device="cpu") for a in (q4, pk, pv, bt,
                                                        bias)),
            scale=scale, softcap=softcap).numpy()
        np.testing.assert_array_equal(got, plain)
