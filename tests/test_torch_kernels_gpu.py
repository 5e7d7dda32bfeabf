"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every case is marked ``gpu`` and skips on a host without one. The
file needs no JAX, so it runs on a GPU host that has none (``--noconftest``
skips tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: f32 1e-4 of the output's magnitude (only the summation order
differs); bf16 2**-7 of it (each side rounds an f32 result once, and the
plain fused GLU also rounds gate and up before the activation, so the
outputs may differ by about one bf16 ulp). The cases of the split-KV
decode and the split GLU on the shared loops hold the kernels at
``chip_smoke.py``'s ``ulp_tol`` (``_ulp_tol``): bf16 two ulps of the
output's magnitude, since the plain GLU rounds gate and up before a
steep activation (gelu, silu) and the kernel does not, and decode
rounds probabilities against another running max.
"""
import math

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

from repro_torch.core import topk  # noqa: E402
from repro_torch.core.packing import PackedBCSC, pack, unpack  # noqa: E402
from repro_torch.core.prune_grow import (BlastSpec, initial_mask,  # noqa: E402
                                         prune_weight)
from repro_torch.kernels import bspmm as tbs, ops as tops  # noqa: E402
from repro_torch.kernels import bspmm_t as tbt  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import split_plan  # noqa: E402
from repro_torch.core.packing import pack_stacked  # noqa: E402

DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dt, ref):
    rel = 1e-4 if dt == torch.float32 else 2.0 ** -7
    return rel * float(ref.float().abs().max())


def _ulp_tol(dt, ref):
    """chip_smoke.py's ulp_tol: f32 1e-4 of the output's magnitude, bf16
    two bf16 ulps of it."""
    mag = float(ref.float().abs().max())
    if dt == torch.float32:
        return 1e-4 * mag
    return 2.0 * 2.0 ** (math.floor(math.log2(max(mag, 1e-30))) - 7)


def _packed(seed, k, n, bi, bo, s, dt, dev, idx=None):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    spec = BlastSpec(b_in=bi, b_out=bo, s_init=s)
    m = initial_mask(spec, w)
    p = pack(prune_weight(spec, w, m), m, bi, bo)
    return PackedBCSC(p.blocks.to(dev, dt), (p.idx if idx is None else idx)
                      .to(dev), p.kb, joint=idx is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(128, 128), (32, 16)])
def test_bspmm_and_fused_glu_match_plain(cuda, m, dtype, block):
    dt = getattr(torch, dtype)
    bi, bo = block
    k, n = 4 * bi, 8 * bo
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        cuda, dt)
    pg = _packed(1, k, n, bi, bo, 0.5, dt, cuda)
    pu = _packed(2, k, n, bi, bo, 0.75, dt, cuda)        # nnz 1 vs 2: padded
    pgj = PackedBCSC(pg.blocks, pg.idx, pg.kb, joint=True)
    puj = _packed(3, k, n, bi, bo, 0.5, dt, cuda, idx=pg.idx.cpu())
    pd = _packed(4, n, k, bo, bi, 0.75, dt, cuda)
    before = dict(tbs.LAUNCHES)
    cases = [(tbs.bspmm(x, pg), tops.bspmm_plain(x, pg)),
             (tbs.fused_glu(x, pg, pu), tops.fused_glu_plain(x, pg, pu)),
             (tbs.fused_glu(x, pgj, puj),
              tops.fused_glu_plain(x, pgj, puj)),
             (tops.sparse_mlp_apply(x, pg, pu, pd),
              tops.bspmm_plain(tops.fused_glu_plain(x, pg, pu), pd))]
    torch.cuda.synchronize()
    for got, want in cases:
        assert got.dtype == dt and got.shape == want.shape
        assert float((got.float() - want.float()).abs().max()) <= _tol(
            dt, want)
    assert {k: tbs.LAUNCHES[k] - before[k] for k in before} == {
        "bspmm": 2, "fused_glu_split": 2, "fused_glu_joint": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 4, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_flash_decode_matches_plain(cuda, r, dtype, softcap):
    """B=8 lanes at the served head shape; ragged live lengths, so some
    pages are fully masked, and the table is a strided view."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(r)
    b, kvh, g, hd, ps, n_pages = 8, 8, 4, 64, 16, 64
    q4 = torch.randn(b, kvh, g, hd, generator=gen).to(cuda, dt)
    pk = torch.randn(n_pages, ps, kvh, hd, generator=gen).to(cuda, dt)
    pv = torch.randn(n_pages, ps, kvh, hd, generator=gen).to(cuda, dt)
    table = torch.randint(0, n_pages, (b, 32), generator=gen,
                          dtype=torch.int32).to(cuda)
    lens = torch.randint(1, r * ps + 1, (b,), generator=gen).to(cuda)
    bias = torch.where(torch.arange(r * ps, device=cuda)[None]
                       < lens[:, None], 0.0, tpa.NEG_INF).float().contiguous()
    before = tpa.LAUNCHES["paged_flash_decode"]
    got = tpa.paged_flash_decode(q4, pk, pv, table[:, :r], bias, scale=0.125,
                                 softcap=softcap)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, table[:, :r], bias,
                                        scale=0.125, softcap=softcap)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_flash_decode"] == before + 1
    assert float((got - want).abs().max()) <= _tol(dt, want)


@pytest.mark.gpu
def test_launchers_reject_what_the_kernels_do_not_take(cuda):
    p = _packed(0, 256, 256, 128, 128, 0.5, torch.bfloat16, cuda)
    x = torch.randn(8, 512, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tbs.bspmm(x[:, ::2], p)
    with pytest.raises(TypeError, match="int32"):
        tbs.bspmm(x[:, :256].contiguous(),
                  PackedBCSC(p.blocks, p.idx.long(), p.kb))
    with pytest.raises(TypeError, match="not supported"):
        tbs.bspmm(x[:, :256].contiguous().half(), p)
    with pytest.raises(ValueError, match="K="):
        tbs.bspmm(x, p)


def _mask_cases(k, n, bi, bo, gen):
    """Balanced magnitude mask; the same with block-rows 0 and 2 of W
    zeroed, so no kept block visits them; a global-selection mask, which
    packs with zero padding blocks at idx 0."""
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    spec = BlastSpec(b_in=bi, b_out=bo, s_init=0.75)
    hole = w.clone()
    hole[:bi] = 0.0
    hole[2 * bi:3 * bi] = 0.0
    norms = topk.block_norms(w, bi, bo)
    glob = topk.topk_mask_global(norms, norms.numel() // 4)
    return {"balanced": (w, initial_mask(spec, w)),
            "empty_rows": (hole, initial_mask(spec, hole)),
            "global": (w, glob)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 128, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(128, 128), (32, 16), (16, 64)])
def test_bspmm_t_matches_plain(cuda, m, dtype, block):
    dt = getattr(torch, dtype)
    bi, bo = block
    k, n = 8 * bi, 4 * bo
    gen = torch.Generator().manual_seed(m + bi)
    dy = torch.randn(m, n, generator=gen).to(cuda, dt)
    for name, (w, mask) in _mask_cases(k, n, bi, bo, gen).items():
        p = pack(topk.apply_block_mask(w, mask, bi, bo), mask, bi, bo)
        p = PackedBCSC(p.blocks.to(cuda, dt), p.idx.to(cuda), p.kb)
        plan = tbt.device_plan(p.idx, p.kb)
        before = tbt.LAUNCHES["bspmm_t"]
        got = tops.bspmm_t(dy, p, plan)
        want = tops.bspmm_t_plain(dy, p)
        torch.cuda.synchronize()
        assert tbt.LAUNCHES["bspmm_t"] == before + 1
        assert got.dtype == dt and got.shape == (m, k)
        assert float((got.float() - want.float()).abs().max()) <= _tol(
            dt, want), name
        if name == "empty_rows":
            assert not bool(got[:, :bi].any()), "unvisited row not zero"


@pytest.mark.gpu
def test_trainable_bspmm_matches_dense_autograd(cuda):
    """f32: dX everywhere and dW at kept blocks against autograd of the
    pruned dense product; bspmm and bspmm_t each launch once."""
    gen = torch.Generator().manual_seed(7)
    m, k, n, b = 96, 256, 512, 128
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    mask = initial_mask(BlastSpec(b_in=b, b_out=b, s_init=0.5), w)
    wm = topk.apply_block_mask(w, mask, b, b)
    p = pack(wm, mask, b, b)
    x = torch.randn(m, k, generator=gen).to(cuda).requires_grad_()
    c = torch.randn(m, n, generator=gen).to(cuda)
    blocks = p.blocks.to(cuda).requires_grad_()
    f = tops.make_bspmm_trainable(p.idx.to(cuda), p.kb)
    before = (tbs.LAUNCHES["bspmm"], tbt.LAUNCHES["bspmm_t"])
    dx, db = torch.autograd.grad((f(x, blocks) * c).sum(), (x, blocks))
    assert (tbs.LAUNCHES["bspmm"], tbt.LAUNCHES["bspmm_t"]) == (
        before[0] + 1, before[1] + 1)
    wd = wm.to(cuda).requires_grad_()
    dx_d, dw_d = torch.autograd.grad(((x @ wd) * c).sum(), (x, wd))
    torch.cuda.synchronize()
    assert float((dx - dx_d).abs().max()) <= _tol(torch.float32, dx_d)
    kept = topk.expand_mask(mask, b, b).to(cuda)
    dw = unpack(PackedBCSC(db, p.idx.to(cuda), p.kb))
    assert float((dw - dw_d)[kept].abs().max()) <= _tol(torch.float32, dw_d)


@pytest.mark.gpu
def test_bspmm_t_launcher_rejects_what_the_kernel_does_not_take(cuda):
    p = _packed(0, 256, 256, 128, 128, 0.5, torch.bfloat16, cuda)
    dy = torch.randn(8, 512, device=cuda, dtype=torch.bfloat16)
    plan = tbt.device_plan(p.idx, p.kb)
    with pytest.raises(ValueError, match="contiguous"):
        tbt.bspmm_t(dy[:, ::2], p, plan)
    other = tbt.device_plan(torch.zeros_like(p.idx)[:1], p.kb)
    with pytest.raises(ValueError, match="plan lists"):
        tbt.bspmm_t(dy[:, :256].contiguous(), p, other)
    with pytest.raises(TypeError, match="not supported"):
        tbt.bspmm_t(dy[:, :256].contiguous().half(), p, plan)
    with pytest.raises(ValueError, match="N="):
        tbt.bspmm_t(dy, p, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 128, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(128, 128), (32, 16), (16, 64), (8, 8)])
def test_bspmm_kernels_match_plain(cuda, m, dtype, block):
    """Every main loop against the plain version: bf16 blocks whose sides
    are multiples of 16 take the tensor cores, f32 and b = 8 the FMA
    loop; the global-selection mask packs zero padding at idx 0."""
    dt = getattr(torch, dtype)
    bi, bo = block
    k, n = 8 * bi, 4 * bo
    gen = torch.Generator().manual_seed(m + bi + bo)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    for name, (w, mask) in _mask_cases(k, n, bi, bo, gen).items():
        p = pack(topk.apply_block_mask(w, mask, bi, bo), mask, bi, bo)
        p = PackedBCSC(p.blocks.to(cuda, dt), p.idx.to(cuda), p.kb)
        lp = tbs.launch_plan(x, p)
        tc = dt == torch.bfloat16 and bi % 16 == 0 and bo % 16 == 0
        assert (lp.kernel.kid >= 2) == tc, lp
        before = tbs.LAUNCHES["bspmm"]
        got = tops.bspmm(x, p)
        want = tops.bspmm_plain(x, p)
        torch.cuda.synchronize()
        assert tbs.LAUNCHES["bspmm"] == before + 1
        assert got.dtype == dt and got.shape == (m, n)
        assert float((got.float() - want.float()).abs().max()) <= _tol(
            dt, want), (name, lp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_bspmm_t_global_mask_at_fine_tuning_rows(cuda, dtype):
    """The served down shape (dY (1024, 2048) -> dX (1024, 8192), 128 x
    128 blocks) under a global-selection mask: block-row 0's list is
    long (zero padding at idx 0); in bf16 it is split across a cluster
    (in f32 the FMA loop's total work fills the card, so one CTA per
    tile is cheapest)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    k, n, b, m = 8192, 2048, 128, 1024
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    norms = topk.block_norms(w, b, b)
    mask = topk.topk_mask_global(norms, norms.numel() // 5)
    p = pack(topk.apply_block_mask(w, mask, b, b), mask, b, b)
    p = PackedBCSC(p.blocks.to(cuda, dt), p.idx.to(cuda), p.kb)
    plan = tbt.device_plan(p.idx, p.kb)
    assert plan.max_len > 2 * plan.total / p.kb      # a long row 0
    dy = torch.randn(m, n, generator=gen).to(cuda, dt)
    if dt == torch.bfloat16:
        assert tbt.launch_plan(dy, p, plan).splits > 1
    got = tops.bspmm_t(dy, p, plan)
    want = tops.bspmm_t_plain(dy, p)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= _tol(dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_kernels_are_bitwise_deterministic(cuda, dtype):
    """Split visit lists are reduced in rank order, not by atomics: two
    runs of the same case give the same bits (bf16 splits both products
    at these shapes; f32 runs them unsplit, and is held to the same)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(9)
    k, n, b = 2048, 8192, 128
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    mask = initial_mask(BlastSpec(b_in=b, b_out=b, s_init=0.8), w)
    p = pack(topk.apply_block_mask(w, mask, b, b), mask, b, b)
    p = PackedBCSC(p.blocks.to(cuda, dt), p.idx.to(cuda), p.kb)
    plan = tbt.device_plan(p.idx, p.kb)
    for m in (8, 1024):
        x = torch.randn(m, k, generator=gen).to(cuda, dt)
        dy = torch.randn(m, n, generator=gen).to(cuda, dt)
        if dt == torch.bfloat16:
            assert max(tbs.launch_plan(x, p).splits,
                       tbt.launch_plan(dy, p, plan).splits) > 1
        y1, y2 = tops.bspmm(x, p), tops.bspmm(x, p)
        d1, d2 = tops.bspmm_t(dy, p, plan), tops.bspmm_t(dy, p, plan)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2) and torch.equal(d1, d2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_take_stacked_layer_views_and_unaligned_rows(cuda, dtype):
    """Both kernels on ``.layer(i)`` views of a stacked pack (a storage
    offset), and bspmm on an X that starts 2 bytes off a 16-byte
    boundary, which no 16-byte copy may touch (the element-load FMA loop
    takes it)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    n_l, k, n, b, m = 3, 512, 1024, 128, 64
    w = torch.randn(n_l, k, n, generator=gen) / k ** 0.5
    spec = BlastSpec(b_in=b, b_out=b, s_init=0.75)
    masks = torch.stack([initial_mask(spec, w[i]) for i in range(n_l)])
    wm = torch.stack([topk.apply_block_mask(w[i], masks[i], b, b)
                      for i in range(n_l)])
    ps = pack_stacked(wm, masks, b, b, nnz=int(masks.sum(-2).max()))
    ps = PackedBCSC(ps.blocks.to(cuda, dt), ps.idx.to(cuda), ps.kb)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    dy = torch.randn(m, n, generator=gen).to(cuda, dt)
    for i in range(n_l):
        p = ps.layer(i)
        assert p.blocks.storage_offset() == i * p.blocks.numel()
        plan = tbt.device_plan(p.idx, p.kb)
        cases = [(tops.bspmm(x, p), tops.bspmm_plain(x, p)),
                 (tops.bspmm_t(dy, p, plan), tops.bspmm_t_plain(dy, p))]
        for got, want in cases:
            assert float((got.float() - want.float()).abs().max()) <= _tol(
                dt, want), i
    buf = torch.empty(m * k + 1, device=cuda, dtype=dt)
    xo = buf[1:].view(m, k)
    xo.copy_(x)
    p = ps.layer(1)
    assert xo.data_ptr() % 16 and tbs.launch_plan(xo, p).kernel.kid == 0
    got, want = tops.bspmm(xo, p), tops.bspmm_plain(xo, p)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= _tol(dt, want)


def _decode_inputs(gen, b, r, ps, hd, qkv, dev, kvh=8, g=4, n_pages=80):
    """q, pools and a (B, R) table sliced from a wider one (strided, as
    served). Lane 0 is fully masked; lane 1 lives in its first page only
    (its later chunks are fully masked); the others have a ragged live
    range under a window."""
    qd, kd = {"bfloat16": (torch.bfloat16,) * 2,
              "float32": (torch.float32,) * 2,
              "f32_over_bf16": (torch.float32, torch.bfloat16)}[qkv]
    q4 = torch.randn(b, kvh, g, hd, generator=gen).to(dev, qd)
    pk = torch.randn(n_pages, ps, kvh, hd, generator=gen).to(dev, kd)
    pv = torch.randn(n_pages, ps, kvh, hd, generator=gen).to(dev, kd)
    table = torch.randint(0, n_pages, (b, r + 3), generator=gen,
                          dtype=torch.int32).to(dev)
    hi = torch.randint(1, r * ps + 1, (b,), generator=gen)
    lo = (hi - torch.randint(1, 3 * ps, (b,), generator=gen)).clamp_min(0)
    hi[0], lo[0] = 0, 0
    if b > 1:
        hi[1], lo[1] = min(ps, r * ps), 0
    slot = torch.arange(r * ps)[None]
    bias = torch.where((slot >= lo[:, None]) & (slot < hi[:, None]), 0.0,
                       tpa.NEG_INF).float().contiguous().to(dev)
    return q4, pk, pv, table[:, :r], bias


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("page", [(16, 64), (8, 128)])
@pytest.mark.parametrize("qkv", ["bfloat16", "float32", "f32_over_bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_flash_decode_split_kv_matches_plain(cuda, r, b, page, qkv,
                                                   softcap):
    """Split-KV across a cluster: B in {1, 8, 33} lanes of 8 kv heads
    gives S = min(8, R), 3 and 1 CTAs per (lane, head) at R >= 8. Each
    case against the plain version, and two runs bitwise equal."""
    ps, hd = page
    gen = torch.Generator().manual_seed(r * 100 + b)
    q4, pk, pv, bt, bias = _decode_inputs(gen, b, r, ps, hd, qkv, cuda)
    assert bt.stride(0) == r + 3
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = split_plan.decode_splits(b, 8, r, sms)
    assert splits == min(8, r, -(-sms // (8 * b)))
    before = tpa.LAUNCHES["paged_flash_decode"]
    got = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=0.125,
                                 softcap=softcap)
    again = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=0.125,
                                   softcap=softcap)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, bt, bias, scale=0.125,
                                        softcap=softcap)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_flash_decode"] == before + 2
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, again)
    assert not got[0].any()                              # masked lane
    dt = q4.dtype
    assert float((got - want).abs().max()) <= _ulp_tol(dt, want), splits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_flash_decode_masks_table_entries_outside_the_pool(cuda,
                                                                 dtype):
    """A table entry outside [0, n_pages) is never read and its slots
    count as masked: the same as a valid entry whose bias masks the
    page."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    b, r, ps, hd = 8, 16, 16, 64
    q4, pk, pv, bt, bias = _decode_inputs(gen, b, r, ps, hd, dtype, cuda)
    bias.zero_()
    bad, masked = bt.clone(), bias.clone()
    bad[2, 5], bad[3, 0], bad[4, r - 1] = pk.shape[0], -1, 1 << 30
    for lane, page in ((2, 5), (3, 0), (4, r - 1)):
        masked[lane, page * ps:(page + 1) * ps] = tpa.NEG_INF
    got = tpa.paged_flash_decode(q4, pk, pv, bad, bias, scale=0.125)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, bt, masked, scale=0.125)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= _ulp_tol(dt, want)


def _glu_pair(seed, k, n, bi, bo, dt, dev):
    """Gate and up with different masks and unequal nnz (padded)."""
    return (_packed(seed, k, n, bi, bo, 0.5, dt, dev),
            _packed(seed + 1, k, n, bi, bo, 0.75, dt, dev))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 128])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(128, 128), (32, 16), (16, 64), (8, 8)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_fused_glu_split_matches_plain(cuda, m, dtype, block, act):
    """The split fused GLU on the shared main loops: bf16 blocks whose
    sides are multiples of 16 take the tensor cores, f32 and b = 8 the
    FMA loop; each case against the plain version, two runs bitwise
    equal, one launch each."""
    dt = getattr(torch, dtype)
    bi, bo = block
    k, n = 8 * bi, 4 * bo
    gen = torch.Generator().manual_seed(m + bi + bo)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    pg, pu = _glu_pair(m, k, n, bi, bo, dt, cuda)
    assert pg.nnz != pu.nnz
    lp = tbs.launch_plan(x, pg, pu)
    tc = dt == torch.bfloat16 and bi % 16 == 0 and bo % 16 == 0
    assert (lp.kernel.kid >= 2) == tc, lp
    before = tbs.LAUNCHES["fused_glu_split"]
    got = tbs.fused_glu(x, pg, pu, act=act)
    again = tbs.fused_glu(x, pg, pu, act=act)
    want = tops.fused_glu_plain(x, pg, pu, act)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["fused_glu_split"] == before + 2
    assert got.dtype == dt and got.shape == (m, n)
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        dt, want), lp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_glu_split_is_bitwise_repeatable_when_split(cuda, dtype):
    """The served gate/up shape (2048 -> 8192, 128 x 128 blocks) at the
    prefill chunk's 128 rows, where the plan splits each column's visits
    across a cluster in bf16: two runs give the same bits."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(12)
    k, n, b, m = 2048, 8192, 128, 128
    pg = _packed(21, k, n, b, b, 0.8, dt, cuda)
    pu = _packed(22, k, n, b, b, 0.8, dt, cuda)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    if dt == torch.bfloat16:
        assert tbs.launch_plan(x, pg, pu).splits > 1
    y1, y2 = tbs.fused_glu(x, pg, pu), tbs.fused_glu(x, pg, pu)
    want = tops.fused_glu_plain(x, pg, pu)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert float((y1.float() - want.float()).abs().max()) <= _ulp_tol(dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_glu_split_takes_stacked_layer_views_and_unaligned_rows(
        cuda, dtype):
    """The split GLU on ``.layer(i)`` views of stacked gate and up packs
    (a storage offset), and on an X that starts 2 bytes off a 16-byte
    boundary (the element-load FMA loop takes it)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    n_l, k, n, b, m = 3, 512, 1024, 128, 8
    spec = BlastSpec(b_in=b, b_out=b, s_init=0.75)
    stacks = []
    for _ in range(2):
        w = torch.randn(n_l, k, n, generator=gen) / k ** 0.5
        masks = torch.stack([initial_mask(spec, w[i]) for i in range(n_l)])
        wm = torch.stack([topk.apply_block_mask(w[i], masks[i], b, b)
                          for i in range(n_l)])
        ps = pack_stacked(wm, masks, b, b, nnz=int(masks.sum(-2).max()))
        stacks.append(PackedBCSC(ps.blocks.to(cuda, dt), ps.idx.to(cuda),
                                 ps.kb))
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    for i in range(n_l):
        pg, pu = stacks[0].layer(i), stacks[1].layer(i)
        assert pu.blocks.storage_offset() == i * pu.blocks.numel()
        got = tbs.fused_glu(x, pg, pu, act="gelu")
        want = tops.fused_glu_plain(x, pg, pu, "gelu")
        assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
            dt, want), i
    buf = torch.empty(m * k + 1, device=cuda, dtype=dt)
    xo = buf[1:].view(m, k)
    xo.copy_(x)
    pg, pu = stacks[0].layer(1), stacks[1].layer(1)
    assert xo.data_ptr() % 16 and tbs.launch_plan(xo, pg, pu).kernel.kid == 0
    got, want = tbs.fused_glu(xo, pg, pu), tops.fused_glu_plain(xo, pg, pu)
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(dt, want)
