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
rounds probabilities against another running max. The expert-batched
launches (the MoE layer: all E experts in one launch) and paged decode at
9 to 16 query heads per kv head are held to it too.
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
    # the joint fused GLU takes the same rules
    pj = PackedBCSC(p.blocks, p.idx, p.kb, joint=True)
    x2 = x[:, :256].contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        tbs.fused_glu(x[:, ::2], pj, pj)
    pl = PackedBCSC(p.blocks, p.idx.long(), p.kb, joint=True)
    with pytest.raises(TypeError, match="int32"):
        tbs.fused_glu(x2, pl, pl)
    with pytest.raises(TypeError, match="not supported"):
        tbs.fused_glu(x2.half(), pj, pj)
    with pytest.raises(ValueError, match="K="):
        tbs.fused_glu(x, pj, pj)
    with pytest.raises(ValueError, match="act"):
        tbs.fused_glu(x2, pj, pj, act="tanh")
    wide = PackedBCSC(torch.zeros(1, 1, 128, 96, device=cuda,
                                  dtype=torch.bfloat16),
                      torch.zeros(1, 1, device=cuda, dtype=torch.int32), 2,
                      joint=True)
    with pytest.raises(ValueError, match="b_out=96"):
        tbs.fused_glu(x2, wide, wide)


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
    ps = pack(wm, masks, b, b, nnz=int(masks.sum(-2).max()))
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
        ps = pack(wm, masks, b, b, nnz=int(masks.sum(-2).max()))
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


# (X dtype, weight dtype) of the joint GLU cases
GLU_DTYPES = {"bfloat16": (torch.bfloat16, torch.bfloat16),
              "float32": (torch.float32, torch.float32),
              "f32_over_bf16": (torch.float32, torch.bfloat16)}


def _joint_pair(seed, k, n, bi, bo, wdt, dev, s=0.5):
    """Gate and up packed on gate's idx table, both marked joint."""
    pg = _packed(seed, k, n, bi, bo, s, wdt, dev)
    return (PackedBCSC(pg.blocks, pg.idx, pg.kb, joint=True),
            _packed(seed + 1, k, n, bi, bo, s, wdt, dev, idx=pg.idx.cpu()))


def _joint_launches(run):
    """``run()``'s launches by kernel: the joint GLU's only."""
    before = dict(tbs.LAUNCHES)
    out = run()
    torch.cuda.synchronize()
    d = {k: tbs.LAUNCHES[k] - before[k] for k in before}
    assert d["bspmm"] == d["fused_glu_split"] == 0, d
    return out, d["fused_glu_joint"]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 128, 1024])
@pytest.mark.parametrize("dtype", list(GLU_DTYPES))
@pytest.mark.parametrize("block", [(128, 128), (32, 16), (16, 64), (8, 8)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_fused_glu_joint_matches_plain(cuda, m, dtype, block, act):
    """The joint fused GLU on the shared main loops: bf16 blocks whose
    sides are multiples of 16 take the tensor cores, f32, f32 X over bf16
    weights and b = 8 the FMA loop; each case against the plain version
    within ``ulp_tol``, two runs bitwise equal, one launch each."""
    xdt, wdt = GLU_DTYPES[dtype]
    bi, bo = block
    k, n = 8 * bi, 4 * bo
    gen = torch.Generator().manual_seed(m + bi + bo)
    x = torch.randn(m, k, generator=gen).to(cuda, xdt)
    pg, pu = _joint_pair(m, k, n, bi, bo, wdt, cuda)
    lp = tbs.launch_plan(x, pg, pu)
    tc = xdt == wdt == torch.bfloat16 and bi % 16 == 0 and bo % 16 == 0
    assert (lp.kernel.kid >= 2) == tc, lp
    (got, again), n_launch = _joint_launches(
        lambda: (tbs.fused_glu(x, pg, pu, act=act),
                 tbs.fused_glu(x, pg, pu, act=act)))
    want = tops.fused_glu_plain(x, pg, pu, act)
    assert n_launch == 2
    assert got.dtype == xdt and got.shape == (m, n)
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        xdt, want), lp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_glu_joint_is_bitwise_repeatable_when_split(cuda, dtype):
    """The served gate/up shape (2048 -> 8192, 128 x 128 blocks) with up
    on gate's masks, at the prefill chunk's 128 rows, where the plan
    splits each column's visits across a cluster in bf16: two runs give
    the same bits."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(13)
    k, n, b, m = 2048, 8192, 128, 128
    pg, pu = _joint_pair(23, k, n, b, b, dt, cuda, s=0.8)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    if dt == torch.bfloat16:
        assert tbs.launch_plan(x, pg, pu).splits > 1
    (y1, y2), n_launch = _joint_launches(
        lambda: (tbs.fused_glu(x, pg, pu), tbs.fused_glu(x, pg, pu)))
    want = tops.fused_glu_plain(x, pg, pu)
    assert n_launch == 2
    assert torch.equal(y1, y2)
    assert float((y1.float() - want.float()).abs().max()) <= _ulp_tol(dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_glu_joint_takes_stacked_layer_views_and_unaligned_rows(
        cuda, dtype):
    """The joint GLU on ``.layer(i)`` views of stacked gate and up packs
    on one set of masks (a storage offset), and on an X that starts 2
    bytes off a 16-byte boundary (the element-load FMA loop takes it)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(18)
    n_l, k, n, b, m = 3, 512, 1024, 128, 8
    spec = BlastSpec(b_in=b, b_out=b, s_init=0.75)
    w = torch.randn(2, n_l, k, n, generator=gen) / k ** 0.5
    masks = torch.stack([initial_mask(spec, w[0, i]) for i in range(n_l)])
    stacks = []
    for g in range(2):
        wm = torch.stack([topk.apply_block_mask(w[g, i], masks[i], b, b)
                          for i in range(n_l)])
        ps = pack(wm, masks, b, b, nnz=int(masks.sum(-2).max()))
        stacks.append(PackedBCSC(ps.blocks.to(cuda, dt), ps.idx.to(cuda),
                                 ps.kb, joint=True))
    assert torch.equal(stacks[0].idx, stacks[1].idx)
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    for i in range(n_l):
        pg, pu = stacks[0].layer(i), stacks[1].layer(i)
        assert pu.blocks.storage_offset() == i * pu.blocks.numel()
        got, n_launch = _joint_launches(
            lambda: tbs.fused_glu(x, pg, pu, act="gelu"))
        want = tops.fused_glu_plain(x, pg, pu, "gelu")
        assert n_launch == 1
        assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
            dt, want), i
    buf = torch.empty(m * k + 1, device=cuda, dtype=dt)
    xo = buf[1:].view(m, k)
    xo.copy_(x)
    pg, pu = stacks[0].layer(1), stacks[1].layer(1)
    assert xo.data_ptr() % 16 and tbs.launch_plan(xo, pg, pu).kernel.kid == 0
    got, n_launch = _joint_launches(lambda: tbs.fused_glu(xo, pg, pu))
    want = tops.fused_glu_plain(xo, pg, pu)
    assert n_launch == 1
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(dt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("dtype", list(GLU_DTYPES))
def test_fused_glu_joint_takes_b_out_384(cuda, m, dtype):
    """b_out = 384 (3 x 128, a width that does not divide 256): the
    tensor cores take it in bf16, the FMA loop in f32."""
    xdt, wdt = GLU_DTYPES[dtype]
    gen = torch.Generator().manual_seed(m)
    k, n, bi, bo = 512, 1536, 128, 384
    x = torch.randn(m, k, generator=gen).to(cuda, xdt)
    pg, pu = _joint_pair(7, k, n, bi, bo, wdt, cuda)
    got, n_launch = _joint_launches(lambda: tbs.fused_glu(x, pg, pu))
    want = tops.fused_glu_plain(x, pg, pu)
    assert n_launch == 1 and got.shape == (m, n)
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        xdt, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [5, 8, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_joint_glu_equals_the_split_kernel_bitwise(cuda, m, dtype):
    """The served gate/up shape (2048 -> 8192, 128 x 128 blocks, s = 0.8)
    with up on gate's idx table: the joint kernel, and the split kernel
    on the same weights with the joint mark cleared (idx_up = idx), take
    one plan here and sum the same products in the same order, so their
    outputs are bitwise equal."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(31 + m)
    k, n, b = 2048, 8192, 128
    jg, ju = _joint_pair(41, k, n, b, b, dt, cuda, s=0.8)
    sg, su = (PackedBCSC(p.blocks, p.idx, p.kb) for p in (jg, ju))
    x = torch.randn(m, k, generator=gen).to(cuda, dt)
    assert tbs.launch_plan(x, jg, ju) == tbs.launch_plan(x, sg, su)
    before = dict(tbs.LAUNCHES)
    joint = tbs.fused_glu(x, jg, ju, act="silu")
    split = tbs.fused_glu(x, sg, su, act="silu")
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["fused_glu_joint"] == before["fused_glu_joint"] + 1
    assert tbs.LAUNCHES["fused_glu_split"] == before["fused_glu_split"] + 1
    assert torch.equal(joint, split)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 32, 64])
@pytest.mark.parametrize("kernel", ["bspmm", "fused_glu_split",
                                    "fused_glu_joint"])
def test_mixed_step_rows_at_the_served_block_match_plain(cuda, m, kernel):
    """bf16 at 128 x 128 blocks on the served shapes (gate/up 2048 ->
    8192, down 8192 -> 2048, s = 0.8) at the rows the mixed step gives the
    MLP (8 lanes x W in {2, 4, 8}) and a short prefill chunk: the 16-row
    tile at M = 16, the 64 x 64 x 64 tile at 32 and 64; against the plain
    version within ``ulp_tol``, one launch each."""
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(50 + m)
    k, n, b = 2048, 8192, 128
    if kernel == "bspmm":
        args = (_packed(61, n, k, b, b, 0.8, dt, cuda),)
        x = torch.randn(m, n, generator=gen).to(cuda, dt)
        run, plain = tbs.bspmm, tops.bspmm_plain
    else:
        pair = (_joint_pair(62, k, n, b, b, dt, cuda, s=0.8)
                if kernel == "fused_glu_joint"
                else _glu_pair(62, k, n, b, b, dt, cuda))
        args = pair
        x = torch.randn(m, k, generator=gen).to(cuda, dt)
        run, plain = tbs.fused_glu, tops.fused_glu_plain
    lp = tbs.launch_plan(x, *args)
    assert lp.kernel.name == ("mma_16x64x128" if m <= 16
                              else "mma_64x64x64"), lp
    before = dict(tbs.LAUNCHES)
    got = run(x, *args)
    want = plain(x, *args)
    torch.cuda.synchronize()
    d = {k_: tbs.LAUNCHES[k_] - before[k_] for k_ in before}
    assert d == {name: int(name == kernel) for name in d}, d
    assert got.dtype == dt and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        dt, want), lp


# the dense --arch models' shapes (configs/*.py, with_blast at TP = 16):
# (d_model, d_ff, b_in, b_out) per model, and (kv heads, G, head dim,
# scale, softcap) of its decode attention
ARCH_MLP = {"stablelm-3b": (2560, 6912, 128, 16),
            "stablelm-12b": (5120, 13824, 128, 32),
            "qwen2-7b": (3584, 18944, 128, 32),
            "gemma2-27b": (4608, 36864, 128, 128)}
ARCH_ATTN = {"stablelm-3b": (32, 1, 80, 80 ** -0.5, 0.0),
             "stablelm-12b": (8, 4, 160, 160 ** -0.5, 0.0),
             "qwen2-7b": (4, 8, 128, 128 ** -0.5, 0.0),
             "gemma2-27b": (16, 2, 128, 0.0625, 50.0)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("arch", sorted(ARCH_MLP))
def test_arch_mlp_kernels_match_plain(cuda, arch, m):
    """One full-width layer of each dense model in bf16 at s = 0.8: the
    split GLU (gemma2's gelu) on the (d_model, d_ff) weights and ``bspmm``
    on the down projection's swapped blocks, within ``_ulp_tol``."""
    d, f, bi, bo = ARCH_MLP[arch]
    act = "gelu" if arch == "gemma2-27b" else "silu"
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(m)
    gate = _packed(1, d, f, bi, bo, 0.8, dt, cuda)
    up = _packed(2, d, f, bi, bo, 0.8, dt, cuda)
    down = _packed(3, f, d, bo, bi, 0.8, dt, cuda)
    x = torch.randn(m, d, generator=gen).to(cuda, dt)
    h = tops.fused_glu(x, gate, up, act=act)
    want_h = tops.fused_glu_plain(x, gate, up, act)
    y, want_y = tops.bspmm(want_h, down), tops.bspmm_plain(want_h, down)
    torch.cuda.synchronize()
    assert h.shape == (m, f) and y.shape == (m, d)
    assert float((h.float() - want_h.float()).abs().max()) <= _ulp_tol(
        dt, want_h)
    assert float((y.float() - want_y.float()).abs().max()) <= _ulp_tol(
        dt, want_y)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 16])
@pytest.mark.parametrize("arch", sorted(ARCH_ATTN))
def test_arch_paged_decode_matches_plain(cuda, arch, r):
    """Paged decode with each dense model's kv heads, G (qwen2-7b's padded
    32 query heads over 4 kv heads give G = 8, the kernel's cap), head
    dim (80 and 160 are not multiples of 64), scale and softcap."""
    kvh, g, hd, scale, cap = ARCH_ATTN[arch]
    gen = torch.Generator().manual_seed(r + hd)
    q4, pk, pv, bt, bias = _decode_inputs(gen, 8, r, 16, hd, "bfloat16",
                                          cuda, kvh=kvh, g=g)
    got = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=scale,
                                 softcap=cap)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, bt, bias, scale=scale,
                                        softcap=cap)
    torch.cuda.synchronize()
    assert got.shape == (8, kvh, g, hd) and not got[0].any()
    assert float((got - want).abs().max()) <= _ulp_tol(torch.bfloat16, want)


def _expert_packs(gen, e, k, n, keep, dt, dev, b=128):
    """(E, Nb, keep, b, b) random balanced packs of E experts' (K, N)
    weights: keep kept blocks in every block-column."""
    kb, nb = k // b, n // b
    idx = torch.stack([torch.stack([torch.randperm(kb, generator=gen)[:keep]
                                    .sort().values for _ in range(nb)])
                       for _ in range(e)]).to(torch.int32)
    blocks = torch.randn(e, nb, keep, b, b, generator=gen) / (keep * b) ** .5
    return PackedBCSC(blocks.to(dev, dt).contiguous(), idx.to(dev), kb)


# the MoE --arch shapes at full width: E experts, d_model, moe_d_ff, kept
# blocks per column of the gate/up and of the down projection at s = 0.8
MOE_SHAPES = {"deepseek": (64, 2048, 1408, 3, 2),
              "qwen3": (128, 4096, 1536, 6, 2)}


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 5, 8, 10, 15])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", sorted(MOE_SHAPES))
def test_expert_batched_kernels_match_plain(cuda, arch, dtype, c):
    """The expert-batched ``bspmm``, split GLU and joint GLU at the MoE
    shapes, C rows per expert (decode C = 1; the launcher's 64-token
    prefill and mixed calls, C = 5 and 8; 128-token calls, C = 10 and
    15): one
    launch each for all E experts, within ``_ulp_tol`` of the batched
    plain version, and bitwise repeatable."""
    e, d, f, keep_d, keep_f = MOE_SHAPES[arch]
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(c)
    gate = _expert_packs(gen, e, d, f, keep_d, dt, cuda)
    up = _expert_packs(gen, e, d, f, keep_d, dt, cuda)
    down = _expert_packs(gen, e, f, d, keep_f, dt, cuda)
    jg = PackedBCSC(gate.blocks, gate.idx, gate.kb, joint=True)
    ju = PackedBCSC(up.blocks, gate.idx, up.kb, joint=True)
    x = torch.randn(e, c, d, generator=gen).to(cuda, dt)
    h = torch.randn(e, c, f, generator=gen).to(cuda, dt)
    cases = {"bspmm": (lambda: tbs.bspmm(h, down),
                       lambda: tops.bspmm_plain(h, down), (e, c, d)),
             "fused_glu_split": (lambda: tbs.fused_glu(x, gate, up),
                                 lambda: tops.fused_glu_plain(x, gate, up),
                                 (e, c, f)),
             "fused_glu_joint": (lambda: tbs.fused_glu(x, jg, ju),
                                 lambda: tops.fused_glu_plain(x, jg, ju),
                                 (e, c, f))}
    for name, (k_fn, p_fn, shape) in cases.items():
        before = tbs.LAUNCHES[name]
        got, again = k_fn(), k_fn()
        want = p_fn()
        torch.cuda.synchronize()
        assert tbs.LAUNCHES[name] == before + 2, name
        assert got.shape == shape and got.dtype == dt
        assert torch.equal(got, again), name
        err = float((got.float() - want.float()).abs().max())
        assert err <= _ulp_tol(dt, want), (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [(32, 16), (8, 8)])
def test_expert_batched_kernels_small_blocks(cuda, dtype, block):
    """The FMA loops (block sides that the tensor cores do not take) run
    the expert batch too; each expert's rows equal its own plain
    product."""
    dt = getattr(torch, dtype)
    bi, bo = block
    e, c, k, n = 5, 3, 4 * bi, 8 * bo
    gen = torch.Generator().manual_seed(7)
    ps = [pack(*_random_mask_pair(gen, e, k, n, bi, bo), bi, bo, 2)
          for _ in range(2)]
    g, u = (PackedBCSC(p.blocks.to(cuda, dt), p.idx.to(cuda), p.kb)
            for p in ps)
    x = torch.randn(e, c, k, generator=gen).to(cuda, dt)
    y, hh = tbs.bspmm(x, g), tbs.fused_glu(x, g, u)
    for i in range(e):
        yi = tops.bspmm_plain(x[i], g.layer(i))
        hi = tops.fused_glu_plain(x[i], g.layer(i), u.layer(i))
        assert float((y[i].float() - yi.float()).abs().max()) <= _ulp_tol(
            dt, yi)
        assert float((hh[i].float() - hi.float()).abs().max()) <= _ulp_tol(
            dt, hi)


def _random_mask_pair(gen, e, k, n, bi, bo):
    w = torch.randn(e, k, n, generator=gen) / k ** 0.5
    m = topk.topk_mask_per_col(torch.rand(e, k // bi, n // bo,
                                          generator=gen), 2)
    return topk.apply_block_mask(w, m, bi, bo), m


@pytest.mark.gpu
def test_expert_batched_launchers_check_their_operands(cuda):
    gen = torch.Generator().manual_seed(1)
    p = _expert_packs(gen, 4, 256, 256, 1, torch.bfloat16, cuda)
    x = torch.randn(3, 2, 256, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one per row"):
        tbs.bspmm(x, p)                       # 3 rows of x, 4 experts
    with pytest.raises(ValueError, match="one per row"):
        tbs.bspmm(x[0].contiguous(), p)       # one matrix, 4 experts
    with pytest.raises(ValueError, match="contiguous"):
        tbs.bspmm(torch.randn(4, 2, 512, device=cuda,
                              dtype=torch.bfloat16)[..., ::2], p)


@pytest.mark.gpu
@pytest.mark.parametrize("g", list(range(9, 17)))
@pytest.mark.parametrize("qkv", ["bfloat16", "float32", "f32_over_bf16"])
@pytest.mark.parametrize("page", [(16, 128), (8, 64)])
def test_paged_flash_decode_up_to_16_query_heads(cuda, g, qkv, page):
    """G in 9..16 query heads per kv head (qwen3-moe: 64 over 4, G = 16)
    on the two-row-group layout, against the plain version, bitwise
    repeatable, masked lane zero."""
    ps, hd = page
    gen = torch.Generator().manual_seed(g)
    q4, pk, pv, bt, bias = _decode_inputs(gen, 8, 16, ps, hd, qkv, cuda,
                                          kvh=4, g=g)
    got = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=hd ** -0.5)
    again = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=hd ** -0.5)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, bt, bias,
                                        scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and not got[0].any()
    assert float((got - want).abs().max()) <= _ulp_tol(q4.dtype, want)


@pytest.mark.gpu
def test_paged_flash_decode_refuses_what_it_does_not_hold(cuda):
    """G > 16, and G > 8 at hd > 128, raise rather than compute."""
    gen = torch.Generator().manual_seed(0)
    for g, hd in ((17, 128), (32, 64), (9, 256)):
        q4, pk, pv, bt, bias = _decode_inputs(gen, 2, 2, 16, hd, "bfloat16",
                                              cuda, kvh=2, g=g)
        with pytest.raises(ValueError, match="G <= 16"):
            tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=0.1)
    q4, pk, pv, bt, bias = _decode_inputs(gen, 2, 2, 16, 256, "bfloat16",
                                          cuda, kvh=2, g=8)
    tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=0.1)   # G 8 holds


# the recurrent families' sparse MLPs at full width (configs/*.py,
# with_blast at TP = 16): rwkv6-3b's channel-mix (K, N, b_in, b_out) of
# w_in and w_out, and zamba2-1.2b's shared GLU (d_model, d_ff, block),
# one 2-D (unstacked) matrix each
RWKV6_MLP = {"w_in": (2560, 8960, 128, 16), "w_out": (8960, 2560, 16, 128)}
ZAMBA2_GLU = (2048, 8192, 128)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("weight", sorted(RWKV6_MLP))
def test_bspmm_at_the_rwkv6_channel_mix_blocks(cuda, weight, m):
    """``bspmm`` on rwkv6-3b's 128 x 16 (``w_in``) and 16 x 128
    (``w_out``) blocks at s = 0.8 in bf16, decode rows, within
    ``_ulp_tol``; one launch each."""
    k, n, bi, bo = RWKV6_MLP[weight]
    dt = torch.bfloat16
    p = _packed(5, k, n, bi, bo, 0.8, dt, cuda)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        cuda, dt)
    before = tbs.LAUNCHES["bspmm"]
    got, want = tbs.bspmm(x, p), tops.bspmm_plain(x, p)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["bspmm"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        dt, want), tbs.launch_plan(x, p).describe()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("mode", ["split", "joint"])
def test_zamba2_shared_glu_and_down_match_plain(cuda, mode, m):
    """zamba2-1.2b's unstacked shared GLU (gelu) at s = 0.8 in bf16: the
    split GLU (gate and up masks differ) or the joint one (up on gate's
    idx table), then ``bspmm`` on the down projection, within
    ``_ulp_tol``."""
    d, f, b = ZAMBA2_GLU
    dt = torch.bfloat16
    gate = _packed(6, d, f, b, b, 0.8, dt, cuda)
    if mode == "joint":
        gate = PackedBCSC(gate.blocks, gate.idx, gate.kb, joint=True)
        up = _packed(7, d, f, b, b, 0.8, dt, cuda, idx=gate.idx.cpu())
    else:
        up = _packed(7, d, f, b, b, 0.8, dt, cuda)
    down = _packed(8, f, d, b, b, 0.8, dt, cuda)
    assert gate.idx.dim() == 2 and down.idx.dim() == 2
    x = torch.randn(m, d, generator=torch.Generator().manual_seed(m)).to(
        cuda, dt)
    before = dict(tbs.LAUNCHES)
    h = tbs.fused_glu(x, gate, up, act="gelu")
    want_h = tops.fused_glu_plain(x, gate, up, "gelu")
    y, want_y = tbs.bspmm(want_h, down), tops.bspmm_plain(want_h, down)
    torch.cuda.synchronize()
    assert {k: tbs.LAUNCHES[k] - before[k] for k in before} == {
        "bspmm": 1, "fused_glu_split": int(mode == "split"),
        "fused_glu_joint": int(mode == "joint")}
    assert h.shape == (m, f) and y.shape == (m, d)
    assert float((h.float() - want_h.float()).abs().max()) <= _ulp_tol(
        dt, want_h)
    assert float((y.float() - want_y.float()).abs().max()) <= _ulp_tol(
        dt, want_y)


# whisper-large-v3's two-matrix MLP at full width (with_blast at TP = 16
# gives 128 x 64 blocks): (K, N, b_in, b_out) of w_in and w_out; M = 8 is
# a decode step's 8 lanes, M = 12000 the encoder's 8 lanes x 1500 frames
# (93 full 128-row tiles and one of 96 rows; 187 full 64-row tiles and
# one of 32)
WHISPER_MLP = {"w_in": (1280, 5120, 128, 64), "w_out": (5120, 1280, 64, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 12000])
@pytest.mark.parametrize("weight", sorted(WHISPER_MLP))
def test_bspmm_at_the_whisper_mlp_shapes(cuda, weight, m):
    """``bspmm`` on whisper's ``w_in`` and ``w_out`` at s = 0.8 in bf16,
    at decode rows and at the encoder's 12000 rows, whose last row tile
    is partial, within ``_ulp_tol``; one launch each."""
    k, n, bi, bo = WHISPER_MLP[weight]
    dt = torch.bfloat16
    p = _packed(9, k, n, bi, bo, 0.8, dt, cuda)
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(m)).to(
        cuda, dt)
    before = tbs.LAUNCHES["bspmm"]
    got, want = tbs.bspmm(x, p), tops.bspmm_plain(x, p)
    torch.cuda.synchronize()
    assert tbs.LAUNCHES["bspmm"] == before + 1
    assert got.dtype == dt and got.shape == (m, n)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(
        dt, want), tbs.launch_plan(x, p).describe()
