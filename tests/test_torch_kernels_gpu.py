"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every case is marked ``gpu`` and skips on a host without one. The
file needs no JAX, so it runs on a GPU host that has none (``--noconftest``
skips tests/conftest.py, which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: f32 1e-4 of the output's magnitude (only the summation order
differs); bf16 2**-7 of it (each side rounds an f32 result once, and the
plain fused GLU also rounds gate and up before the activation, so the
outputs may differ by about one bf16 ulp).
"""
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
        table = tbt.device_table(p.idx, p.kb)
        before = tbt.LAUNCHES["bspmm_t"]
        got = tops.bspmm_t(dy, p, table)
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
    table = tbt.device_table(p.idx, p.kb)
    with pytest.raises(ValueError, match="contiguous"):
        tbt.bspmm_t(dy[:, ::2], p, table)
    with pytest.raises(TypeError, match="int32"):
        tbt.bspmm_t(dy[:, :256].contiguous(), p, table.long())
    with pytest.raises(TypeError, match="not supported"):
        tbt.bspmm_t(dy[:, :256].contiguous().half(), p, table)
    with pytest.raises(ValueError, match="N="):
        tbt.bspmm_t(dy, p, table)
