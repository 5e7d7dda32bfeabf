"""Tensor-parallel serving's kernels on the card (marked ``gpu``; skips
without one). Needs no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_dist_gpu.py

Each kernel of the tensor-parallel path at a rank's local shapes of
Llama-3.2-1B (s = 0.8, 128 x 128 blocks, bf16) at tp 2 and tp 4, every
rank: the split and joint fused GLU on the rank's gate/up column-blocks
(32 or 16 of 64), ``bspmm`` on its share of the down pack's kept blocks
(13 a column, padded with zero blocks to 14 or 16) over the all-gathered
(M, 8192) rows, and paged decode on its 16 or 8 query heads over 4 or 2
kv heads; each held against its plain version within ``chip_smoke.py``'s
``ulp_tol``. rwkv6-3b's channel-mix packs at tp 2 (s = 0.8): ``bspmm`` on
each rank's ``w_in`` block-columns (128 x 16 blocks, 280 of 560) and on
its share of ``w_out``'s kept blocks (16 x 128) over the all-gathered
(M, 8960) rows. Then a tiny tensor-parallel engine run, two ranks sharing
the card over gloo (``_torch_dist_rank.py``), whose streams must equal a
single-rank run's (a divergence only at a near-tie) and whose ranks must
launch the split GLU, ``bspmm`` and paged decode.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_rank as ranks  # noqa: E402
from repro_torch.configs.paper_models import (LLAMA32_1B,  # noqa: E402
                                              LLAMA32_1B_SMOKE)
from repro_torch.core import sparse_mlp as sm  # noqa: E402
from repro_torch.core.packing import PackedBCSC, pack  # noqa: E402
from repro_torch.core.prune_grow import initial_mask, prune_weight  # noqa: E402
from repro_torch.distributed.context import DistContext, Mesh  # noqa: E402
from repro_torch.kernels import bspmm as tbs, ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import attention, registry  # noqa: E402
from repro_torch.serving import engine as tengine, export  # noqa: E402

NEAR_TIE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ulp_tol(ref):
    """chip_smoke.py's ulp_tol for bf16: two bf16 ulps of the output's
    magnitude."""
    mag = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (math.floor(math.log2(max(mag, 1e-30))) - 7)


def _pack(seed, k, n, bi, bo, s, dev, mask=None):
    """A (k, n) weight pruned at ``s`` (or to ``mask``), packed in bf16."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(k, n, generator=gen) / k ** 0.5
    spec = dataclasses.replace(LLAMA32_1B.blast, b_in=bi, b_out=bo,
                               s_init=s)
    m = initial_mask(spec, w) if mask is None else mask
    p = pack(prune_weight(spec, w, m), m, bi, bo)
    return PackedBCSC(p.blocks.to(dev, torch.bfloat16), p.idx.to(dev), p.kb,
                      joint=mask is not None), m


@pytest.fixture(scope="module")
def llama_mlp():
    """Layer-shaped packs of Llama-3.2-1B at s = 0.8 on the card: gate,
    up (its own mask), joint up (gate's mask) and down."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    d, f, b = LLAMA32_1B.d_model, LLAMA32_1B.d_ff, LLAMA32_1B.blast.b_in
    gate, gmask = _pack(1, d, f, b, b, 0.8, dev)
    up, _ = _pack(2, d, f, b, b, 0.8, dev)
    jup, _ = _pack(3, d, f, b, b, 0.8, dev, mask=gmask)
    down, _ = _pack(4, f, d, b, b, 0.8, dev)
    return dict(w_gate=gate, w_up=up, j_gate=dataclasses.replace(
        gate, joint=True), j_up=jup, w_down=down)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 64])
def test_rwkv6_channel_mix_at_rank_shapes(cuda, m):
    """rwkv6-3b's ``w_in`` (2560 x 8960, 128 x 16 blocks) and ``w_out``
    (16 x 128) at s = 0.8, each rank's shard at tp 2 (``shard_pack``),
    through ``bspmm`` against its plain twin."""
    from repro_torch.configs import get_config
    cfg = get_config("rwkv6-3b")
    d, f = cfg.d_model, cfg.d_ff
    bi, bo = cfg.blast.b_in, cfg.blast.b_out
    w_in, _ = _pack(5, d, f, bi, bo, 0.8, cuda)
    w_out, _ = _pack(6, f, d, bo, bi, 0.8, cuda)
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, d, generator=gen).to(cuda, torch.bfloat16)
    h = torch.randn(m, f, generator=gen).to(cuda, torch.bfloat16)
    for r in range(2):
        mesh = Mesh(("data", "model"), (1, 2), r)
        lin = export.shard_pack(w_in, "layers/mlp/w_in", mesh)
        lout = export.shard_pack(w_out, "layers/mlp/w_out", mesh)
        assert lin.nb == w_in.nb // 2 and not lin.partial
        assert lout.partial and lout.nnz == -(-w_out.nnz // 2)
        before = tbs.LAUNCHES["bspmm"]
        cases = [(tbs.bspmm(x, lin), tops.bspmm_plain(x, lin)),
                 (tbs.bspmm(h, lout), tops.bspmm_plain(h, lout))]
        torch.cuda.synchronize()
        for got, want in cases:
            assert got.shape == want.shape
            assert float((got.float() - want.float()).abs().max()) <= \
                _ulp_tol(want), (r, m)
        assert tbs.LAUNCHES["bspmm"] - before == 2


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("tp", [2, 4])
def test_mlp_kernels_at_rank_shapes(cuda, llama_mlp, tp, m):
    assert llama_mlp["w_down"].nnz == 13
    gen = torch.Generator().manual_seed(tp * 100 + m)
    x = torch.randn(m, LLAMA32_1B.d_model, generator=gen).to(
        cuda, torch.bfloat16)
    h = torch.randn(m, LLAMA32_1B.d_ff, generator=gen).to(
        cuda, torch.bfloat16)
    for r in range(tp):
        mesh = Mesh(("data", "model"), (1, tp), r)
        loc = {k: export.shard_pack(p, "layers/mlp/" + (
            "w_down" if k == "w_down" else "w_gate"), mesh)
            for k, p in llama_mlp.items()}
        down = loc["w_down"]
        assert down.partial and down.nnz == -(-13 // tp)
        assert loc["w_gate"].nb == 64 // tp and loc["j_up"].joint
        before = dict(tbs.LAUNCHES)
        cases = [
            (tbs.bspmm(h, down), tops.bspmm_plain(h, down)),
            (tbs.fused_glu(x, loc["w_gate"], loc["w_up"]),
             tops.fused_glu_plain(x, loc["w_gate"], loc["w_up"])),
            (tbs.fused_glu(x, loc["j_gate"], loc["j_up"]),
             tops.fused_glu_plain(x, loc["j_gate"], loc["j_up"]))]
        torch.cuda.synchronize()
        for got, want in cases:
            assert got.shape == want.shape
            assert float((got.float() - want.float()).abs().max()) <= \
                _ulp_tol(want), (tp, r, m)
        assert {k: tbs.LAUNCHES[k] - before[k] for k in before} == {
            "bspmm": 1, "fused_glu_split": 1, "fused_glu_joint": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_decode_at_rank_heads(cuda, tp):
    """B = 8 lanes over R = 16 pages of 16 at the rank's heads."""
    _, hl, _, kvl = attention.local_heads(
        LLAMA32_1B, DistContext(Mesh(("data", "model"), (1, tp), tp - 1)))
    assert (hl, kvl) == (32 // tp, 8 // tp)
    gen = torch.Generator().manual_seed(tp)
    b, r, ps, n_pages, hd = 8, 16, 16, 256, LLAMA32_1B.head_dim
    q4 = torch.randn(b, kvl, hl // kvl, hd, generator=gen).to(
        cuda, torch.bfloat16)
    pk, pv = (torch.randn(n_pages, ps, kvl, hd, generator=gen).to(
        cuda, torch.bfloat16) for _ in range(2))
    bt = torch.randperm(n_pages, generator=gen)[:b * r].reshape(b, r).to(
        cuda, torch.int32)
    lens = torch.randint(1, r * ps + 1, (b,), generator=gen).to(cuda)
    slots = torch.arange(r * ps, device=cuda)[None].expand(b, -1)
    bias = tpa.mask_bias((lens - 1)[:, None], slots, 0).contiguous()
    scale = 1.0 / math.sqrt(hd)
    got = tpa.paged_flash_decode(q4, pk, pv, bt, bias, scale=scale,
                                 softcap=0.0)
    want = tpa.paged_flash_decode_plain(q4, pk, pv, bt, bias, scale=scale,
                                        softcap=0.0)
    assert float((got.float() - want.float()).abs().max()) <= _ulp_tol(want)


def _smoke_packed(dev):
    cfg = LLAMA32_1B_SMOKE
    params = registry.init_params(cfg, 0, device=dev)
    spec = dataclasses.replace(cfg.blast, s_init=0.7, s_max=0.7)
    masks = {}
    for path in registry.sparse_paths(cfg):
        bi, bo = sm.block_dims_for(spec, path)
        masks[path] = initial_mask(
            dataclasses.replace(spec, b_in=bi, b_out=bo),
            sm.get_path(params, path))
    return cfg, export.pack_params(cfg, params, masks, dtype=torch.float32)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, PackedBCSC):
        return types.SimpleNamespace(blocks=tree.blocks.cpu().numpy(),
                                     idx=tree.idx.cpu().numpy(),
                                     kb=tree.kb, joint=tree.joint)
    return tree.cpu().numpy()


def _margin(cfg, params, seq, dev):
    from repro_torch.models import transformer
    pages = -(-len(seq) // 4)
    logits, _ = transformer.paged_prefill_chunk(
        cfg, params, transformer.init_paged_cache(cfg, pages, 4, device=dev),
        torch.as_tensor(seq, device=dev)[None], 0,
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.arange(pages, dtype=torch.int32, device=dev)[None],
        read_pages=pages)
    top2 = torch.topk(logits[0, -1], 2).values
    return float(top2[0] - top2[1])


@pytest.mark.gpu
def test_two_ranks_on_one_card_serve_like_one(cuda, tmp_path):
    cfg, packed = _smoke_packed(cuda)
    rng = np.random.default_rng(0)
    engine_kw = dict(max_batch=2, max_len=32, prefill_chunk=8, page_size=8,
                     slab_k=4)
    spec = dict(cfg=cfg, params=_numpy(packed), engine=engine_kw, new=6,
                modes=("phased", "mixed"),
                equal=rng.integers(1, cfg.vocab_size, (2, 8)).astype(
                    np.int32),
                ragged=[rng.integers(1, cfg.vocab_size, int(n)).astype(
                    np.int32) for n in (5, 9, 13)],
                prefix_prompts=[], logit_prompts=[])
    procs = ranks.start(str(tmp_path), 2, {"smoke": spec}, device="cuda")
    got = ranks.collect(str(tmp_path), procs)
    with torch.inference_mode():
        for mode, kw in (("phased", {}), ("mixed", {"mixed": True})):
            want, _ = tengine.generate(cfg, packed, spec["ragged"],
                                       max_new_tokens=6, device=cuda,
                                       **engine_kw, **kw)
            for rank in got:
                run = rank["smoke"][mode]
                assert run["digest"] == got[0]["smoke"][mode]["digest"]
                for p, g, w in zip(spec["ragged"], run["streams"], want):
                    if np.array_equal(g, w):
                        continue
                    t = int(np.argmax(g != w))
                    assert _margin(cfg, packed, w[:t], cuda) < NEAR_TIE
            for k in ("bspmm", "fused_glu_split", "paged_flash_decode"):
                assert all(r["smoke"]["launches"][k] > 0 for r in got), k
