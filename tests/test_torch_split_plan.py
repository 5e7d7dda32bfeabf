"""The host side of the block-sparse products' CUDA launches: the split of
every visit list into a cluster's chunks (``kernels/split_plan.py``), the
transposed visit lists of ``bspmm_t`` (``TransposedPlan``) against a
numpy oracle written out with loops, the kernel and split rules, and the
build's hash over the shared headers. All of it is numpy and ints, so it
runs here; the kernels that read the plans run on the card
(``tests/test_torch_kernels_gpu.py``)."""
import math
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import topk  # noqa: E402
from repro_torch.core.packing import pack  # noqa: E402
from repro_torch.core.prune_grow import BlastSpec, initial_mask  # noqa: E402
from repro_torch.kernels import build, split_plan  # noqa: E402
from repro_torch.kernels import bspmm as tbs, bspmm_t as tbt  # noqa: E402


def _chunks(bounds, t, s):
    return [(int(bounds[t, c]), int(bounds[t, c + 1])) for c in range(s)]


@pytest.mark.parametrize("splits", range(1, split_plan.MAX_SPLITS + 1))
def test_split_bounds_cut_every_list_into_ordered_capped_chunks(splits):
    lengths = np.random.default_rng(splits).integers(0, 30, size=23)
    lengths[[0, 5]] = 0                               # empty lists
    bounds = split_plan.split_bounds(lengths, splits)
    assert bounds.shape == (23, splits + 1) and bounds.dtype == np.int32
    start = 0
    for t, n in enumerate(lengths):
        chunks = _chunks(bounds, t, splits)
        assert chunks[0][0] == start and chunks[-1][1] == start + n
        for (b0, e0), (b1, _) in zip(chunks, chunks[1:]):
            assert e0 == b1                            # contiguous, in order
        cap = math.ceil(n / splits)
        assert all(0 <= e - b <= cap for b, e in chunks)
        start += n


def _packed(case, k=1024, n=512, b=64, seed=0):
    """A balanced magnitude mask, the same with block-rows 0 and 3 never
    visited, or a global-selection mask (zero padding at idx 0)."""
    w = torch.randn(k, n, generator=torch.Generator().manual_seed(seed))
    if case == "empty_rows":
        w[:b] = 0.0
        w[3 * b:4 * b] = 0.0
    if case == "global":
        norms = topk.block_norms(w, b, b)
        mask = topk.topk_mask_global(norms, norms.numel() // 5)
    else:
        mask = initial_mask(BlastSpec(b_in=b, b_out=b, s_init=0.75), w)
    return pack(topk.apply_block_mask(w, mask, b, b), mask, b, b), mask


@pytest.mark.parametrize("case", ["balanced", "empty_rows", "global"])
def test_transposed_plan_against_a_numpy_oracle(case):
    p, mask = _packed(case)
    idx = p.idx.numpy()
    nb, nnz = idx.shape
    oracle = [[j * nnz + k for j in range(nb) for k in range(nnz)
               if idx[j, k] == r] for r in range(p.kb)]
    plan = tbt.TransposedPlan.build(p.idx, p.kb, "cpu")
    assert plan.visits.tolist() == [s for row in oracle for s in row]
    assert plan.lengths.tolist() == [len(row) for row in oracle]
    assert plan.total == nb * nnz and plan.max_len == max(map(len, oracle))
    visits = plan.visits.numpy()
    for s in range(1, split_plan.MAX_SPLITS + 1):
        bounds = plan.bounds[s - 1].numpy()
        seen = []
        for r in range(p.kb):
            listed = [int(v) for b, e in _chunks(bounds, r, s)
                      for v in visits[b:e]]
            assert listed == oracle[r]                 # (j, k) order
            cap = math.ceil(len(oracle[r]) / s)
            assert all(e - b <= cap for b, e in _chunks(bounds, r, s))
            seen += listed
        assert sorted(seen) == list(range(nb * nnz))   # every slot once
    counts = mask.sum(dim=0).numpy()                   # kept per column
    if case == "empty_rows":
        assert plan.lengths[0] == plan.lengths[3] == 0
    if case == "global":                               # padding kept, at 0
        padding = {j * nnz + k for j in range(nb)
                   for k in range(int(counts[j]), nnz)}
        assert padding and padding <= set(oracle[0])
        assert plan.max_len == plan.lengths[0]


def test_column_bounds_are_the_balanced_split_and_cached():
    b = tbs.column_bounds("cpu", 16, 13, 5)
    np.testing.assert_array_equal(
        b.numpy(), split_plan.split_bounds(np.full(16, 13), 5))
    assert tbs.column_bounds("cpu", 16, 13, 5) is b


def _choose(m, k_t, n_t, n_lists, max_len, total, dtype="bf16",
            aligned=True):
    size = 2 if dtype == "bf16" else 4
    return split_plan.choose(m, k_t, n_t, n_lists, max_len, total,
                             bf16=dtype == "bf16", a_size=size, w_size=size,
                             aligned=aligned, n_sm=132)


@pytest.mark.parametrize("m,kid", [(5, 3), (8, 3), (16, 3), (17, 4),
                                   (64, 4), (128, 5), (1024, 5)])
def test_served_shapes_take_the_tensor_core_tiles(m, kid):
    """Llama-3.2-1B's down projection (16 columns of 13 kept 128 x 128
    blocks): decode rows take the 16-row tile, split so every SM has a
    CTA; prefill and fine-tuning rows the larger tiles."""
    lp = _choose(m, 128, 128, 16, 13, 208)
    assert lp.kernel.kid == kid and 1 <= lp.splits <= 8
    tiles = 16 * math.ceil(m / lp.kernel.bm) * lp.n_split
    assert tiles * lp.splits >= 132 or lp.splits == 8


def test_other_cases_take_the_fma_loop_and_long_lists_split():
    assert _choose(8, 128, 128, 16, 13, 208, "f32").kernel.kid == 1
    assert _choose(8, 8, 8, 16, 3, 40).kernel.kid == 1        # b = 8
    assert _choose(8, 4, 8, 16, 3, 40).kernel.kid == 0        # 8-byte rows
    assert _choose(8, 128, 128, 16, 13, 208,
                   aligned=False).kernel.kid == 0
    assert _choose(128, 32, 16, 4, 3, 12).kernel.kid == 2     # 16-wide
    # M = 1024: the tiles fill the card, but a list 20x the mean (4) is
    # split until no chunk exceeds 2.5x the mean: ceil(80 / 10) = 8
    assert _choose(1024, 128, 128, 64, 4, 256).splits == 1
    assert _choose(1024, 128, 128, 64, 8, 208).splits == 1    # served down
    assert _choose(1024, 128, 128, 64, 40, 256).splits == 4
    assert _choose(1024, 128, 128, 64, 250, 256).splits == 8
    assert _choose(128, 128, 128, 64, 1, 64).splits == 1      # 1 visit each
    with pytest.raises(ValueError, match="empty"):
        _choose(0, 128, 128, 16, 13, 208)


def test_library_path_changes_with_a_shared_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = {s: build.library_path(s, csrc) for s in build.SOURCES}
    assert before == {s: build.library_path(s) for s in build.SOURCES}
    header = csrc / "bsp_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: build.library_path(s, csrc) for s in build.SOURCES}
    assert all(after[s] != before[s] for s in build.SOURCES)


@pytest.mark.parametrize("b,kvh", [(1, 8), (8, 8), (16, 8), (33, 8),
                                   (4, 2), (200, 1)])
@pytest.mark.parametrize("r", [1, 2, 3, 4, 16, 32, 100])
def test_decode_splits_cover_every_page_once_in_order(b, kvh, r):
    """Paged decode's split of the page axis: at most min(8, R) CTAs per
    (lane, kv head), the least that gives each of 132 SMs a CTA, and
    chunks that cover pages 0..R-1 exactly once, in order."""
    s = split_plan.decode_splits(b, kvh, r, 132)
    assert 1 <= s <= min(split_plan.MAX_SPLITS, r)
    assert s == min(split_plan.MAX_SPLITS, r) or b * kvh * s >= 132
    assert s == 1 or b * kvh * (s - 1) < 132
    bounds = split_plan.split_bounds([r], s)
    pages = [j for c0, c1 in _chunks(bounds, 0, s) for j in range(c0, c1)]
    assert pages == list(range(r))
    # the kernel's chunk c is [c R / S, (c + 1) R / S)
    assert [c0 for c0, _ in _chunks(bounds, 0, s)] == [
        c * r // s for c in range(s)]
    assert split_plan.decode_splits(b, kvh, r, 132) is s
    with pytest.raises(ValueError, match="empty"):
        split_plan.decode_splits(b, kvh, 0, 132)


@pytest.mark.parametrize("m", [5, 8, 128])
def test_glu_plan_takes_the_tensor_cores_for_served_bf16_shapes(m):
    """Llama-3.2-1B's W_gate / W_up (64 block-columns of 4 kept 128 x 128
    blocks): bf16 takes the tensor cores; f32, f32 X over bf16 weights,
    b = 8 blocks and unaligned rows take the FMA loop."""
    def glu(dtype="bf16", w_size=None, aligned=True, b=128, lists=64):
        a_size = 2 if dtype == "bf16" else 4
        return split_plan.choose(m, b, b, lists, 4, 4 * lists,
                                 bf16=dtype == "bf16" and w_size is None,
                                 a_size=a_size, w_size=w_size or a_size,
                                 aligned=aligned, n_sm=132, glu=True)
    assert glu().kernel.kid == (3 if m <= 16 else 5)
    assert glu("f32").kernel.kid == 1
    assert glu("f32", w_size=2).kernel.kid == 1
    assert glu(b=8).kernel.kid == 1
    assert glu(aligned=False).kernel.kid == 0
    assert glu(b=16, lists=16).kernel.kid >= 2


@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("sizes", [(2, 2), (4, 4), (4, 2)])
def test_every_tile_fits_one_cta_in_227_kb(glu, sizes):
    """Ring stages (two operand pairs each for the GLU) and the f32
    partial tiles that reuse them fit one CTA's shared memory; at the
    decode tile the GLU's 4-stage ring is 182 KB, one CTA to an SM."""
    a_size, w_size = sizes
    for k in split_plan.KERNELS:
        if k.kid >= 2 and sizes != (2, 2):
            continue                       # tensor cores take bf16 only
        smem = split_plan.smem_bytes(k, glu=glu, a_size=a_size,
                                     w_size=w_size)
        assert 0 < smem <= split_plan.MAX_SMEM, k
    decode = split_plan.KERNELS[3]
    assert split_plan.smem_bytes(decode, glu=True, a_size=2,
                                 w_size=2) == 4 * 2 * 2 * (16 * 136 + 128 * 72)
    assert split_plan.ctas_per_sm(split_plan.smem_bytes(
        decode, glu=True, a_size=2, w_size=2)) == 1
    assert split_plan.ctas_per_sm(split_plan.smem_bytes(
        decode, glu=False, a_size=2, w_size=2)) == 2


@pytest.mark.parametrize("m", [5, 8, 128])
def test_glu_split_stays_within_one_wave(m):
    """A GLU tile that holds one CTA to an SM is split no further than one
    wave of CTAs fills (128 decode tiles: unsplit, not two waves); the
    same shape as bspmm splits to give every SM a CTA."""
    kw = dict(bf16=True, a_size=2, w_size=2, aligned=True, n_sm=132)
    glu = split_plan.choose(m, 128, 128, 64, 4, 256, glu=True, **kw)
    smem = split_plan.smem_bytes(glu.kernel, glu=True, a_size=2, w_size=2)
    tiles = 64 * math.ceil(m / glu.kernel.bm) * glu.n_split
    assert tiles * glu.splits <= 132 * split_plan.ctas_per_sm(smem)
    plain = split_plan.choose(m, 128, 128, 64, 4, 256, **kw)
    assert plain.kernel == glu.kernel
    assert tiles * plain.splits >= 132 or plain.splits == 4
