"""Host-side plan of the block-sparse products' CUDA launches
(``csrc/bsp_mma.cuh``): which main loop runs, and how each output tile's
visit list is split across the CTAs of a cluster; and the split of paged
decode's page axis (``csrc/paged_attention.cu``, ``decode_splits``).

A *visit list* is the ordered run of kept blocks that feed one output
block: for ``bspmm`` block-column j's nnz slots, for ``bspmm_t`` the slots
with ``idx == r`` of output block-row r (``bspmm_t.transposed_table``).
The lists sit back to back in one flat array; ``split_bounds`` cuts list
t into ``splits`` contiguous chunks ``[bounds[t, c], bounds[t, c + 1])``
of near-equal length (at most ``ceil(len / splits)``), in list order, so
every slot lands in exactly one chunk and an empty list stays empty. The
chunks' f32 partials are summed in chunk order inside the kernel.

``choose`` picks the kernel and the split from shapes, dtypes and
alignment alone, before the launch (never by a failure). The rules, each
the best of the measured alternatives on the H100 (PERF.md):
bf16 with block sides that are multiples of 16 takes the tensor cores,
in the 16-row tile at M <= 16 (decode), the 128 x 128 tile above 64 rows
and the 64 x 64 one between or when the block is 64 wide; everything
else takes the f32 FMA loop. The split is the least that gives every SM
a CTA, raised until no chunk is longer than 2.5 times the mean list
(global-selection padding makes one list long; a larger bound left the
served global case 2.6x its balanced twin, a smaller one splits the
balanced down shape at M = 1024, which is slower), at most 8 and at most
the longest list. The fused GLU (``glu=True``) stages two weight tiles
per visit beside two X tiles (split) or one (``joint=True``: gate and up
share one idx table), and keeps two f32 partial tiles, so its tiles take
more shared memory (``smem_bytes``); where that leaves one CTA to an SM,
the SM-filling part of the split is capped at one wave of CTAs.
Everything here is numpy and ints; the wrappers cache the device copies.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

MAX_SPLITS = 8   # portable thread-block-cluster size
# H100: shared memory of one CTA at most, and of one SM (bsp::MAX_SMEM;
# the runtime reserves 1 KB of an SM's share per CTA)
MAX_SMEM = 232448
SM_SMEM, CTA_RESERVED = 233472, 1024


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    kid: int          # id passed to bsp::run
    name: str
    bm: int           # rows of an output tile
    bn: int           # output-block columns of a tile (0: min(64, N_t))
    bk: int           # K chunk of one ring stage (0: min(16, K_t))
    stages: int       # ring stages


KERNELS = (
    KernelSpec(0, "fma", 64, 0, 0, 3),
    KernelSpec(1, "fma_cp_async", 64, 0, 0, 3),
    KernelSpec(2, "mma_32x16x16", 32, 16, 16, 4),
    KernelSpec(3, "mma_16x64x128", 16, 64, 128, 4),
    KernelSpec(4, "mma_64x64x64", 64, 64, 64, 4),
    KernelSpec(5, "mma_128x128x64", 128, 128, 64, 3),
)
FMA_BN, FMA_BK = 64, 16
# the small-M tile serves decode: at M <= 16 one 16-row mma tile holds
# every row, and the work is bound by the weight bytes
SMALL_M = 16
LARGE_M = 64
CHUNK_OVER_MEAN = 2.5   # longest chunk / mean list length, at most


@dataclasses.dataclass(frozen=True)
class Launch:
    kernel: KernelSpec
    splits: int       # CTAs per output tile (cluster size)
    bn: int           # tile width actually used
    bk: int           # K chunk actually used
    n_split: int      # tiles across one output block's width

    def describe(self) -> str:
        return f"{self.kernel.name}/split{self.splits}x{self.n_split}"


def split_bounds(lengths, splits: int) -> np.ndarray:
    """(n_lists, splits + 1) int32: chunk c of list t is
    ``[bounds[t, c], bounds[t, c + 1])`` of the flat visit array, where
    the lists lie back to back from 0, list t ``lengths[t]`` long."""
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits {splits} outside [1, {MAX_SPLITS}]")
    lengths = np.asarray(lengths, np.int64)
    starts = np.cumsum(lengths) - lengths
    c = np.arange(splits + 1, dtype=np.int64)
    return (starts[:, None]
            + (c[None, :] * lengths[:, None]) // splits).astype(np.int32)


def smem_bytes(k: KernelSpec, *, glu: bool, a_size: int, w_size: int,
               joint: bool = False) -> int:
    """Dynamic shared memory of one forward CTA of kernel ``k``
    (``bsp::Tc`` / ``bsp::Fma`` with FWD: the ring, or the f32 partial
    tiles that reuse it, whichever is larger). ``glu``: two weight tiles
    per stage and two partials; ``joint``: the GLU's one X tile per
    stage (else two)."""
    n_w = 2 if glu else 1
    n_x = 2 if glu and not joint else 1
    if k.kid < 2:      # Fma: [64][16 + pad] A, [16][64 + pad] B, 64 x 68
        a_b = a_size * k.bm * (FMA_BK + 16 // a_size)
        w_b = w_size * FMA_BK * (FMA_BN + 16 // w_size)
        red = 4 * n_w * k.bm * (FMA_BN + 4)
    else:              # Tc (bf16): [bm][bk + 8] A, [bk][bn + 8] B
        a_b = 2 * k.bm * (k.bk + 8)
        w_b = 2 * k.bk * (k.bn + 8)
        red = 4 * n_w * k.bm * (k.bn + 8)
    return max(k.stages * (n_x * a_b + n_w * w_b), red)


def ctas_per_sm(smem: int) -> int:
    """How many CTAs of ``smem`` bytes of shared memory one SM holds."""
    return max(1, SM_SMEM // (smem + CTA_RESERVED))


def pick_kernel(m: int, k_t: int, n_t: int, *, bf16: bool, a_size: int,
                w_size: int, aligned: bool) -> KernelSpec:
    """The main loop for an (M x K_t) A tile against blocks whose output
    width is N_t (see the module note)."""
    if bf16 and aligned:
        def fits(k):
            return n_t % k.bn == 0 and k_t % k.bk == 0
        small, mid, large = KERNELS[3], KERNELS[4], KERNELS[5]
        if m <= SMALL_M and fits(small):
            return small
        if m > LARGE_M and fits(large):
            return large
        if fits(mid):
            return mid
        if fits(KERNELS[2]):
            return KERNELS[2]
    return KERNELS[1] if fma_vec_ok(k_t, n_t, a_size, w_size, aligned) \
        else KERNELS[0]


def fma_vec_ok(k_t: int, n_t: int, a_size: int, w_size: int,
               aligned: bool) -> bool:
    """Whether the FMA loop may stage with 16-byte copies: every row it
    copies starts and ends on 16 bytes."""
    bn, bk = min(FMA_BN, n_t), min(FMA_BK, k_t)
    return (aligned and k_t % bk == 0 and (bk * a_size) % 16 == 0
            and (bk * w_size) % 16 == 0 and (bn * w_size) % 16 == 0)


@functools.cache
def choose(m: int, k_t: int, n_t: int, n_lists: int, max_len: int,
           total_len: int, *, bf16: bool, a_size: int, w_size: int,
           aligned: bool, n_sm: int, glu: bool = False,
           joint: bool = False) -> Launch:
    """The launch for an (M x K_t) A tile against blocks whose output
    width is N_t, over ``n_lists`` visit lists of at most ``max_len``
    visits and ``total_len`` in all. ``aligned``: every base pointer and
    row stride that a 16-byte copy touches is 16-byte aligned. ``bf16``:
    both operands bf16. ``glu``: the fused GLU (two weight tiles per
    visit); ``joint``: its one X tile per visit (one shared idx table).
    Cached: a served shape is planned once."""
    if m < 1 or k_t < 1 or n_t < 1 or n_lists < 1:
        raise ValueError(f"empty product: M={m}, K_t={k_t}, N_t={n_t}, "
                         f"{n_lists} lists")
    k = pick_kernel(m, k_t, n_t, bf16=bf16, a_size=a_size, w_size=w_size,
                    aligned=aligned)
    bn = k.bn or min(FMA_BN, n_t)
    bk = k.bk or min(FMA_BK, k_t)
    tiles = n_lists * math.ceil(m / k.bm) * (n_t // bn)
    mean = max(total_len / n_lists, 1.0)
    fill = math.ceil(n_sm / tiles)
    if glu:    # no second wave: one CTA to an SM at the decode tile
        occ = ctas_per_sm(smem_bytes(k, glu=True, a_size=a_size,
                                     w_size=w_size, joint=joint))
        fill = min(fill, max(1, n_sm * occ // tiles))
    splits = max(fill, math.ceil(max_len / (CHUNK_OVER_MEAN * mean)))
    splits = max(1, min(MAX_SPLITS, splits, max_len))
    return Launch(k, splits, bn, bk, n_t // bn)


@functools.cache
def decode_splits(b: int, kvh: int, r: int, n_sm: int) -> int:
    """CTAs per (lane, kv head) of paged decode over R pages: the least
    that gives every SM a CTA, at most 8 (one portable cluster) and at
    most R. CTA c takes pages ``split_bounds([R], S)[0, c:c + 2]``, the
    contiguous range [c R / S, (c + 1) R / S)."""
    if b < 1 or kvh < 1 or r < 1:
        raise ValueError(f"empty decode: B={b}, KV={kvh}, R={r}")
    return max(1, min(MAX_SPLITS, r, math.ceil(n_sm / (b * kvh))))
