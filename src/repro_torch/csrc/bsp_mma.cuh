// Shared device code of the two block-sparse products over packed balanced
// BCSC (core/packing.py), hand-written for Hopper (sm_90a):
//
//   FWD = true   bspmm      Y  = X  W                  (csrc/bspmm.cu)
//   FWD = true,  fused_glu  H  = act(X Wg) * (X Wu)    (csrc/bspmm.cu;
//   G = SPLIT_GLU / JOINT_GLU  two idx tables / one shared idx table)
//   FWD = false  bspmm_t    dX = dY W^T                (csrc/bspmm_t.cu)
//
// W is blocks (Nb, nnz, b_in, b_out) row-major plus idx (Nb, nnz), the
// block-row of each kept block. Both products are one loop over the kept
// blocks that feed an output tile: BM rows x BN columns of one output
// block (b_out wide for bspmm, b_in wide for bspmm_t). The loop's "visit
// list" is, for bspmm, block-column j's nnz slots in k order (A = the X
// tile at block-row idx); for bspmm_t, the slots j * nnz + k with
// idx == r in (j, k) order, from the host-built transposed table (A = the
// dY tile at block-column j; B = the block's transpose).
//
// Visit lists are split across the CTAs of a thread-block cluster. The
// host (kernels/split_plan.py) cuts every list into S <= 8 contiguous
// chunks (bounds (n_lists, S + 1), offsets into the visit array), and the
// grid is (S, n_lists * n_split, batch * ceil(M / BM)) with cluster
// (S, 1, 1) (batch > 1: the expert-batched forward, Args::batch): the
// S CTAs of one output tile form one cluster, each sums its chunk in f32
// registers, parks the partial tile in its shared memory, and after a
// cluster barrier every CTA sums a slice of the tile over the S partials
// in rank order 0..S-1 through distributed shared memory, rounds once to
// the output type and stores it. So one launch, no workspace in device
// memory, no atomics, and the result is bitwise the same run to run. (A
// workspace pass would cost a second launch, about as long as the whole
// decode-shape kernel, and f32 partials in device memory.) An empty chunk
// contributes zeros, so a row no kept block visits writes zeros; global-
// selection padding (zero blocks at idx 0) is visited like any block, so
// it adds exact zeros. Rows past M are zero-filled on load and not stored.
//
// GLU modes (the fused GLU, G = SPLIT_GLU or JOINT_GLU): the visit list
// of block-column j is its nnz slots, as for bspmm, and every visit feeds
// two f32 accumulator sets, gate and up. The split GLU (gate and up
// pruned apart, two idx tables) stages two operand pairs into one ring
// stage, the X tile at idx_gate[slot] with the gate block and the X tile
// at idx_up[slot] with the up block. The joint GLU (one idx table shared
// by gate and up, core/packing.py::mark_joint) stages the X tile at
// idx[slot] once, beside both blocks, and both main loops read each
// k-step of it once for the two products, as the TPU kernel DMAs its X
// tile once per step. Each accumulator sums the split kernel's products
// (idx_up = idx) in the same order, so the two modes agree bitwise. The
// cluster reduction sums the gate partials and the up partials, each in
// rank order, and only then applies act(g) * u in f32 and rounds once to
// X's type: the TPU kernel's epilogue (activation on the f32 sums). So
// the (M, d_ff) gate and up products never reach device memory, and
// splitting a column's visits over a cluster stays exact. The partial
// buffer doubles and a stage grows by one operand pair (split) or one
// weight tile (joint); every tile still fits one CTA's 227 KB
// (static_assert below). The 16 x 64 x 128 decode tile's 4-stage ring
// (182 KB split, 165 KB joint) leaves one CTA to an SM
// (kernels/split_plan.py plans for it).
//
// Two main loops share that plan and epilogue:
//  * tc_kernel (bf16 x bf16, block sides multiples of 16): mma.sync
//    m16n8k16 bf16 with f32 accumulators, fragments by ldmatrix (.trans for
//    bspmm's row-major B, plain for bspmm_t's W^T), fed by a ring of
//    STAGES shared-memory stages that 16-byte cp.async fills STAGES - 1
//    steps ahead, so the next blocks' loads are in flight while the current
//    one is multiplied. Rows of every stage are padded by 16 bytes, which
//    makes ldmatrix conflict-free.
//  * fma_kernel (f32 x f32, f32 x bf16, and block shapes the tensor-core
//    loop does not take, e.g. b = 8): full f32 arithmetic (no TF32), 4 x 4
//    register tiles per thread, the same ring (16-byte cp.async when the
//    layout allows, else element loads into the same ring).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace bsp {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLITS = 8;  // portable cluster size

struct Args {
  const void* a;       // X (M, K) or dY (M, N), row-major
  const void* w;       // blocks (Nb, nnz, b_in, b_out)
  const int* idx;      // (Nb * nnz) block-row of each slot
  const int* visits;   // bspmm_t: slots by output block-row; bspmm: null
  const int* bounds;   // (n_lists, S + 1) chunk starts into the visits
  void* out;           // Y (M, Nb * b_out) or dX (M, Kb * b_in)
  int M, lda, ldo, nnz, b_in, b_out;
  int n_split;         // output-width tiles per output block
  int bn, bk;          // fma_kernel only: tile width, K chunk
  // GLU modes only: the up blocks, their idx table (split GLU only), the
  // activation id
  const void* w2 = nullptr;
  const int* idx2 = nullptr;
  int act = 0;
  // the expert-batched forward: `batch` products in one launch, X (batch,
  // M, K), blocks (batch, Nb, nnz, b_in, b_out), idx (batch, Nb, nnz) and
  // Y (batch, M, N), each contiguous. Matrix e's rows are e * M + [0, M)
  // of X and Y seen as (batch * M)-row matrices, and its slots e * Nb *
  // nnz + [0, Nb * nnz) of blocks and idx seen as one pack of batch * Nb
  // columns, so one set of chunk bounds serves every matrix.
  int batch = 1;
};

// The forward product's GLU mode (kernels/split_plan.py: glu, joint).
enum Glu : int { NO_GLU = 0, SPLIT_GLU = 1, JOINT_GLU = 2 };

// Largest dynamic shared memory of one CTA on an H100 (227 KB).
constexpr size_t MAX_SMEM = 232448;

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0 silu, 1 gelu (tanh approximation), 2 relu: kernels/bspmm.py ACT_IDS
__device__ __forceinline__ float act_fn(int act, float g) {
  if (act == 0) return g / (1.0f + expf(-g));
  if (act == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.0f);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype does
}
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ------------------------------------------------------------ the plan
// Where visit v of this CTA reads: its slot, A's first column and W's
// block for operand pair op (1: the GLU's up pair; the joint GLU reads
// A for pair 0 only).
template <bool FWD>
__device__ __forceinline__ int slot_of(const Args& a, int v) {
  return FWD ? v : __ldg(a.visits + v);
}
template <bool FWD>
__device__ __forceinline__ int a_col(const Args& a, int slot, int op) {
  return FWD ? __ldg((op ? a.idx2 : a.idx) + slot) * a.b_in
             : (slot / a.nnz) * a.b_out;
}
template <typename TW>
__device__ __forceinline__ const TW* w_block(const Args& a, int slot,
                                             int op) {
  return static_cast<const TW*>(op ? a.w2 : a.w) +
         static_cast<size_t>(slot) * a.b_in * a.b_out;
}

// The first row tile of this CTA, and with BAT (the expert-batched launch,
// batch > 1) the matrix it works on: grid z then runs over batch * ceil(M
// / bm) tiles, matrix by matrix, and row0 = e * M is matrix e's first row
// of X and Y, sbase = e * Nb * nnz its first slot (FWD only: bspmm_t has
// batch 1). A single matrix takes the BAT = false instantiation, whose
// code is the unbatched kernel's: the batch costs it nothing.
template <bool BAT>
__device__ __forceinline__ void batch_tile(const Args& a, int bm, int& m0,
                                           int& row0, int& sbase) {
  if constexpr (BAT) {
    const int mt = (a.M + bm - 1) / bm;
    const int e = static_cast<int>(blockIdx.z) / mt;
    m0 = (static_cast<int>(blockIdx.z) % mt) * bm;
    row0 = e * a.M;
    sbase = e * (a.ldo / a.b_out) * a.nnz;
  } else {
    m0 = static_cast<int>(blockIdx.z) * bm;
    row0 = sbase = 0;
  }
}

// ------------------------------------------------------------ epilogue
// red: this CTA's (BM x BN) f32 partial, row stride ldr, in shared memory
// (GLU: the gate partial, then the up partial bm * ldr further on). Every
// CTA of the cluster sums its slice of the tile over the S partials in
// rank order (GLU: gate and up apart, then act(g) * u) and stores it,
// rounded once; VW elements at a time.
template <typename TO, int VW, bool GLU>
__device__ __forceinline__ void cluster_reduce_store(const Args& a, float* red,
                                                     int ldr, int bm, int bn,
                                                     int tile_col, int m0,
                                                     int row0, int tid,
                                                     int nt) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial is in place
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per_row = bn / VW;
  const int G = bm * per_row;
  const int g1 = (rank + 1) * G / S;
  const int up = bm * ldr;
  TO* out = static_cast<TO*>(a.out);
  for (int g = rank * G / S + tid; g < g1; g += nt) {
    const int r = g / per_row, c = (g % per_row) * VW, row = m0 + r;
    if (row >= a.M) continue;
    TO* dst = out + static_cast<size_t>(row0 + row) * a.ldo + tile_col + c;
    if constexpr (VW == 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f), u = s;
      for (int q = 0; q < S; ++q) {
        const float* p = cluster.map_shared_rank(red, q) + r * ldr + c;
        const float4 v = *reinterpret_cast<const float4*>(p);
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
        if constexpr (GLU) {
          const float4 w = *reinterpret_cast<const float4*>(p + up);
          u.x += w.x, u.y += w.y, u.z += w.z, u.w += w.w;
        }
      }
      if constexpr (GLU) {
        s = make_float4(act_fn(a.act, s.x) * u.x, act_fn(a.act, s.y) * u.y,
                        act_fn(a.act, s.z) * u.z, act_fn(a.act, s.w) * u.w);
      }
      put4(dst, s);
    } else {
      float s = 0.f, u = 0.f;
      for (int q = 0; q < S; ++q) {
        s += cluster.map_shared_rank(red, q)[r * ldr + c];
        if constexpr (GLU) u += cluster.map_shared_rank(red, q)[up + r * ldr + c];
      }
      if constexpr (GLU) s = act_fn(a.act, s) * u;
      put(dst, s);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// ------------------------------------------------------------ tensor cores
// A stage holds NA X tiles and NOP weight tiles: [A0 B0] (bspmm, bspmm_t),
// [A0 B0 A1 B1] (split GLU), [A B0 B1] (joint GLU). X tile a feeds the
// weight tiles a, a + NA, ... < NOP (joint: the one X tile feeds both).
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool FWD, Glu G>
struct Tc {
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = BM / WM, WTN = BN / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;
  static constexpr int NOP = G ? 2 : 1;                 // weight tiles
  static constexpr int NA = G == JOINT_GLU ? 1 : NOP;   // X tiles
  static constexpr int LDA = BK + 8;                    // A tile [BM][LDA]
  static constexpr int B_ROWS = FWD ? BK : BN;          // FWD: [k][n]
  static constexpr int B_COLS = FWD ? BN : BK;          // else [n][k]
  static constexpr int LDB = B_COLS + 8;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = B_ROWS * LDB;
  // X tile a at a * A_STEP, weight tile op at op * B_STEP + A_ELEMS
  static constexpr int A_STEP = A_ELEMS + B_ELEMS;
  static constexpr int B_STEP = NA == NOP ? A_ELEMS + B_ELEMS : B_ELEMS;
  static constexpr int STAGE = NA * A_ELEMS + NOP * B_ELEMS;
  static constexpr int LDR = BN + 8;                    // f32 partial tile
  static constexpr size_t SMEM_RING = sizeof(bf16) * STAGES * STAGE;
  static constexpr size_t SMEM_RED = sizeof(float) * NOP * BM * LDR;
  static constexpr size_t SMEM = SMEM_RING > SMEM_RED ? SMEM_RING : SMEM_RED;
  static_assert(MI >= 1 && NI % 2 == 0 && BK % 16 == 0, "tile shape");
  static_assert(FWD || !G, "the GLU is a forward product");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one CTA");
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool FWD, Glu G,
          bool BAT>
__global__ void __launch_bounds__(WM * WN * 32)
    tc_kernel(const Args a) {
  using T = Tc<BM, BN, BK, WM, WN, STAGES, FWD, G>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int S = gridDim.x, rank = blockIdx.x;
  const int list = blockIdx.y / a.n_split;
  const int n0 = (blockIdx.y % a.n_split) * BN;
  int m0, row0, sbase;
  batch_tile<BAT>(a, BM, m0, row0, sbase);
  const int vb = __ldg(a.bounds + list * (S + 1) + rank) + sbase;
  const int ve = __ldg(a.bounds + list * (S + 1) + rank + 1) + sbase;
  const int k_t = FWD ? a.b_in : a.b_out;
  const int ksteps = k_t / BK;
  const int total = (ve - vb) * ksteps;
  const bf16* A = static_cast<const bf16*>(a.a) +
                  static_cast<size_t>(row0) * a.lda;

  auto load_stage = [&](int it, int buf) {
    const int v = vb + it / ksteps, kc = (it % ksteps) * BK;
    const int slot = slot_of<FWD>(a, v);
    bf16* st = sm + buf * T::STAGE;
#pragma unroll
    for (int op = 0; op < T::NOP; ++op) {
      if (op < T::NA) {
        const int col = a_col<FWD>(a, slot, op) + kc;
        bf16* sA = st + op * T::A_STEP;
        constexpr int ACH = BK / 8;
        for (int e = tid; e < BM * ACH; e += T::NT) {
          const int r = e / ACH, c = (e % ACH) * 8, row = m0 + r;
          const bool ok = row < a.M;
          cp_async16(sA + r * T::LDA + c,
                     A + static_cast<size_t>(ok ? row : 0) * a.lda + col + c,
                     ok);
        }
      }
      bf16* sB = st + op * T::B_STEP + T::A_ELEMS;
      const bf16* W = w_block<bf16>(a, slot, op);
      constexpr int BCH = T::B_COLS / 8;
      for (int e = tid; e < T::B_ROWS * BCH; e += T::NT) {
        const int r = e / BCH, c = (e % BCH) * 8;
        const bf16* src =
            FWD ? W + static_cast<size_t>(kc + r) * a.b_out + n0 + c
                : W + static_cast<size_t>(n0 + r) * a.b_out + kc + c;
        cp_async16(sB + r * T::LDB + c, src, true);
      }
    }
  };

  float acc[T::NOP][T::MI][T::NI][4];
#pragma unroll
  for (int op = 0; op < T::NOP; ++op)
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[op][i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; stage it - 1 is free for reuse
    const int nx = it + STAGES - 1;
    if (nx < total) load_stage(nx, nx % STAGES);
    cp_async_commit();
    const bf16* st = sm + (it % STAGES) * T::STAGE;
#pragma unroll
    for (int xa = 0; xa < T::NA; ++xa) {
      const bf16* sA = st + xa * T::A_STEP;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[T::MI][4];
#pragma unroll
        for (int i = 0; i < T::MI; ++i)
          ldmatrix_x4(af[i], sA + (wm * T::WTM + i * 16 + lane % 16) * T::LDA +
                                 kk + (lane / 16) * 8);
        // the weight tiles this X tile feeds (joint: gate and up)
#pragma unroll
        for (int op = xa; op < T::NOP; op += T::NA) {
          const bf16* sB = st + op * T::B_STEP + T::A_ELEMS;
          uint32_t bfr[T::NI][2];
#pragma unroll
          for (int j = 0; j < T::NI; j += 2) {
            uint32_t r4[4];
            const int nb = wn * T::WTN + j * 8;
            if constexpr (FWD) {  // sB[k][n]: transpose to the col fragment
              ldmatrix_x4_trans(r4, sB + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                             T::LDB + nb + (lane >> 4) * 8);
            } else {              // sB[n][k]: already the col fragment
              ldmatrix_x4(r4, sB + (nb + (lane & 7) + (lane >> 4) * 8) * T::LDB +
                                  kk + ((lane >> 3) & 1) * 8);
            }
            bfr[j][0] = r4[0], bfr[j][1] = r4[1];
            bfr[j + 1][0] = r4[2], bfr[j + 1][1] = r4[3];
          }
#pragma unroll
          for (int i = 0; i < T::MI; ++i)
#pragma unroll
            for (int j = 0; j < T::NI; ++j)
              mma_bf16(acc[op][i][j], af[i], bfr[j][0], bfr[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: reuse it for the partial tile(s)

  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int op = 0; op < T::NOP; ++op)
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) {
        const int r = wm * T::WTM + i * 16 + lane / 4;
        const int c = wn * T::WTN + j * 8 + (lane % 4) * 2;
        float* p = red + op * BM * T::LDR;
        *reinterpret_cast<float2*>(p + r * T::LDR + c) =
            make_float2(acc[op][i][j][0], acc[op][i][j][1]);
        *reinterpret_cast<float2*>(p + (r + 8) * T::LDR + c) =
            make_float2(acc[op][i][j][2], acc[op][i][j][3]);
      }
  const int n_t = FWD ? a.b_out : a.b_in;
  cluster_reduce_store<bf16, 4, G != NO_GLU>(a, red, T::LDR, BM, BN,
                                             list * n_t + n0, m0, row0, tid,
                                             T::NT);
}

// ------------------------------------------------------------ f32 FMAs
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty * 4 + i and columns
// tx + 16 * j of a (64 x bn) tile, bn = min(64, output block width). The
// K loop runs in chunks of bk = min(16, K_t) (the last one zero-padded).
constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_NT = 256;

template <typename TA, typename TW, bool FWD, Glu G>
struct Fma {   // the stage layout of Tc, in bytes
  static constexpr int NOP = G ? 2 : 1;                 // weight tiles
  static constexpr int NA = G == JOINT_GLU ? 1 : NOP;   // X tiles
  static constexpr int LDA = F_BK + 16 / sizeof(TA);    // A [64][LDA]
  static constexpr int B_ROWS = FWD ? F_BK : F_BN;
  static constexpr int LDB = (FWD ? F_BN : F_BK) + 16 / sizeof(TW);
  static constexpr size_t A_BYTES = sizeof(TA) * F_BM * LDA;
  static constexpr size_t B_BYTES = sizeof(TW) * B_ROWS * LDB;
  static constexpr size_t A_STEP = A_BYTES + B_BYTES;
  static constexpr size_t B_STEP = NA == NOP ? A_BYTES + B_BYTES : B_BYTES;
  static constexpr size_t STAGE = NA * A_BYTES + NOP * B_BYTES;
  static constexpr int STAGES = 3;
  static constexpr int LDR = F_BN + 4;
  static constexpr size_t SMEM_RING = STAGES * STAGE;
  static constexpr size_t SMEM_RED = sizeof(float) * NOP * F_BM * LDR;
  static constexpr size_t SMEM = SMEM_RING > SMEM_RED ? SMEM_RING : SMEM_RED;
  static_assert(FWD || !G, "the GLU is a forward product");
  static_assert(SMEM <= MAX_SMEM, "shared memory of one CTA");
};

template <typename TA, typename TW, bool FWD, Glu G, bool VEC, bool BAT>
__global__ void __launch_bounds__(F_NT) fma_kernel(const Args a) {
  using F = Fma<TA, TW, FWD, G>;
  constexpr int STAGES = F::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int S = gridDim.x, rank = blockIdx.x;
  const int list = blockIdx.y / a.n_split;
  const int bn = a.bn, bk = a.bk;
  const int n0 = (blockIdx.y % a.n_split) * bn;
  int m0, row0, sbase;
  batch_tile<BAT>(a, F_BM, m0, row0, sbase);
  const int vb = __ldg(a.bounds + list * (S + 1) + rank) + sbase;
  const int ve = __ldg(a.bounds + list * (S + 1) + rank + 1) + sbase;
  const int k_t = FWD ? a.b_in : a.b_out;
  const int ksteps = (k_t + bk - 1) / bk;
  const int total = (ve - vb) * ksteps;
  const TA* A = static_cast<const TA*>(a.a) + static_cast<size_t>(row0) * a.lda;
  // warps whose 8 rows all lie past M skip the arithmetic
  const bool busy = m0 + (tid / 32) * 8 < a.M;

  auto load_stage = [&](int it, int buf) {
    const int v = vb + it / ksteps, kc = (it % ksteps) * bk;
    const int kn = min(bk, k_t - kc);
    const int slot = slot_of<FWD>(a, v);
    const int b_rows = FWD ? bk : bn, b_cols = FWD ? bn : bk;
    unsigned char* st = smem_raw + buf * F::STAGE;
#pragma unroll
    for (int op = 0; op < F::NOP; ++op) {
      const bool has_a = op < F::NA;
      const int col = has_a ? a_col<FWD>(a, slot, op) + kc : 0;
      TA* sA = reinterpret_cast<TA*>(st + op * F::A_STEP);
      TW* sB = reinterpret_cast<TW*>(st + op * F::B_STEP + F::A_BYTES);
      const TW* W = w_block<TW>(a, slot, op);
      if constexpr (VEC) {  // whole chunks, 16-byte aligned rows (host-checked)
        constexpr int EA = 16 / sizeof(TA), EW = 16 / sizeof(TW);
        const int ach = bk / EA;
        for (int e = tid; has_a && e < F_BM * ach; e += F_NT) {
          const int r = e / ach, c = (e % ach) * EA, row = m0 + r;
          const bool ok = row < a.M;
          cp_async16(sA + r * F::LDA + c,
                     A + static_cast<size_t>(ok ? row : 0) * a.lda + col + c,
                     ok);
        }
        const int bch = b_cols / EW;
        for (int e = tid; e < b_rows * bch; e += F_NT) {
          const int r = e / bch, c = (e % bch) * EW;
          const TW* src =
              FWD ? W + static_cast<size_t>(kc + r) * a.b_out + n0 + c
                  : W + static_cast<size_t>(n0 + r) * a.b_out + kc + c;
          cp_async16(sB + r * F::LDB + c, src, true);
        }
      } else {  // element loads; K past the block end is zero
        for (int e = tid; has_a && e < F_BM * bk; e += F_NT) {
          const int r = e / bk, c = e % bk, row = m0 + r;
          sA[r * F::LDA + c] = (row < a.M && c < kn)
              ? A[static_cast<size_t>(row) * a.lda + col + c] : TA(0.f);
        }
        for (int e = tid; e < b_rows * b_cols; e += F_NT) {
          const int r = e / b_cols, c = e % b_cols;
          const int k = FWD ? r : c;
          sB[r * F::LDB + c] = k < kn
              ? (FWD ? W[static_cast<size_t>(kc + r) * a.b_out + n0 + c]
                     : W[static_cast<size_t>(n0 + r) * a.b_out + kc + c])
              : TW(0.f);
        }
      }
    }
  };

  float acc[F::NOP][4][4];
#pragma unroll
  for (int op = 0; op < F::NOP; ++op)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[op][i][j] = 0.f;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = it + STAGES - 1;
    if (nx < total) load_stage(nx, nx % STAGES);
    cp_async_commit();
    if (!busy) continue;
    const unsigned char* st = smem_raw + (it % STAGES) * F::STAGE;
    if constexpr (G == JOINT_GLU) {
      // one read of the X tile per k-step feeds gate and up; unrolled by 4,
      // which ran faster on the H100 than the compiler's own unrolling
      // and than one loop per product
      const TA* sA = reinterpret_cast<const TA*>(st);
#pragma unroll 4
      for (int kk = 0; kk < bk; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(sA[(ty * 4 + i) * F::LDA + kk]);
#pragma unroll
        for (int op = 0; op < F::NOP; ++op) {
          const TW* sB =
              reinterpret_cast<const TW*>(st + op * F::B_STEP + F::A_BYTES);
          float wv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            wv[j] = c < bn ? to_f(sB[kk * F::LDB + c]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[op][i][j] = fmaf(av[i], wv[j], acc[op][i][j]);
        }
      }
    } else {
#pragma unroll
      for (int op = 0; op < F::NOP; ++op) {
        const TA* sA = reinterpret_cast<const TA*>(st + op * F::A_STEP);
        const TW* sB = reinterpret_cast<const TW*>(st + op * F::A_STEP +
                                                   F::A_BYTES);
        for (int kk = 0; kk < bk; ++kk) {
          float av[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_f(sA[(ty * 4 + i) * F::LDA + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            wv[j] = c < bn ? to_f(FWD ? sB[kk * F::LDB + c] : sB[c * F::LDB + kk])
                           : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[op][i][j] = fmaf(av[i], wv[j], acc[op][i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int op = 0; op < F::NOP; ++op)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < bn)
          red[op * F_BM * F::LDR + (ty * 4 + i) * F::LDR + tx + 16 * j] =
              acc[op][i][j];
  const int n_t = FWD ? a.b_out : a.b_in;
  cluster_reduce_store<TA, 1, G != NO_GLU>(a, red, F::LDR, F_BM, bn,
                                           list * n_t + n0, m0, row0, tid,
                                           F_NT);
}

// ------------------------------------------------------------ host side
// Launches kernel(args) on a grid whose CTAs along x form one cluster.
template <typename K, typename A>
int launch_cluster(K kernel, dim3 grid, int nt, size_t smem,
                   cudaStream_t stream, const A& args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool FWD, Glu G>
int launch_tc(const Args& a, int n_lists, int n_t, int splits,
              cudaStream_t stream) {
  using T = Tc<BM, BN, BK, WM, WN, STAGES, FWD, G>;
  const int k_t = FWD ? a.b_in : a.b_out;
  if (n_t % BN != 0 || k_t % BK != 0 || a.n_split != n_t / BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(splits, n_lists * a.n_split,
                  a.batch * ((a.M + BM - 1) / BM));
  if constexpr (FWD) {
    if (a.batch > 1)
      return launch_cluster(tc_kernel<BM, BN, BK, WM, WN, STAGES, FWD, G, true>,
                            grid, T::NT, T::SMEM, stream, a);
  }
  return launch_cluster(tc_kernel<BM, BN, BK, WM, WN, STAGES, FWD, G, false>,
                        grid, T::NT, T::SMEM, stream, a);
}

template <typename TA, typename TW, bool FWD, Glu G>
int launch_fma(const Args& a, int n_lists, int n_t, int splits, bool vec,
               cudaStream_t stream) {
  using F = Fma<TA, TW, FWD, G>;
  const int k_t = FWD ? a.b_in : a.b_out;
  if (a.bn < 1 || a.bn > F_BN || n_t % a.bn != 0 ||
      a.n_split != n_t / a.bn || a.bk < 1 || a.bk > F_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (k_t % a.bk != 0 || (a.bk * sizeof(TA)) % 16 != 0 ||
              (a.bk * sizeof(TW)) % 16 != 0 || (a.bn * sizeof(TW)) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(splits, n_lists * a.n_split,
                  a.batch * ((a.M + F_BM - 1) / F_BM));
  auto* k = vec ? fma_kernel<TA, TW, FWD, G, true, false>
                : fma_kernel<TA, TW, FWD, G, false, false>;
  if constexpr (FWD) {
    if (a.batch > 1)
      k = vec ? fma_kernel<TA, TW, FWD, G, true, true>
              : fma_kernel<TA, TW, FWD, G, false, true>;
  }
  return launch_cluster(k, grid, F_NT, F::SMEM, stream, a);
}

// Kernel ids (kernels/split_plan.py::KERNELS): 0 FMA element loads, 1 FMA
// 16-byte loads, 2..5 tensor-core tiles (BM x BN x BK, ring stages)
// 32x16x16 (4), 16x64x128 (4), 64x64x64 (4), 128x128x64 (3). Whole
// 128-deep blocks or 64-deep halves per stage measured faster than 32-deep
// ones on the H100 (fewer barriers per visit); deeper rings did not help.
// The 128x128x64 tile's 3 stages (110 KB) let two CTAs share an SM (the
// split GLU's 215 KB and the joint GLU's 160 KB, one). dtype codes:
// 0 float32, 1 bfloat16.
template <bool FWD, Glu G = NO_GLU>
int run(const Args& a, int n_lists, int kernel, int splits, int a_dtype,
        int w_dtype, int device, void* stream_ptr) {
  const int n_t = FWD ? a.b_out : a.b_in;
  if (splits < 1 || splits > MAX_SPLITS || n_lists < 1 || a.M < 1 ||
      a.b_in < 1 || a.b_out < 1 || a.n_split < 1 || a.batch < 1 ||
      (!FWD && a.batch != 1) ||
      static_cast<long long>(a.batch) * ((a.M + 15) / 16) > 65535 ||
      (G && a.w2 == nullptr) || (G == SPLIT_GLU && a.idx2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  if (kernel >= 2) {
    if (a_dtype != 1 || w_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    switch (kernel) {
      case 2: return launch_tc<32, 16, 16, 2, 1, 4, FWD, G>(a, n_lists, n_t, splits, st);
      case 3: return launch_tc<16, 64, 128, 1, 4, 4, FWD, G>(a, n_lists, n_t, splits, st);
      case 4: return launch_tc<64, 64, 64, 2, 2, 4, FWD, G>(a, n_lists, n_t, splits, st);
      case 5: return launch_tc<128, 128, 64, 2, 4, 3, FWD, G>(a, n_lists, n_t, splits, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const bool vec = kernel == 1;
  if (a_dtype == 0 && w_dtype == 0)
    return launch_fma<float, float, FWD, G>(a, n_lists, n_t, splits, vec, st);
  if (a_dtype == 0 && w_dtype == 1)
    return launch_fma<float, bf16, FWD, G>(a, n_lists, n_t, splits, vec, st);
  if (a_dtype == 1 && w_dtype == 1)
    return launch_fma<bf16, bf16, FWD, G>(a, n_lists, n_t, splits, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bsp
