// One-token GQA decode attention read straight through the block tables of
// the shared paged KV pool, hand-written for Hopper (sm_90a).
//
//   paged_flash_decode  replaces src/repro/kernels/paged_attention.py
//                       _paged_decode_kernel / paged_flash_decode
//
// Layout: q (B, KV, G, hd); pool_k / pool_v (n_pages, ps, KV, hd);
// block_tables (B, >= R) int32 with row stride bt_stride; bias (B, R * ps)
// f32, 0 where a slot may be attended and -1e30 where it is masked; out
// (B, KV, G, hd) f32.
//
// What bounds it on an H100: latency, then bytes. A (lane, kv head) pair
// reads R pages of K and V once and uses them for G = 4 query rows, about
// 2 * G operations per element read, far below the card's ridge point; at
// the served shape (B = 8 lanes x 8 kv heads, R <= 32 pages of 16 slots)
// all pages together are a few MB, so what costs is the chain table ->
// page -> softmax of each (lane, head) and how few of them there are. The
// design:
//  * Split-KV over a cluster. The grid is (S, B * KV) with cluster
//    (S, 1, 1): CTA c of a (lane, head) takes the contiguous page range
//    [c R / S, (c + 1) R / S). The host picks S from the shapes
//    (kernels/split_plan.py::decode_splits): the least that gives every SM
//    a CTA, at most 8 and at most R.
//  * Every page of a chunk in flight at once. The CTA's 8 warps take its
//    pages round robin (at the served R = 16, S = 3: one page a warp, so
//    no warp folds pages one after another); a warp reads its block-table
//    entries in one load (one lane per page), then issues 16-byte cp.async
//    copies of each page's K and V rows for this head (and 4-byte copies
//    of the page's bias) into a private ring of up to 8 pages, so one
//    page's loads overlap the others' and their compute. No gathered copy
//    of the context exists in device memory, and the main loop has no
//    block-wide barrier (each warp waits on its own copies). A table entry
//    outside [0, n_pages) zero-fills (src-size 0) and its slots count as
//    masked. Element loads remain only for a row that is not 16-byte
//    aligned.
//  * All lanes at work. A warp step covers 32 / LPS slots: LPS lanes share
//    one slot's dot products for all G query rows, 8 elements each, summed
//    by shuffles. Four steps (16 slots at hd = 64: a whole page) are scored
//    before one online-softmax update per query row on the warp's shuffled
//    maxima (m is the same on every lane), so the dependent chain runs once
//    a page, not once a step; each lane keeps P V for its 8 elements and
//    its slot group in registers.
//  * Up to 16 query rows. A lane keeps up to 8 rows of q and acc in
//    registers; for 8 < G <= 16 (qwen3-moe: 64 query heads over 4 kv
//    heads) two teams of LPS lanes score the same slot, one for rows 0-7
//    and one for rows 8-15, so a warp step covers half as many slots and
//    no lane holds more than 8 rows (16 would not fit its 255 registers).
//    This takes LPS <= 16, so hd <= 128 there.
//  * One merge. The warps' (m, l, acc) meet in shared memory, then the
//    CTAs' through distributed shared memory in rank order: m* = max m_c,
//    l = sum l_c e^(m_c - m*), acc = sum acc_c e^(m_c - m*), out =
//    acc / max(l, 1e-30). One launch, no workspace, no atomics; the
//    result is bitwise the same run to run.
// mma.sync would need G padded to 16 rows and bf16 queries; at 2 * G
// operations per element the FMA pipes keep up with the copies.
//
// Semantics follow the TPU kernel: a slot is valid when bias > -1e30 / 2;
// the softcap is applied before the mask; masked scores are -1e30 and
// their probabilities are forced to 0, so a fully masked page or chunk
// leaves its partial at (m = -1e30, l = 0, acc = 0), which the merge
// weights by 0, and a fully masked lane gives 0 (a short lane whose table
// entries past its allocation alias pool page 0 reads that page but takes
// nothing from it). Probabilities are rounded to the query's type before
// the PV product: the TPU kernel rounds to the pool's type, and on the
// served path both are bf16; with an f32 query over a bf16 pool (the small
// test configs) this keeps the f32 probabilities of the XLA gather path.
// They are rounded against the running max of the warp's pages (the TPU
// kernel's: of the lane's pages so far), so the merge rescales rounded
// values in f32; the result stays within the plain version's tolerance.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "bsp_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using bsp::bf16;

constexpr int NW = 8;                  // warps of a CTA
constexpr int NT = NW * 32;
constexpr int MAX_RING = 8;            // pages in flight per warp, at most
constexpr int RING_BUDGET = 96 * 1024; // shared bytes of the warps' rings
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

struct DecodeArgs {
  const void* q;
  const void* pk;
  const void* pv;
  const int* bt;
  const float* bias;
  float* out;
  int bt_stride, KV, G, hd, ps, R, n_pages;
  float scale, softcap;
  int hdp;         // ring row stride: hd rounded up to 8
  int ring;        // pages in flight per warp
  int slot_bytes;  // one ring slot: K rows, V rows, bias
  int vec;         // 16-byte copies (aligned rows)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   bsp::smem_u32(dst)),
               "l"(src));
}

// wait until at most n of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 1: bsp::cp_async_wait<1>(); break;
    case 2: bsp::cp_async_wait<2>(); break;
    case 3: bsp::cp_async_wait<3>(); break;
    case 4: bsp::cp_async_wait<4>(); break;
    case 5: bsp::cp_async_wait<5>(); break;
    case 6: bsp::cp_async_wait<6>(); break;
    case 7: bsp::cp_async_wait<7>(); break;
    default: bsp::cp_async_wait<0>();
  }
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// LPS: lanes per slot (8 elements each, so hd <= 8 LPS); GR: query rows a
// lane holds in registers; RG: row groups of a warp step, so the CTA holds
// GM = GR * RG query rows (G <= GM; rows past G compute on zeros,
// unstored). A lane is (slot group sg, row group rg, element lane): with
// RG = 2 the two halves of a LPS * 2 lane team score the same slot for rows
// [0, GR) and [GR, 2 GR), each with GR rows of q and acc in registers (16
// rows in one lane's registers would not fit 255 of them), at the cost of
// half as many slots per warp step.
template <typename TQ, typename TKV, int LPS, int GR, int RG>
__global__ void __launch_bounds__(NT) paged_decode_kernel(const DecodeArgs a) {
  constexpr int GM = GR * RG;        // query rows of the CTA
  constexpr int SG = 32 / (LPS * RG);  // slots of one warp step
  constexpr int UNR = 4;        // warp steps per softmax update
  static_assert(SG >= 1, "a warp holds LPS * RG lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int S = gridDim.x, c = blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.KV, h = bh % a.KV;
  const int G = a.G, hd = a.hd, hdp = a.hdp, ps = a.ps;
  const int sg = lane / (LPS * RG), d0 = (lane % LPS) * 8;
  const int g0 = (lane / LPS) % RG * GR;  // this lane's first query row
  const bool dlive = d0 < hd;

  // this CTA's pages [j0, j1); this warp's are j0 + warp + NW * t
  const int j0 = c * a.R / S, j1 = (c + 1) * a.R / S;
  const int n_mine = j1 - j0 > warp ? (j1 - j0 - warp + NW - 1) / NW : 0;
  const int* bt = a.bt + static_cast<size_t>(b) * a.bt_stride + j0 + warp;
  const int my_entry = lane < n_mine ? __ldg(bt + lane * NW) : 0;
  auto entry = [&](int t) {
    return t < 32 ? __shfl_sync(FULL, my_entry, t) : __ldg(bt + t * NW);
  };

  const TQ* qp = static_cast<const TQ*>(a.q) + static_cast<size_t>(bh) * G * hd;
  float q[GR][8];
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[g][e] = (g0 + g < G && d0 + e < hd)
                    ? bsp::to_f(qp[(g0 + g) * hd + d0 + e]) : 0.f;

  const TKV* pk = static_cast<const TKV*>(a.pk);
  const TKV* pv = static_cast<const TKV*>(a.pv);
  unsigned char* ring = smem + static_cast<size_t>(warp) * a.ring * a.slot_bytes;
  const size_t kv_row = static_cast<size_t>(a.KV) * hd;  // slot stride

  auto issue = [&](int t) {
    const int page = entry(t);
    const bool ok = page >= 0 && page < a.n_pages;
    const int j = j0 + warp + NW * t;
    unsigned char* slot = ring + (t % a.ring) * a.slot_bytes;
    TKV* sk = reinterpret_cast<TKV*>(slot);
    TKV* sv = sk + ps * hdp;
    float* sb = reinterpret_cast<float*>(sv + ps * hdp);
    const size_t row0 =
        (static_cast<size_t>(ok ? page : 0) * ps * a.KV + h) * hd;
    const float* bias = a.bias + (static_cast<size_t>(b) * a.R + j) * ps;
    if (a.vec) {
      constexpr int EC = 16 / sizeof(TKV);
      const int cpr = hd / EC;  // copies per row
      for (int e = lane; e < ps * cpr; e += 32) {
        const int s = e / cpr, d = (e % cpr) * EC;
        const size_t off = row0 + s * kv_row + d;
        bsp::cp_async16(sk + s * hdp + d, pk + off, ok);
        bsp::cp_async16(sv + s * hdp + d, pv + off, ok);
      }
      for (int s = lane; s < ps; s += 32) cp_async4(sb + s, bias + s);
    } else {
      for (int e = lane; e < ps * hdp; e += 32) {
        const int s = e / hdp, d = e % hdp;
        const bool live = ok && d < hd;
        const size_t off = row0 + s * kv_row + d;
        sk[e] = live ? pk[off] : TKV(0.f);
        sv[e] = live ? pv[off] : TKV(0.f);
      }
      for (int s = lane; s < ps; s += 32) sb[s] = bias[s];
    }
    bsp::cp_async_commit();
  };

  float m[GR], l[GR], acc[GR][8];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = NEG_INF, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < min(a.ring, n_mine); ++t) issue(t);
  for (int t = 0; t < n_mine; ++t) {
    cp_async_wait_upto(min(n_mine, t + a.ring) - t - 1);
    __syncwarp();  // page t landed for every lane of the warp
    const int page = entry(t);
    const bool ok = page >= 0 && page < a.n_pages;
    const unsigned char* slot = ring + (t % a.ring) * a.slot_bytes;
    const TKV* sk = reinterpret_cast<const TKV*>(slot);
    const TKV* sv = sk + ps * hdp;
    const float* sb = reinterpret_cast<const float*>(sv + ps * hdp);
    for (int s0 = 0; s0 < ps; s0 += UNR * SG) {
      // UNR warp steps of scores, then one online-softmax update
      float sc[UNR][GR];
      bool valid[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int s = s0 + u * SG + sg;
        float kv[8];
        if (s < ps && dlive) {
          load8(kv, sk + s * hdp + d0);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(q[g][e], kv[e], dot);
          sc[u][g] = dot;
        }
        valid[u] = s < ps && ok && sb[s < ps ? s : 0] > NEG_INF / 2;
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off /= 2)
#pragma unroll
        for (int u = 0; u < UNR; ++u)
#pragma unroll
          for (int g = 0; g < GR; ++g)
            sc[u][g] += __shfl_xor_sync(FULL, sc[u][g], off);
      float mx[GR];
#pragma unroll
      for (int g = 0; g < GR; ++g) mx[g] = NEG_INF;
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          float x = sc[u][g] * a.scale;
          if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
          sc[u][g] = valid[u] ? x : NEG_INF;
          mx[g] = fmaxf(mx[g], sc[u][g]);
        }
#pragma unroll
      for (int off = LPS * RG; off < 32; off *= 2)
#pragma unroll
        for (int g = 0; g < GR; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], off));
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float m_new = fmaxf(m[g], mx[g]);
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          const float p = valid[u] ? expf(sc[u][g] - m_new) : 0.f;
          psum += p;
          sc[u][g] = round_to(p, static_cast<const TQ*>(nullptr));
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int s = s0 + u * SG + sg;
        if (s < ps && dlive) {
          float vv[8];
          load8(vv, sv + s * hdp + d0);
#pragma unroll
          for (int g = 0; g < GR; ++g)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(sc[u][g], vv[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // every lane is done with the slot: refill it
    if (t + a.ring < n_mine) issue(t + a.ring);
  }

  // the warp's slot groups: sum l and acc (m is the same on every lane of
  // a row group)
#pragma unroll
  for (int off = LPS * RG; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
    }

  // partials: warps' [NW][GM] m and l, [NW][GM][hdp] acc; the CTA's
  // [GM] m and l, [GM][hdp] acc
  float* wm = reinterpret_cast<float*>(smem + static_cast<size_t>(NW) * a.ring *
                                                  a.slot_bytes);
  float* wl = wm + NW * GM;
  float* wacc = wl + NW * GM;
  float* cm = wacc + NW * GM * hdp;
  float* cl = cm + GM;
  float* cacc = cl + GM;
  if (sg == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int row = warp * GM + g0 + g;
      if (d0 == 0) wm[row] = m[g], wl[row] = l[g];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (d0 + e < hdp) wacc[row * hdp + d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int g = i / hd, d = i % hd;
    float mc = NEG_INF;
    for (int w = 0; w < NW; ++w) mc = fmaxf(mc, wm[w * GM + g]);
    float lc = 0.f, ac = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w * GM + g] - mc);
      lc += wl[w * GM + g] * f;
      ac += wacc[(w * GM + g) * hdp + d] * f;
    }
    cacc[g * hdp + d] = ac;
    if (d == 0) cm[g] = mc, cl[g] = lc;
  }
  cluster.sync();  // every CTA's partial is in place

  const int gh = G * hd;
  float* out = a.out + static_cast<size_t>(bh) * gh;
  for (int i = c * gh / S + threadIdx.x; i < (c + 1) * gh / S; i += NT) {
    const int g = i / hd, d = i % hd;
    float ms = NEG_INF;
    for (int r = 0; r < S; ++r) ms = fmaxf(ms, cluster.map_shared_rank(cm, r)[g]);
    float L = 0.f, A = 0.f;
    for (int r = 0; r < S; ++r) {
      const float f = expf(cluster.map_shared_rank(cm, r)[g] - ms);
      L += cluster.map_shared_rank(cl, r)[g] * f;
      A += cluster.map_shared_rank(cacc, r)[g * hdp + d] * f;
    }
    out[i] = A / fmaxf(L, 1e-30f);
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

template <typename TQ, typename TKV, int LPS, int GR, int RG>
int launch(const DecodeArgs& a, int B, int splits, cudaStream_t st) {
  constexpr int GM = GR * RG;
  const size_t parts = sizeof(float) * (2 * NW * GM + NW * GM * a.hdp +
                                        2 * GM + GM * a.hdp);
  const size_t smem = static_cast<size_t>(NW) * a.ring * a.slot_bytes + parts;
  if (smem > bsp::MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  return bsp::launch_cluster(paged_decode_kernel<TQ, TKV, LPS, GR, RG>,
                             dim3(splits, B * a.KV), NT, smem, st, a);
}

template <typename TQ, typename TKV>
int pick_tile(const DecodeArgs& a, int B, int splits, cudaStream_t st) {
  const int lps = a.hdp <= 32 ? 4 : a.hdp <= 64 ? 8 : a.hdp <= 128 ? 16 : 32;
  // G <= 8: one row group of GM in {2, 4, 8} rows; 8 < G <= 16: two row
  // groups of 8 (LPS <= 16, so hd <= 128)
  const int gm = a.G <= 2 ? 2 : a.G <= 4 ? 4 : a.G <= 8 ? 8 : 16;
#define PAGED_CASE(L, M)                                                  \
  if (lps == L && gm == M)                                                \
    return launch<TQ, TKV, L, M <= 8 ? M : 8, M <= 8 ? 1 : 2>(a, B, splits, \
                                                              st);
  PAGED_CASE(4, 2) PAGED_CASE(4, 4) PAGED_CASE(4, 8) PAGED_CASE(4, 16)
  PAGED_CASE(8, 2) PAGED_CASE(8, 4) PAGED_CASE(8, 8) PAGED_CASE(8, 16)
  PAGED_CASE(16, 2) PAGED_CASE(16, 4) PAGED_CASE(16, 8) PAGED_CASE(16, 16)
  PAGED_CASE(32, 2) PAGED_CASE(32, 4) PAGED_CASE(32, 8)
#undef PAGED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// splits: CTAs per (lane, kv head), one cluster (split_plan.decode_splits);
// dtype codes: 0 = float32, 1 = bfloat16. Takes hd <= 256 at G <= 8 and
// hd <= 128 at G <= 16. Returns cudaGetLastError() after the launch (0 =
// launched).
int paged_flash_decode_launch(const void* q, const void* pool_k,
                              const void* pool_v, const void* block_tables,
                              int bt_stride, const void* bias, void* out, int B,
                              int KV, int G, int hd, int ps, int R, int n_pages,
                              float scale, float softcap, int splits,
                              int q_dtype, int kv_dtype, int device,
                              void* stream) {
  if (B < 1 || KV < 1 || G < 1 || G > 16 || hd < 1 || hd > 256 ||
      (G > 8 && hd > 128) || ps < 1 ||
      R < 1 || splits < 1 || splits > bsp::MAX_SPLITS || splits > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int es = kv_dtype == 1 ? 2 : 4;
  DecodeArgs a{q, pool_k, pool_v, static_cast<const int*>(block_tables),
               static_cast<const float*>(bias), static_cast<float*>(out),
               bt_stride, KV, G, hd, ps, R, n_pages, scale, softcap};
  a.hdp = (hd + 7) / 8 * 8;
  a.slot_bytes = 2 * ps * a.hdp * es + (ps * 4 + 15) / 16 * 16;
  const int per_warp = ((R + splits - 1) / splits + NW - 1) / NW;
  a.ring = RING_BUDGET / (NW * a.slot_bytes);
  a.ring = a.ring < 1 ? 1 : a.ring > MAX_RING ? MAX_RING : a.ring;
  if (a.ring > per_warp) a.ring = per_warp;
  a.vec = hd % 8 == 0 && reinterpret_cast<uintptr_t>(pool_k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pool_v) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    return pick_tile<float, float>(a, B, splits, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return pick_tile<bf16, bf16>(a, B, splits, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return pick_tile<float, bf16>(a, B, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
