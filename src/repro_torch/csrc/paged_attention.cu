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
// What bounds it on an H100: bytes. A (lane, kv head) pair reads R pages
// of K and V once and uses them for G = 4 query rows, about 2 * G
// operations per element read, far below the card's ridge point. The
// design: one thread block per (lane, kv head) loops over its R pages,
// loading block_tables[b, j] itself (the TPU kernel's scalar prefetch),
// copies that page's K and V rows for its head from the pool into shared
// memory (no gathered copy of the context ever exists in device memory)
// and folds them into an f32 online softmax. Semantics follow the TPU
// kernel: a slot is valid when bias > -1e30 / 2; the softcap is applied
// before the mask; masked scores are -1e30 and their probabilities are
// forced to 0, so a fully masked page leaves m, l and acc unchanged (a
// short lane whose table entries past its allocation alias pool page 0
// reads that page but takes nothing from it); l is clamped at 1e-30.
// Probabilities are rounded to the query's type before the PV product:
// the TPU kernel rounds to the pool's type, and on the served path both
// are bf16; with an f32 query over a bf16 pool (the small test configs)
// this keeps the f32 probabilities of the XLA gather path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Shared memory, in 4-byte words: q (G*hd), K (ps*(hd+1), rows padded by
// one word so the score loop does not hit one bank), V (ps*hd), scores
// (G*ps), acc (G*hd), m / l / alpha (3*G), valid flags (ps).
__host__ __device__ inline size_t smem_words(int G, int hd, int ps) {
  return static_cast<size_t>(G) * hd * 2 + static_cast<size_t>(ps) * (hd + 1) +
         static_cast<size_t>(ps) * hd + static_cast<size_t>(G) * ps + 3 * G + ps;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ pk,
                        const TKV* __restrict__ pv,
                        const int* __restrict__ bt, int bt_stride,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int KV, int G, int hd, int ps, int R, int n_pages,
                        float scale, float softcap) {
  extern __shared__ float sm[];
  const int hdp = hd + 1;
  float* qs = sm;
  float* ks = qs + G * hd;
  float* vs = ks + ps * hdp;
  float* ss = vs + ps * hd;
  float* acc = ss + G * ps;
  float* m = acc + G * hd;
  float* l = m + G;
  float* alpha = l + G;
  int* valid = reinterpret_cast<int*>(alpha + G);

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t qofs = (static_cast<size_t>(b) * KV + h) * G * hd;
  for (int e = tid; e < G * hd; e += NT) {
    qs[e] = ld(q + qofs + e);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < R; ++j) {
    const int page = bt[static_cast<size_t>(b) * bt_stride + j];
    // a table entry outside the pool is never read: its slots count as
    // masked (the engine only writes entries inside the pool)
    const bool page_ok = page >= 0 && page < n_pages;
    for (int e = tid; e < ps * hd; e += NT) {
      const int s = e / hd, d = e % hd;
      float kv = 0.f, vv = 0.f;
      if (page_ok) {
        const size_t off =
            ((static_cast<size_t>(page) * ps + s) * KV + h) * hd + d;
        kv = ld(pk + off);
        vv = ld(pv + off);
      }
      ks[s * hdp + d] = kv;
      vs[e] = vv;
    }
    for (int s = tid; s < ps; s += NT) {
      valid[s] = page_ok &&
                 bias[static_cast<size_t>(b) * R * ps + j * ps + s] > NEG_INF / 2;
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += NT) {
      const int g = e / ps, s = e % ps;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qs[g * hd + d] * ks[s * hdp + d];
      float sc = dot * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      ss[e] = valid[s] ? sc : NEG_INF;
    }
    __syncthreads();
    for (int g = tid; g < G; g += NT) {
      float mx = NEG_INF;
      for (int s = 0; s < ps; ++s) mx = fmaxf(mx, ss[g * ps + s]);
      const float m_new = fmaxf(m[g], mx);
      const float a = expf(m[g] - m_new);
      float sum = 0.f;
      for (int s = 0; s < ps; ++s) {
        const float p = valid[s] ? expf(ss[g * ps + s] - m_new) : 0.f;
        sum += p;
        ss[g * ps + s] = round_to(p, q);
      }
      l[g] = l[g] * a + sum;
      m[g] = m_new;
      alpha[g] = a;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += NT) {
      const int g = e / hd, d = e % hd;
      float pvsum = 0.f;
      for (int s = 0; s < ps; ++s) pvsum += ss[g * ps + s] * vs[s * hd + d];
      acc[e] = acc[e] * alpha[g] + pvsum;
    }
    __syncthreads();
  }
  for (int e = tid; e < G * hd; e += NT) {
    out[qofs + e] = acc[e] / fmaxf(l[e / hd], 1e-30f);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* pk, const void* pv, const void* bt,
           int bt_stride, const void* bias, void* out, int B, int KV, int G,
           int hd, int ps, int R, int n_pages, float scale, float softcap,
           void* stream) {
  const size_t bytes = smem_words(G, hd, ps) * 4;
  auto kern = paged_decode_kernel<TQ, TKV>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(B, KV), NT, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk),
      static_cast<const TKV*>(pv), static_cast<const int*>(bt), bt_stride,
      static_cast<const float*>(bias), static_cast<float*>(out), KV, G, hd, ps,
      R, n_pages, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 = launched).
int paged_flash_decode_launch(const void* q, const void* pool_k,
                              const void* pool_v, const void* block_tables,
                              int bt_stride, const void* bias, void* out, int B,
                              int KV, int G, int hd, int ps, int R, int n_pages,
                              float scale, float softcap, int q_dtype,
                              int kv_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, pool_k, pool_v, block_tables, bt_stride,
                                bias, out, B, KV, G, hd, ps, R, n_pages, scale,
                                softcap, stream);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, pool_k, pool_v, block_tables, bt_stride, bias, out, B, KV, G, hd, ps,
        R, n_pages, scale, softcap, stream);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, pool_k, pool_v, block_tables,
                                        bt_stride, bias, out, B, KV, G, hd, ps,
                                        R, n_pages, scale, softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
