// Block-sparse products over packed balanced BCSC, hand-written for
// Hopper (sm_90a):
//
//   bspmm            replaces src/repro/kernels/bspmm.py  _bspmm_kernel / bspmm
//   fused_glu_split  replaces src/repro/kernels/bspmm.py  _fused_glu_kernel / fused_glu
//   fused_glu_joint  replaces src/repro/kernels/bspmm.py  _fused_glu_joint_kernel /
//                                                         _fused_glu_joint
//
// Layout (core/packing.py): W is blocks (Nb, nnz, b_in, b_out) plus
// idx (Nb, nnz) int32, the block-row of each kept block. X is (M, K)
// row-major, Y is (M, Nb * b_out) row-major in X's type.
//
// bspmm runs the shared main loops of bsp_mma.cuh (FWD = true): the visit
// list of output block-column j is its nnz slots, A is the X tile at
// block-row idx[j, k], B the row-major block (ldmatrix.trans). What bounds
// it on an H100, at the served shapes (Llama-3.2-1B down projection, 16
// block-columns of 13 kept 128 x 128 bf16 blocks, 6.8 MB):
//  * decode, M = 8 rows: bound by the weight bytes (a byte feeds ~8
//    operations, against ~295 where the tensor cores would set the pace).
//    Only 16 output tiles exist, so the host splits each column's 13
//    visits over a cluster of up to 8 CTAs and the 128-wide block into two
//    64-wide tiles: 16 x 2 x S CTAs, each streaming a few 16 KB half
//    blocks through a 4-stage cp.async ring (32-48 KB in flight per CTA),
//    with M padded to one 16-row mma tile (kernel 3, 16 x 64 x 64).
//  * prefill chunk, M = 128, and fine-tuning, M = 1024: the 128 x 128 x 32
//    tile (kernel 5) or the 64 x 64 x 32 one (kernel 4), chosen with the
//    split by the host's cost model (kernels/split_plan.py); at M = 1024
//    the work is bound by operations (each weight byte feeds ~1024).
// f32, f32 X over bf16 weights, and block sides that are no multiple of 16
// take the f32 FMA loop (kernels 0 and 1). The host chooses by dtype,
// shape and alignment before the launch and raises on what no kernel
// takes.
//
// The split fused GLU runs the same main loops in their GLU mode
// (bsp_mma.cuh): each visit stages the X tiles at idx_gate and idx_up with
// the gate and up blocks, and the cluster reduction applies the
// activation to the f32 sums. At decode (M = 8, W_gate and W_up each 64
// block-columns of 4 kept 128 x 128 bf16 blocks, 8.4 MB) it is bound by
// those weight bytes, like bspmm.
//
// The joint fused GLU (fused_glu_joint_launch, bsp_kernel below) keeps the
// first port's design: one thread block owns one (BM x b_out) output tile
// (grid = (ceil(M / BM), Nb)) and loops over the column's nnz kept blocks,
// staging one X tile and both weight blocks in shared memory in K chunks,
// accumulating in f32 registers with plain FMAs, and applying the
// activation in the epilogue. Rows past M are masked. Moving it onto the
// GLU mode of the shared main loop is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "bsp_mma.cuh"

namespace {

constexpr int BM = 16;       // rows of X per thread block
constexpr int NT = 256;      // threads per block
constexpr int KC_MAX = 64;   // most block-rows of one K chunk
constexpr int W_CAP = 4096;  // f32 elements of one staged weight chunk

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype does
}

// Y = act(X Wa) * (X Wb) with one shared idx table ia: one X tile feeds
// both products.
template <typename TX, typename TW>
__global__ void __launch_bounds__(NT)
    bsp_kernel(const TX* __restrict__ x, const TW* __restrict__ wa,
               const int* __restrict__ ia, const TW* __restrict__ wb,
               TX* __restrict__ y, int M, int K, int nnz, int b_in, int b_out,
               int act) {
  __shared__ float xs[BM * KC_MAX];
  __shared__ float ws[2][W_CAP];

  const int j = blockIdx.y;        // block-column
  const int m0 = blockIdx.x * BM;  // first row of the tile
  const int n = gridDim.y * b_out;
  const int tid = threadIdx.x;
  const int c = tid % b_out;       // output column inside the block
  const int rg = tid / b_out;      // this thread's first row
  const int n_rg = NT / b_out;     // row stride between a thread's rows
  const int kc_max = min(KC_MAX, W_CAP / b_out);

  float acc[2][BM];
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[w][i] = 0.f;

  for (int k = 0; k < nnz; ++k) {
    const int slot = j * nnz + k;
    const int col = ia[slot] * b_in;
    const size_t wofs = static_cast<size_t>(slot) * b_in * b_out;
    for (int k0 = 0; k0 < b_in; k0 += kc_max) {
      const int kc = min(kc_max, b_in - k0);
      for (int e = tid; e < BM * kc; e += NT) {
        const int r = e / kc, cc = e % kc, row = m0 + r;
        xs[e] = row < M ? ld(x + static_cast<size_t>(row) * K + col + k0 + cc)
                        : 0.f;
      }
      const size_t w0 = wofs + static_cast<size_t>(k0) * b_out;
      for (int e = tid; e < kc * b_out; e += NT) {
        ws[0][e] = ld(wa + w0 + e);
        ws[1][e] = ld(wb + w0 + e);
      }
      __syncthreads();
      if (rg < BM) {
        for (int kk = 0; kk < kc; ++kk) {
          const float wva = ws[0][kk * b_out + c];
          const float wvb = ws[1][kk * b_out + c];
#pragma unroll
          for (int i = 0; i < BM; ++i) {
            const int r = rg + i * n_rg;
            if (r < BM) {
              acc[0][i] += xs[r * kc + kk] * wva;
              acc[1][i] += xs[r * kc + kk] * wvb;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (rg < BM) {
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int r = rg + i * n_rg, row = m0 + r;
      if (r < BM && row < M) {
        const float v = bsp::act_fn(act, acc[0][i]) * acc[1][i];
        st(y + static_cast<size_t>(row) * n + static_cast<size_t>(j) * b_out + c, v);
      }
    }
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* wa, const void* ia, const void* wb,
           void* y, int M, int K, int nb, int nnz, int b_in, int b_out,
           int act, void* stream) {
  const dim3 grid((M + BM - 1) / BM, nb);
  bsp_kernel<TX, TW><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(wa),
      static_cast<const int*>(ia), static_cast<const TW*>(wb),
      static_cast<TX*>(y), M, K, nnz, b_in, b_out, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// bounds: (Nb, splits + 1) int32 chunk starts into the flat slots
// j * nnz + k (kernels/split_plan.py); kernel: the id of bsp::run; bn, bk:
// the FMA loop's tile width and K chunk (ignored by the tensor-core ones).
int bspmm_launch(const void* x, const void* blocks, const void* idx,
                 const void* bounds, void* y, int M, int K, int nb, int nnz,
                 int b_in, int b_out, int n_split, int splits, int kernel,
                 int bn, int bk, int x_dtype, int w_dtype, int device,
                 void* stream) {
  bsp::Args a{x, blocks, static_cast<const int*>(idx), nullptr,
              static_cast<const int*>(bounds), y, M, K, nb * b_out, nnz,
              b_in, b_out, n_split, bn, bk};
  return bsp::run<true>(a, nb, kernel, splits, x_dtype, w_dtype, device,
                        stream);
}

// The split fused GLU: bspmm's arguments plus the up blocks, their idx
// table and the activation id (0 silu, 1 gelu, 2 relu).
int fused_glu_split_launch(const void* x, const void* w_gate,
                           const void* idx_gate, const void* w_up,
                           const void* idx_up, const void* bounds, void* y,
                           int M, int K, int nb, int nnz, int b_in, int b_out,
                           int n_split, int splits, int kernel, int bn, int bk,
                           int act, int x_dtype, int w_dtype, int device,
                           void* stream) {
  bsp::Args a{x, w_gate, static_cast<const int*>(idx_gate), nullptr,
              static_cast<const int*>(bounds), y, M, K, nb * b_out, nnz,
              b_in, b_out, n_split, bn, bk, w_up,
              static_cast<const int*>(idx_up), act};
  return bsp::run<true, true>(a, nb, kernel, splits, x_dtype, w_dtype, device,
                              stream);
}

// The joint fused GLU; x may be f32 over bf16 weights (dtype codes 0 =
// float32, 1 = bfloat16).
int fused_glu_joint_launch(const void* x, const void* w_gate, const void* w_up,
                           const void* idx, void* y, int M, int K, int nb,
                           int nnz, int b_in, int b_out, int act, int x_dtype,
                           int w_dtype, int device, void* stream) {
  if (b_out < 1 || b_out > NT || NT % b_out != 0 || b_in < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, w_gate, idx, w_up, y, M, K, nb, nnz, b_in,
                                b_out, act, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w_gate, idx, w_up, y, M, K,
                                                nb, nnz, b_in, b_out, act,
                                                stream);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w_gate, idx, w_up, y, M, K, nb,
                                        nnz, b_in, b_out, act, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
