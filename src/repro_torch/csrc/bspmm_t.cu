// Transposed block-sparse product dX = dY W^T over packed balanced BCSC,
// hand-written for Hopper (sm_90a): the backward of bspmm that makes packed
// weights trainable.
//
//   bspmm_t  replaces src/repro/kernels/bspmm_t.py  _bspmm_t_kernel / bspmm_t
//
// Layout (core/packing.py): W is blocks (Nb, nnz, b_in, b_out) plus idx
// (Nb, nnz) int32, the block-row of each kept block. dY is (M, Nb * b_out)
// row-major, dX is (M, Kb * b_in) row-major in dY's type.
//
// Kept block (j, k) of W adds dY[:, block-column j] W[j, k]^T into output
// block-row idx[j, k]. The TPU kernel walks (j, k) in order and does a
// read-modify-write into the revisited output tile, safe only because the
// TPU grid runs its "arbitrary" axes in sequence. Thread blocks on the GPU
// run concurrently, so that scheme would race. Instead the wrapper builds a
// transposed table on the host (kernels/bspmm_t.py::transposed_table): for
// every output block-row r the flat slots s = j * nnz + k with idx == r, in
// (j, k) order, padded with -1. One thread block owns one (BM x b_in) tile
// of dX (grid = (ceil(M / BM), Kb)), walks its row's list, accumulates in
// f32 registers and writes once, rounding once to dY's type, as the XLA twin
// bspmm_t_xla does. No atomics, no second pass, and the result does not
// depend on scheduling. A row no kept block visits writes zeros. Padding
// blocks of global-selection masks are zero blocks at idx 0, so their
// duplicate visits of row 0 add exact zeros.
//
// What bounds it on an H100: at the training shapes (M = 1024 tokens,
// 128 x 128 blocks) each weight block is used by M rows, about 2 * M /
// sizeof(weight) operations per weight byte, far above the ~295 operations
// per byte where the tensor cores become the limit. So the work is bound by
// operations. This first kernel uses plain f32 FMAs from shared memory (a
// floor of ops / 67 TFLOP/s); wgmma, TMA and a ring are later work. Each
// step stages a (BM x OC) tile of dY and an (OC x b_in) chunk of the weight
// block, transposed in shared memory with one padding column, so the
// per-thread reads run along b_in without bank conflicts. Rows past M are
// masked (the TPU wrapper required M % blk_m == 0). Rows of one tile see the
// same visit list, so the imbalance between block-rows (a few visits against
// many) is imbalance between thread blocks, which the hardware scheduler
// spreads over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 32;   // rows of dY per thread block
constexpr int NT = 256;  // threads per block
constexpr int OC = 32;   // b_out columns per staged chunk

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype does
}

template <typename TY, typename TW>
__global__ void __launch_bounds__(NT)
    bspmm_t_kernel(const TY* __restrict__ dy, const TW* __restrict__ w,
                   const int* __restrict__ table, TY* __restrict__ dx, int M,
                   int N, int nvis, int nnz, int b_in, int b_out) {
  __shared__ float ys[BM * OC];
  __shared__ float wt[OC * (NT + 1)];  // wt[o * (b_in + 1) + i] = W[i][o]

  const int r = blockIdx.y;        // output block-row
  const int m0 = blockIdx.x * BM;  // first row of the tile
  const int K = gridDim.y * b_in;
  const int tid = threadIdx.x;
  const int c = tid % b_in;        // output column inside the block
  const int rg = tid / b_in;       // this thread's first row
  const int n_rg = NT / b_in;      // row stride between a thread's rows
  const int ldw = b_in + 1;
  const int oc_max = min(OC, b_out);

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int v = 0; v < nvis; ++v) {
    const int slot = table[r * nvis + v];
    if (slot < 0) break;  // the list is padded at its end
    const int j = slot / nnz;
    const size_t wofs = static_cast<size_t>(slot) * b_in * b_out;
    for (int o0 = 0; o0 < b_out; o0 += oc_max) {
      const int oc = min(oc_max, b_out - o0);
      for (int e = tid; e < BM * oc; e += NT) {
        const int rr = e / oc, oo = e % oc, row = m0 + rr;
        ys[e] = row < M ? ld(dy + static_cast<size_t>(row) * N +
                             static_cast<size_t>(j) * b_out + o0 + oo)
                        : 0.f;
      }
      for (int e = tid; e < b_in * oc; e += NT) {
        const int i = e / oc, oo = e % oc;
        wt[oo * ldw + i] = ld(w + wofs + static_cast<size_t>(i) * b_out + o0 + oo);
      }
      __syncthreads();
      for (int oo = 0; oo < oc; ++oo) {
        const float wv = wt[oo * ldw + c];
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const int rr = rg + i * n_rg;
          if (rr < BM) acc[i] += ys[rr * oc + oo] * wv;
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int rr = rg + i * n_rg, row = m0 + rr;
    if (rr < BM && row < M)
      st(dx + static_cast<size_t>(row) * K + static_cast<size_t>(r) * b_in + c,
         acc[i]);
  }
}

template <typename TY, typename TW>
int launch(const void* dy, const void* w, const void* table, void* dx, int M,
           int kb, int nb, int nnz, int nvis, int b_in, int b_out,
           void* stream) {
  const dim3 grid((M + BM - 1) / BM, kb);
  bspmm_t_kernel<TY, TW><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TY*>(dy), static_cast<const TW*>(w),
      static_cast<const int*>(table), static_cast<TY*>(dx), M, nb * b_out,
      nvis, nnz, b_in, b_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16; dY may be f32 over bf16 weights.
// table is (kb, nvis) int32 of flat slots j * nnz + k, padded with -1.
// Returns cudaGetLastError() after the launch (0 = launched).
int bspmm_t_launch(const void* dy, const void* blocks, const void* table,
                   void* dx, int M, int kb, int nb, int nnz, int nvis,
                   int b_in, int b_out, int dy_dtype, int w_dtype, int device,
                   void* stream) {
  if (b_in < 1 || b_in > NT || NT % b_in != 0 || b_out < 1 || nvis < 1 ||
      M < 1 || kb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dy_dtype == 0 && w_dtype == 0)
    return launch<float, float>(dy, blocks, table, dx, M, kb, nb, nnz, nvis,
                                b_in, b_out, stream);
  if (dy_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        dy, blocks, table, dx, M, kb, nb, nnz, nvis, b_in, b_out, stream);
  if (dy_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16>(dy, blocks, table, dx, M, kb, nb, nnz,
                                        nvis, b_in, b_out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
