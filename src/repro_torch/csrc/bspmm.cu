// Block-sparse products over packed balanced BCSC, hand-written for
// Hopper (sm_90a). Three kernels, one template:
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
// What bounds it on an H100: at the serving shapes (M = 8 lanes per decode
// step, 8 x 16 rows per prefill chunk) each kept weight block is used by at
// most M rows, about 2 * M / sizeof(weight) operations per weight byte,
// far below the ~295 operations per byte where the tensor cores would
// become the limit. So the kernels are bound by the bytes of the kept
// blocks. The design: one thread block owns one (BM x b_out) output tile
// (grid = (ceil(M / BM), Nb)) and loops over the column's nnz kept blocks,
// the loop that replaces the TPU grid's sequential third axis. Pruned
// blocks are never read; at M <= BM every kept weight byte is read exactly
// once. Each step loads the block's own idx entry, stages the X tile of
// that block-row and the weight block in shared memory (in K chunks of at
// most 16 KB of f32 per operand, so all three kernels stay under the 48 KB
// static limit), and accumulates in f32 registers. The GLU activation is
// applied in the epilogue, so the (M, d_ff) gate and up products never
// reach device memory. Rows past M are masked (the TPU wrapper required
// M % blk_m == 0). Plain f32 FMAs; wgmma, TMA and a pipelined ring are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

// 0 = silu, 1 = gelu (tanh approximation), 2 = relu
__device__ __forceinline__ float act_fn(int act, float g) {
  if (act == 0) return g / (1.0f + expf(-g));
  if (act == 1) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return fmaxf(g, 0.0f);
}

// MODE 0: Y = X Wa.
// MODE 1: Y = act(X Wa) * (X Wb), idx tables ia and ib: two X tiles a step.
// MODE 2: the same with one shared idx table ia: one X tile feeds both.
template <typename TX, typename TW, int MODE>
__global__ void __launch_bounds__(NT)
    bsp_kernel(const TX* __restrict__ x, const TW* __restrict__ wa,
               const int* __restrict__ ia, const TW* __restrict__ wb,
               const int* __restrict__ ib, TX* __restrict__ y, int M, int K,
               int nnz, int b_in, int b_out, int act) {
  constexpr int NX = MODE == 1 ? 2 : 1;  // X tiles per step
  constexpr int NW = MODE == 0 ? 1 : 2;  // weight blocks per step
  __shared__ float xs[NX][BM * KC_MAX];
  __shared__ float ws[NW][W_CAP];

  const int j = blockIdx.y;        // block-column
  const int m0 = blockIdx.x * BM;  // first row of the tile
  const int n = gridDim.y * b_out;
  const int tid = threadIdx.x;
  const int c = tid % b_out;       // output column inside the block
  const int rg = tid / b_out;      // this thread's first row
  const int n_rg = NT / b_out;     // row stride between a thread's rows
  const int kc_max = min(KC_MAX, W_CAP / b_out);

  float acc[NW][BM];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < BM; ++i) acc[w][i] = 0.f;

  for (int k = 0; k < nnz; ++k) {
    const int slot = j * nnz + k;
    const int col_a = ia[slot] * b_in;
    int col_b = col_a;
    if constexpr (MODE == 1) col_b = ib[slot] * b_in;
    const size_t wofs = static_cast<size_t>(slot) * b_in * b_out;
    for (int k0 = 0; k0 < b_in; k0 += kc_max) {
      const int kc = min(kc_max, b_in - k0);
      for (int e = tid; e < BM * kc; e += NT) {
        const int r = e / kc, cc = e % kc, row = m0 + r;
        const size_t base = static_cast<size_t>(row) * K + k0 + cc;
        xs[0][e] = row < M ? ld(x + base + col_a) : 0.f;
        if constexpr (NX == 2) xs[1][e] = row < M ? ld(x + base + col_b) : 0.f;
      }
      const size_t w0 = wofs + static_cast<size_t>(k0) * b_out;
      for (int e = tid; e < kc * b_out; e += NT) {
        ws[0][e] = ld(wa + w0 + e);
        if constexpr (NW == 2) ws[1][e] = ld(wb + w0 + e);
      }
      __syncthreads();
      if (rg < BM) {
        for (int kk = 0; kk < kc; ++kk) {
          const float wva = ws[0][kk * b_out + c];
          float wvb = 0.f;
          if constexpr (NW == 2) wvb = ws[1][kk * b_out + c];
#pragma unroll
          for (int i = 0; i < BM; ++i) {
            const int r = rg + i * n_rg;
            if (r < BM) {
              acc[0][i] += xs[0][r * kc + kk] * wva;
              if constexpr (NW == 2) acc[1][i] += xs[NX - 1][r * kc + kk] * wvb;
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
        float v = acc[0][i];
        if constexpr (NW == 2) v = act_fn(act, v) * acc[1][i];
        st(y + static_cast<size_t>(row) * n + static_cast<size_t>(j) * b_out + c, v);
      }
    }
  }
}

template <typename TX, typename TW, int MODE>
int launch(const void* x, const void* wa, const void* ia, const void* wb,
           const void* ib, void* y, int M, int K, int nb, int nnz, int b_in,
           int b_out, int act, void* stream) {
  const dim3 grid((M + BM - 1) / BM, nb);
  bsp_kernel<TX, TW, MODE><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(wa),
      static_cast<const int*>(ia), static_cast<const TW*>(wb),
      static_cast<const int*>(ib), static_cast<TX*>(y), M, K, nnz, b_in, b_out,
      act);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 = float32, 1 = bfloat16. X may be f32 over bf16 weights
// (the f32 test configs serve bf16-packed weights).
template <int MODE>
int dispatch(int x_dtype, int w_dtype, const void* x, const void* wa,
             const void* ia, const void* wb, const void* ib, void* y, int M,
             int K, int nb, int nnz, int b_in, int b_out, int act, int device,
             void* stream) {
  if (b_out < 1 || b_out > NT || NT % b_out != 0 || b_in < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float, MODE>(x, wa, ia, wb, ib, y, M, K, nb, nnz, b_in,
                                      b_out, act, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, MODE>(
        x, wa, ia, wb, ib, y, M, K, nb, nnz, b_in, b_out, act, stream);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16, MODE>(x, wa, ia, wb, ib, y, M, K, nb,
                                              nnz, b_in, b_out, act, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int bspmm_launch(const void* x, const void* blocks, const void* idx, void* y,
                 int M, int K, int nb, int nnz, int b_in, int b_out,
                 int x_dtype, int w_dtype, int device, void* stream) {
  return dispatch<0>(x_dtype, w_dtype, x, blocks, idx, blocks, idx, y, M, K, nb,
                     nnz, b_in, b_out, 0, device, stream);
}

int fused_glu_split_launch(const void* x, const void* w_gate,
                           const void* idx_gate, const void* w_up,
                           const void* idx_up, void* y, int M, int K, int nb,
                           int nnz, int b_in, int b_out, int act, int x_dtype,
                           int w_dtype, int device, void* stream) {
  return dispatch<1>(x_dtype, w_dtype, x, w_gate, idx_gate, w_up, idx_up, y, M,
                     K, nb, nnz, b_in, b_out, act, device, stream);
}

int fused_glu_joint_launch(const void* x, const void* w_gate, const void* w_up,
                           const void* idx, void* y, int M, int K, int nb,
                           int nnz, int b_in, int b_out, int act, int x_dtype,
                           int w_dtype, int device, void* stream) {
  return dispatch<2>(x_dtype, w_dtype, x, w_gate, idx, w_up, idx, y, M, K, nb,
                     nnz, b_in, b_out, act, device, stream);
}

}  // extern "C"
