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
// TPU grid runs its "arbitrary" axes in sequence. Here the host builds,
// once per fixed mask (kernels/bspmm_t.py::TransposedPlan, at
// make_bspmm_trainable time), the transposed visit lists: for every output
// block-row r the flat slots j * nnz + k with idx == r, in (j, k) order,
// and cuts each list into S <= 8 chunks. The shared main loops of
// bsp_mma.cuh (FWD = false) run one output tile per cluster of S CTAs, A =
// the dY tile at block-column j, B = the block read as its transpose (plain
// ldmatrix of the row-major block gives the col fragment), and sum the
// chunks' f32 partials in rank order through distributed shared memory:
// one launch, no atomics, bitwise deterministic, rounded once to dY's type
// as the XLA twin bspmm_t_xla does. A row no kept block visits writes
// zeros; global-selection padding (zero blocks at idx 0) makes row 0's
// list long (101 visits on the served down shape) but adds exact zeros,
// and the split cuts that tail by up to 8x.
//
// What bounds it on an H100: at the fine-tuning shapes (M = 1024 tokens,
// 128 x 128 blocks) each weight block is used by M rows, ~1024 operations
// per weight byte, far above the ~295 where the tensor cores become the
// limit. So bf16 runs on tensor cores (mma.sync m16n8k16, a 4-stage
// cp.async ring; tile and split chosen by kernels/split_plan.py); f32 keeps
// full f32 FMAs (no TF32: the tolerance is 1e-4 of the output) in the
// shared FMA loop, with the same lists and ring.
#include "bsp_mma.cuh"

extern "C" {

// visits: the flat slots by output block-row; bounds: (kb, splits + 1)
// int32 chunk starts into visits; kernel: the id of bsp::run; bn, bk: the
// FMA loop's tile width and K chunk. dtype codes: 0 float32, 1 bfloat16;
// dY may be f32 over bf16 weights. Returns cudaGetLastError() after the
// launch (0 = launched).
int bspmm_t_launch(const void* dy, const void* blocks, const void* visits,
                   const void* bounds, void* dx, int M, int kb, int nb,
                   int nnz, int b_in, int b_out, int n_split, int splits,
                   int kernel, int bn, int bk, int dy_dtype, int w_dtype,
                   int device, void* stream) {
  bsp::Args a{dy, blocks, nullptr, static_cast<const int*>(visits),
              static_cast<const int*>(bounds), dx, M, nb * b_out, kb * b_in,
              nnz, b_in, b_out, n_split, bn, bk};
  return bsp::run<false>(a, kb, kernel, splits, dy_dtype, w_dtype, device,
                         stream);
}

}  // extern "C"
