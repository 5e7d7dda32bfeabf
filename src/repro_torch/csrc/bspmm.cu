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
// All three products run the shared main loops of bsp_mma.cuh (FWD =
// true): the visit list of output block-column j is its nnz slots, A is
// the X tile at block-row idx[j, k], B the row-major block
// (ldmatrix.trans). What bounds bspmm on an H100, at the served shapes
// (Llama-3.2-1B down projection, 16 block-columns of 13 kept 128 x 128
// bf16 blocks, 6.8 MB):
//  * decode, M = 8 rows: bound by the weight bytes (a byte feeds ~8
//    operations, against ~295 where the tensor cores would set the pace).
//    Only 16 output tiles exist, so the host splits each column's 13
//    visits over a cluster of up to 8 CTAs and the 128-wide block into two
//    64-wide tiles: 16 x 2 x S CTAs, each streaming a few 16 KB half
//    blocks through a 4-stage cp.async ring (32-48 KB in flight per CTA),
//    with M padded to one 16-row mma tile (kernel 3, 16 x 64 x 128).
//  * prefill chunk, M = 128, and fine-tuning, M = 1024: the 128 x 128 x 64
//    tile (kernel 5) or the 64 x 64 x 64 one (kernel 4), chosen with the
//    split by the host's cost model (kernels/split_plan.py); at M = 1024
//    the work is bound by operations (each weight byte feeds ~1024).
// f32, f32 X over bf16 weights, and block sides that are no multiple of 16
// take the f32 FMA loop (kernels 0 and 1). The host chooses by dtype,
// shape and alignment before the launch and raises on what no kernel
// takes.
//
// The fused GLU runs the same main loops in a GLU mode (bsp_mma.cuh): each
// visit stages the gate and the up block, beside the X tiles at idx_gate
// and idx_up (split) or beside the one X tile at the shared idx (joint,
// packs marked joint), and the cluster reduction applies the activation
// to the f32 sums. At decode (M = 8, W_gate and W_up each 64 block-columns
// of 4 kept 128 x 128 bf16 blocks, 8.4 MB each) both modes are bound by
// those weight bytes: a weight byte feeds ~8 operations. 64 columns in
// two 64-wide halves give 128 CTAs of the 16 x 64 x 128 tile, each
// streaming its 4 visits (two 16 KB weight tiles each) through a 4-stage
// ring; the ring (182 KB split, 165 KB joint) leaves one CTA to an SM, so
// the host splits no further than one wave. The joint mode's one X tile
// per visit saves 10% of a stage at decode (a 16-row X tile is small
// beside two weight tiles) and 26% at the 128-row prefill chunk (128 x
// 128 x 64 tile), where an X tile is as large as a weight tile.
//
// Expert-batched launch (the MoE layer, models/moe.py; the TPU kernels run
// under vmap there, which adds a grid axis): with batch = E > 1 all three
// take X (E, M, K), blocks (E, Nb, nnz, b_in, b_out), idx (E, Nb, nnz) and
// write Y (E, M, N), every expert in one launch. The grid's z axis runs
// over the E experts' row tiles, and a CTA offsets its X and Y rows and its
// slots by its expert's (Args::batch). A balanced pack has the same nnz in
// every column of every expert, so one set of chunk bounds serves all E.
// The batch is an instantiation of its own (bsp_mma.cuh, BAT), so a single
// matrix runs the code it ran before the batch existed.
#include <cuda_runtime.h>

#include "bsp_mma.cuh"

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
// bounds: (Nb, splits + 1) int32 chunk starts into the flat slots
// j * nnz + k (kernels/split_plan.py); batch: the experts of a batched
// launch (1: one matrix); kernel: the id of bsp::run; bn, bk: the FMA
// loop's tile width and K chunk (ignored by the tensor-core ones).
int bspmm_launch(const void* x, const void* blocks, const void* idx,
                 const void* bounds, void* y, int batch, int M, int K, int nb,
                 int nnz, int b_in, int b_out, int n_split, int splits,
                 int kernel, int bn, int bk, int x_dtype, int w_dtype,
                 int device, void* stream) {
  bsp::Args a{x, blocks, static_cast<const int*>(idx), nullptr,
              static_cast<const int*>(bounds), y, M, K, nb * b_out, nnz,
              b_in, b_out, n_split, bn, bk};
  a.batch = batch;
  return bsp::run<true>(a, nb, kernel, splits, x_dtype, w_dtype, device,
                        stream);
}

// The split fused GLU: bspmm's arguments plus the up blocks, their idx
// table and the activation id (0 silu, 1 gelu, 2 relu).
int fused_glu_split_launch(const void* x, const void* w_gate,
                           const void* idx_gate, const void* w_up,
                           const void* idx_up, const void* bounds, void* y,
                           int batch, int M, int K, int nb, int nnz, int b_in,
                           int b_out, int n_split, int splits, int kernel,
                           int bn, int bk, int act, int x_dtype, int w_dtype,
                           int device, void* stream) {
  bsp::Args a{x, w_gate, static_cast<const int*>(idx_gate), nullptr,
              static_cast<const int*>(bounds), y, M, K, nb * b_out, nnz,
              b_in, b_out, n_split, bn, bk, w_up,
              static_cast<const int*>(idx_up), act, batch};
  return bsp::run<true, bsp::SPLIT_GLU>(a, nb, kernel, splits, x_dtype,
                                        w_dtype, device, stream);
}

// The joint fused GLU: the split launcher's arguments without idx_up
// (gate and up share idx).
int fused_glu_joint_launch(const void* x, const void* w_gate, const void* idx,
                           const void* w_up, const void* bounds, void* y,
                           int batch, int M, int K, int nb, int nnz, int b_in,
                           int b_out, int n_split, int splits, int kernel,
                           int bn, int bk, int act, int x_dtype, int w_dtype,
                           int device, void* stream) {
  bsp::Args a{x, w_gate, static_cast<const int*>(idx), nullptr,
              static_cast<const int*>(bounds), y, M, K, nb * b_out, nnz,
              b_in, b_out, n_split, bn, bk, w_up, nullptr, act, batch};
  return bsp::run<true, bsp::JOINT_GLU>(a, nb, kernel, splits, x_dtype,
                                        w_dtype, device, stream);
}

}  // extern "C"
