// Grouped (per-expert) GEMM for Hopper: y[e] = x[e] @ w[e] for every expert e,
// x: (E, C, K), w: (E, K, N) -> y: (E, C, N), fp32 accumulator, no epilogue.
//
// Replaces the TPU kernel repro/kernels/grouped/kernel.py::_grouped_kernel
// (launched by grouped_matmul_call), the MoE expert GEMM.  The TPU grid is
// (E, C/bc, N/bn, K/bk) with k innermost and sequential.  Here it is the
// systolic GEMM batched over experts (gemm.cuh): the expert is the grid's z
// axis, each block offsets x, w and y to its expert's matrices, and k is the
// loop inside the block, so every expert slice is an independent (C, K) @
// (K, N) product with a C-stationary fp32 accumulator.
//
// What bounds it on the card: the MoE path computes every expert's C
// capacity rows, so each call reads all E expert weights once.  At prefill
// (C = 160 rows of 2048 tokens x 8 / 128 experts x 1.25) a call does about
// 125 operations per byte, below the H100's ~295 FLOP/byte balance, and at
// decode (C = 8) about 8: both are bound by reading w from HBM.
// What the design does about that, kept simple for a first version:
//   * the tile is chosen by C as the systolic GEMM chooses it by M: for
//     C <= 16 (decode) a 16-row tile with 4 warps over 64 columns, so a block
//     does not stage 128 rows for 8; otherwise the 128x128 tile (at C = 160
//     it computes 256 rows, 37.5 % of them padding).  No split-K: E x N/BN
//     blocks (768 at N = 768, BN = 128) already fill the 132 SMs.
//   * blocks of one expert are adjacent in launch order (x fastest, then y,
//     then z), so the row tiles that share a weight tile run together and
//     the second read comes from L2.
//   * fp32 operands take the CUDA-core FMA tile (the reference computes fp32
//     products in full fp32; TF32 would not match it).
//   * ragged C, K and N are masked while staging and at the store; empty
//     capacity slots are zero rows and are computed, as in the reference.
// Not yet used (later work): wgmma, TMA, skipping empty capacity rows.

#include "gemm.cuh"

// x: (E, C, K), w: (E, K, N), y: (E, C, N), all row-major and of dtype
// `dtype` (bf16 or fp32).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int grouped_mmm(const void* x, const void* w, void* y, int E, int C, int K, int N,
                           int dtype, void* stream) {
  return repro::gemm<true>(x, w, nullptr, y, C, N, K, E, dtype, dtype, repro::ACT_NONE, nullptr,
                           0, static_cast<cudaStream_t>(stream));
}
