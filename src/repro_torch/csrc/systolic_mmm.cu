// Systolic GEMM for Hopper: C[M,N] = act(A[M,K] @ B[K,N] [+ bias[N]]), fp32 accumulator.
//
// Replaces the TPU kernels repro/kernels/systolic/kernel.py::_mmm_kernel and
// ::_mmm_bias_kernel (both launched by systolic_matmul_call).  Same blocking
// as there: each block owns one (BM, BN) tile of C and keeps its fp32
// accumulator resident (the C-stationary accumulator) while it walks the
// contraction in BK steps.  The TPU runs k as the innermost sequential grid
// dimension; blocks on the card run in no order, so k becomes the loop inside
// each block.  The bias + activation epilogue and the cast to the output
// dtype are applied once, after the last k step, as in the TPU kernel.
//
// What bounds it on the card: a prefill projection (M = 2048 tokens) does
// about 2048 operations per byte of weights read, far above the H100's
// ~295 FLOP/byte balance, so it is bound by tensor-core throughput.  A decode
// projection (M = 4) does 4, so it is bound by reading B from HBM.
// What the design does about that, kept simple for a first version:
//   * bf16 operands go through the tensor cores (WMMA 16x16x16 bf16 -> fp32);
//     fp32 operands take a CUDA-core FMA path, because the reference computes
//     fp32 products in full fp32 (TF32 would not match it).
//   * tiles are staged in shared memory with cp.async, two stages deep, so the
//     next k tile loads while the current one is multiplied.
//   * for M <= 16 (decode) a 16-row tile is used, and the contraction is
//     split across blocks (split-K): N/64 column tiles alone would keep at
//     most 32 of the 132 SMs reading B for N <= 2048.  Each (column tile,
//     K slice) block writes an fp32 partial; a second, small kernel sums the
//     partials in a fixed order and applies the bias / activation / cast
//     epilogue.  The split is chosen so about four blocks per SM read B.
//   * ragged M, N and K are masked while staging (zero fill) and at the
//     store, so callers never pad.
// The kernels and their launch are in gemm.cuh, shared with the grouped
// expert GEMM (grouped_mmm.cu), which runs the same product batched over
// experts.  Not yet used (later work): wgmma, TMA, warp specialisation.

#include "gemm.cuh"

// a: (M, K), b: (K, N), both row-major and of dtype `in_dtype`; bias: (N,)
// fp32 or null; out: (M, N) row-major of dtype `out_dtype`; workspace: at
// least split_workspace(M, N, K, in_dtype == bf16) bytes (null if that is
// 0).  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int systolic_mmm(const void* a, const void* b, const void* bias, void* out, int M,
                            int N, int K, int in_dtype, int out_dtype, int activation,
                            void* workspace, long long workspace_bytes, void* stream) {
  return repro::gemm<false>(a, b, static_cast<const float*>(bias), out, M, N, K, 1, in_dtype,
                            out_dtype, activation, workspace, workspace_bytes,
                            static_cast<cudaStream_t>(stream));
}
