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
// ~295 FLOP/byte balance, so it is bound by tensor-core throughput; a
// decode projection (M = 4) does 4 operations per byte, so it is bound by
// reading B from HBM.  What holds the wgmma tiles below the tensor cores'
// rate (measured on the H100, PERF.md): the main loop re-reads A and B from
// L2 for every output tile, and each block fills and drains its own ring (no
// persistent blocks), so the narrow tiles lose most and the 128x256 tile
// least; and the epilogue, which writes an output tile as wide as the reads
// that fed it.
//
// The caller picks one of six paths by shape (kernels/systolic/kernel.py
// gemm_path, passed in as `path`; a choice by shape, never a retry):
//   * wgmma tiles (bf16, M > 16, K and N multiples of 8, 16-byte-aligned
//     bases) -- the prefill tile built for Hopper, 128x256, 128x128 or
//     64x128, the widest whose grid leaves at most half the SMs idle.
//     Warp-specialised: one producer warp issues TMA loads of A (K-major)
//     and B (N-major) into a ring of four 64-deep k stages in
//     128-byte-swizzled shared memory, with a full and an empty mbarrier per
//     stage; each consumer warpgroup runs wgmma m64n{128,256}k16 on 64 rows,
//     both operands from shared memory (B through the transpose bit),
//     keeping one k stage of products in flight while it issues the next.
//     With two consumers, setmaxnreg moves registers from the producer
//     warpgroup to them.  TMA zero-fills ragged M, N and K.  The epilogue
//     adds the bias, applies the activation and casts in the accumulator
//     registers (their row and column follow from the wgmma layout), then
//     stages the tile through the drained ring, swizzled, so that each warp
//     stores whole rows, masked at the edge.  One block per SM.
//   * WMMA 128x128 tile (bf16 shapes TMA cannot take: K or N not a multiple
//     of 8, or an unaligned base): WMMA 16x16x16, two cp.async stages,
//     ragged edges masked while staging.
//   * WMMA decode tile (bf16, M <= 16): a 16-row tile with the contraction
//     split across blocks (split-K); a second, small kernel sums the fp32
//     partials in a fixed order and applies the epilogue.  The split is
//     chosen so about four blocks per SM read B.
//   * fp32 operands: a CUDA-core FMA tile, because the reference computes
//     fp32 products in full fp32 (TF32 would not match it).
// The wgmma tile is in wgmma_gemm.cuh and the WMMA and FMA kernels and their
// launch in gemm.cuh, all shared with the grouped expert GEMM
// (grouped_mmm.cu); the Hopper building blocks are in hopper.cuh.  No path uses atomics: every output element is written once by
// one thread, so two runs give the same bits.

#include "gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace repro;

namespace {

// Paths, as numbered by the Python binding's PATHS.
enum Path { P_FMA = 0, P_DECODE = 1, P_WMMA = 2, P_WGMMA_128 = 3, P_WGMMA_64 = 4, P_WGMMA_256 = 5 };

template <typename O>
int dispatch(int path, const void* a, const void* b, const float* bias, void* out, int M, int N, int K, int act,
             float* workspace, cudaStream_t s) {
  switch (path) {
    case P_FMA:
      launch_f32<false, O>(a, b, bias, out, M, N, K, act, 1, s);
      break;
    case P_DECODE:
      launch_bf16<false, D_BM, D_BN, D_BK, 1, 4, O>(a, b, bias, out, M, N, K, act, 1, s,
                                                    plan_split(M, N, K, true), workspace);
      break;
    case P_WMMA:
      launch_bf16<false, 128, 128, 32, 2, 4, O>(a, b, bias, out, M, N, K, act, 1, s);
      break;
    case P_WGMMA_256:
      return wg::launch_wgmma<false, 2, 256, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s);
    case P_WGMMA_128:
      return wg::launch_wgmma<false, 2, 128, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s);
    case P_WGMMA_64:
      return wg::launch_wgmma<false, 1, 128, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a: (M, K), b: (K, N), both row-major and of dtype `in_dtype`; bias: (N,)
// fp32 or null; out: (M, N) row-major of dtype `out_dtype`; `path`: one of
// Path, which must fit the operands (fp32 <-> FMA; the decode tile M <= 16;
// wgmma K and N multiples of 8 and 16-byte-aligned bases); workspace: at
// least split_workspace(M, N, K, path == decode) bytes (null if that is 0).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int systolic_mmm(const void* a, const void* b, const void* bias, void* out, int M, int N, int K,
                            int in_dtype, int out_dtype, int activation, int path, void* workspace,
                            long long workspace_bytes, void* stream) {
  const bool fp32 = in_dtype == DT_F32;
  const bool wgmma = path >= P_WGMMA_128;
  if ((in_dtype != DT_F32 && in_dtype != DT_BF16) || (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
      activation < ACT_NONE || activation > ACT_TANH || M <= 0 || N <= 0 || K < 0 || path < P_FMA ||
      path > P_WGMMA_256 || fp32 != (path == P_FMA) || (path == P_DECODE && M > D_BM) ||
      (wgmma && (K == 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(a) || !aligned16(b))) ||
      workspace_bytes < split_workspace(M, N, K, path == P_DECODE) ||
      (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bs = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == DT_F32 ? dispatch<float>(path, a, b, bs, out, M, N, K, activation, ws, s)
                             : dispatch<__nv_bfloat16>(path, a, b, bs, out, M, N, K, activation, ws, s);
}
