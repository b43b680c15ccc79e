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
// The caller picks one of nine paths (kernels/systolic/kernel.py: a tuned plan's,
// or gemm_path's by shape and B's layout; passed in as `path`, never a retry):
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
//     chosen so about four blocks per SM read B, or given (`k_chunk`: a
//     tuned plan's contraction per block).
//   * fp32 operands: a CUDA-core FMA tile, because the reference computes
//     fp32 products in full fp32 (TF32 would not match it).
//   * B K-major (the (K, N) values stored as an (N, K) row-major matrix):
//     the decode, WMMA and FMA tiles above, each staging B's tiles from the
//     (N, K) storage (gemm.cuh KMB).  A tied head multiplies by the
//     transpose of the (V, d) embedding table; reading the table so, in
//     place, saves a transposed copy of it on every call (272 MB for a
//     151655 x 896 bf16 table).  A decode head (M <= 16) is bound by reading
//     the table once, as any decode projection is by its weight.  The wgmma
//     tiles read B N-major through TMA and take none.
// The wgmma tile is in wgmma_gemm.cuh and the WMMA and FMA kernels and their
// launch in gemm.cuh, all shared with the grouped expert GEMM
// (grouped_mmm.cu); the Hopper building blocks are in hopper.cuh.  No path uses atomics: every output element is written once by
// one thread, so two runs give the same bits.

#include "gemm.cuh"
#include "wgmma_gemm.cuh"

using namespace repro;

namespace {

// Paths, as numbered by the Python binding's PATHS.
enum Path {
  P_FMA = 0, P_DECODE = 1, P_WMMA = 2, P_WGMMA_128 = 3, P_WGMMA_64 = 4, P_WGMMA_256 = 5,
  P_FMA_KMAJOR = 6, P_DECODE_KMAJOR = 7, P_WMMA_KMAJOR = 8
};

template <typename O>
int dispatch(int path, const void* a, const void* b, const float* bias, void* out, int M, int N, int K, int act,
             int k_chunk, float* workspace, cudaStream_t s, LaunchQuery* q = nullptr) {
  int e = 0;
  switch (path) {
    case P_FMA:
      e = launch_f32<false, O>(a, b, bias, out, M, N, K, act, 1, s, nullptr, q);
      break;
    case P_DECODE:
      e = launch_bf16<false, D_BM, D_BN, D_BK, 1, 4, O>(a, b, bias, out, M, N, K, act, 1, s,
                                                        plan_split(M, N, K, true, k_chunk), workspace, nullptr, q);
      break;
    case P_WMMA:
      e = launch_bf16<false, 128, 128, 32, 2, 4, O>(a, b, bias, out, M, N, K, act, 1, s, {1, 0}, nullptr, nullptr,
                                                    q);
      break;
    case P_WGMMA_256:
      e = wg::launch_wgmma<false, 2, 256, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s, q);
      break;
    case P_WGMMA_128:
      e = wg::launch_wgmma<false, 2, 128, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s, q);
      break;
    case P_WGMMA_64:
      e = wg::launch_wgmma<false, 1, 128, O>(a, b, bias, out, M, N, K, act, 1, nullptr, s, q);
      break;
    case P_FMA_KMAJOR:
      e = launch_f32<false, O, true>(a, b, bias, out, M, N, K, act, 1, s, nullptr, q);
      break;
    case P_DECODE_KMAJOR:
      e = launch_bf16<false, D_BM, D_BN, D_BK, 1, 4, O, true>(a, b, bias, out, M, N, K, act, 1, s,
                                                              plan_split(M, N, K, true, k_chunk), workspace, nullptr,
                                                              q);
      break;
    case P_WMMA_KMAJOR:
      e = launch_bf16<false, 128, 128, 32, 2, 4, O, true>(a, b, bias, out, M, N, K, act, 1, s, {1, 0}, nullptr,
                                                          nullptr, q);
      break;
  }
  return e != 0 || q != nullptr ? e : static_cast<int>(cudaGetLastError());
}

// The entry point's checks of everything but the pointers and the workspace
// (`aligned`: the bases are 16-byte aligned).
bool valid_call(int M, int N, int K, int in_dtype, int out_dtype, int activation, int path, int k_chunk,
                bool aligned) {
  const bool fp32 = in_dtype == DT_F32;
  const bool wgmma = path >= P_WGMMA_128 && path <= P_WGMMA_256;
  const bool decode = path == P_DECODE || path == P_DECODE_KMAJOR;
  return !((in_dtype != DT_F32 && in_dtype != DT_BF16) || (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
           activation < ACT_NONE || activation > ACT_TANH || M <= 0 || N <= 0 || K < 0 || path < P_FMA ||
           path > P_WMMA_KMAJOR || fp32 != (path == P_FMA || path == P_FMA_KMAJOR) || (decode && M > D_BM) ||
           (wgmma && (K == 0 || K % 8 != 0 || N % 8 != 0 || !aligned)) || k_chunk < 0 ||
           (k_chunk > 0 && (!decode || k_chunk % D_BK != 0)));
}

}  // namespace

// a: (M, K) row-major, b: (K, N) row-major -- or, on a *_KMAJOR path,
// K-major (stored as (N, K) row-major) --, both of dtype `in_dtype`; bias:
// (N,) fp32 or null; out: (M, N) row-major of dtype `out_dtype`; `path`: one
// of Path, which must fit the operands (fp32 <-> an FMA path; the decode
// tiles M <= 16; wgmma K and N multiples of 8 and 16-byte-aligned bases);
// `k_chunk`: 0, or on a decode tile the contraction per block, a multiple of
// D_BK (0: plan_split's choice); workspace: at least split_workspace(M, N,
// K, path is a decode tile, k_chunk) bytes (null if that is 0).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int systolic_mmm(const void* a, const void* b, const void* bias, void* out, int M, int N, int K,
                            int in_dtype, int out_dtype, int activation, int path, int k_chunk,
                            void* workspace, long long workspace_bytes, void* stream) {
  const bool decode = path == P_DECODE || path == P_DECODE_KMAJOR;
  if (!valid_call(M, N, K, in_dtype, out_dtype, activation, path, k_chunk, aligned16(a) && aligned16(b)) ||
      workspace_bytes < split_workspace(M, N, K, decode, k_chunk) || (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* bs = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == DT_F32 ? dispatch<float>(path, a, b, bs, out, M, N, K, activation, k_chunk, ws, s)
                             : dispatch<__nv_bfloat16>(path, a, b, bs, out, M, N, K, activation, k_chunk, ws, s);
}

// What a systolic_mmm launch of `path` at (M, N, K) with these dtypes and
// `k_chunk` runs, taken from the dispatch above with a LaunchQuery (no
// launch): QUERY_FIELDS values into `out`.  Returns 0, or the code the
// launch's checks would give (aligned bases assumed).
extern "C" int systolic_mmm_query(int M, int N, int K, int in_dtype, int out_dtype, int path, int k_chunk,
                                  long long* out) {
  if (!valid_call(M, N, K, in_dtype, out_dtype, ACT_NONE, path, k_chunk, true))
    return static_cast<int>(cudaErrorInvalidValue);
  LaunchQuery q{};
  const int e = out_dtype == DT_F32
                    ? dispatch<float>(path, nullptr, nullptr, nullptr, nullptr, M, N, K, ACT_NONE, k_chunk, nullptr,
                                      nullptr, &q)
                    : dispatch<__nv_bfloat16>(path, nullptr, nullptr, nullptr, nullptr, M, N, K, ACT_NONE, k_chunk,
                                              nullptr, nullptr, &q);
  if (e == 0) export_query(q, out);
  return e;
}
