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
// Not yet used (later work): wgmma, TMA, warp specialisation.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using repro::ACT_NONE;
using repro::ACT_TANH;
using repro::from_f32;
using repro::D_BK;
using repro::D_BM;
using repro::D_BN;
using repro::plan_split;
using repro::Split;
using repro::store_out;
using repro::to_f32;

namespace {

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA.
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
struct TcCfg {
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M;  // warp tile
  static constexpr int WTN = BN / WARPS_N;
  static constexpr int FM = WTM / 16;       // 16x16 fragments per warp tile
  static constexpr int FN = WTN / 16;
  static constexpr int LDA = BK + 8;        // +16 bytes per row against bank conflicts
  static constexpr int LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, typename O>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    mmm_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K,
                    int act, bool vec_a, bool vec_b, int k_chunk, float* __restrict__ partial) {
  // Block z of the grid contracts K slice [z * k_chunk, (z + 1) * k_chunk);
  // k_chunk is a multiple of BK, so only the last slice meets K's ragged end.
  // With `partial` set, the raw fp32 sums go to partial[z] (M x N) and the
  // epilogue is left to splitk_reduce.
  using C = TcCfg<BM, BN, BK, WARPS_M, WARPS_N>;
  __shared__ __align__(128) __nv_bfloat16 As[2][C::A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][C::B_ELEMS];
  __shared__ __align__(128) float epi[WARPS_M * WARPS_N][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FM][C::FN];
#pragma unroll
  for (int i = 0; i < C::FM; ++i)
#pragma unroll
    for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int kb = blockIdx.z * k_chunk;
  const int nk = (min(K, kb + k_chunk) - kb + BK - 1) / BK;
  if (nk > 0) {
    repro::load_tile<__nv_bfloat16, BM, BK, C::LDA, C::NT>(As[0], A, M, K, m0, kb, vec_a);
    repro::load_tile<__nv_bfloat16, BK, BN, C::LDB, C::NT>(Bs[0], B, K, N, kb, n0, vec_b);
  }
  repro::cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next k tile into the other stage
      const int k1 = kb + (kt + 1) * BK;
      repro::load_tile<__nv_bfloat16, BM, BK, C::LDA, C::NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      repro::load_tile<__nv_bfloat16, BK, BN, C::LDB, C::NT>(Bs[cur ^ 1], B, K, N, k1, n0, vec_b);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // the current stage has landed
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][(wm * C::WTM + i * 16) * C::LDA + kk], C::LDA);
#pragma unroll
      for (int j = 0; j < C::FN; ++j)
        wmma::load_matrix_sync(bf[j], &Bs[cur][kk * C::LDB + wn * C::WTN + j * 16], C::LDB);
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // everyone is done with `cur` before it is refilled
  }

  // Epilogue: the fragment layout is opaque, so each fragment goes through a
  // per-warp 16x16 scratch to learn which (row, col) every value belongs to.
  float* scratch = epi[warp];
#pragma unroll
  for (int i = 0; i < C::FM; ++i) {
#pragma unroll
    for (int j = 0; j < C::FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r0 = m0 + wm * C::WTM + i * 16;
      const int c0 = n0 + wn * C::WTN + j * 16;
      if (partial != nullptr) {
        float* p = partial + (size_t)blockIdx.z * M * N;
        for (int e = lane; e < 256; e += 32) {
          const int r = r0 + e / 16, c = c0 + e % 16;
          if (r < M && c < N) p[(size_t)r * N + c] = scratch[e];
        }
      } else {
#pragma unroll
        for (int e = lane; e < 256; e += 32)
          store_out(out, bias, act, M, N, r0 + e / 16, c0 + e % 16, scratch[e]);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 operands: CUDA-core FMA, 64x64 tile, 4x4 outputs per thread.
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_NT = 256;

template <typename O>
__global__ void __launch_bounds__(F_NT)
    mmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K,
                   int act, bool vec_a, bool vec_b) {
  constexpr int LDA = F_BK + 4, LDB = F_BN + 4;
  __shared__ __align__(128) float As[2][F_BM * LDA];
  __shared__ __align__(128) float Bs[2][F_BK * LDB];

  const int tx = threadIdx.x % 16;  // output columns tx + 16 j
  const int ty = threadIdx.x / 16;  // output rows ty + 16 i
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  float acc[4][4] = {};

  const int nk = (K + F_BK - 1) / F_BK;
  if (nk > 0) {
    repro::load_tile<float, F_BM, F_BK, LDA, F_NT>(As[0], A, M, K, m0, 0, vec_a);
    repro::load_tile<float, F_BK, F_BN, LDB, F_NT>(Bs[0], B, K, N, 0, n0, vec_b);
  }
  repro::cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * F_BK;
      repro::load_tile<float, F_BM, F_BK, LDA, F_NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      repro::load_tile<float, F_BK, F_BN, LDB, F_NT>(Bs[cur ^ 1], B, K, N, k1, n0, vec_b);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[cur][(ty + 16 * i) * LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[cur][k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_out(out, bias, act, M, N, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}

template <int BM, int BN, int BK, int WM, int WN, typename O>
void launch_bf16(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
                 int act, cudaStream_t s, Split sp = {1, 0}, float* partial = nullptr) {
  const bool vec_a = repro::aligned16(a) && K % 8 == 0;
  const bool vec_b = repro::aligned16(b) && N % 8 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, sp.splits);
  mmm_bf16_kernel<BM, BN, BK, WM, WN, O><<<grid, 32 * WM * WN, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), bias,
      static_cast<O*>(out), M, N, K, act, vec_a, vec_b, sp.splits > 1 ? sp.k_chunk : K,
      sp.splits > 1 ? partial : nullptr);
  repro::finish_split<O>(partial, sp, bias, static_cast<O*>(out), M, N, act, s);
}

template <typename O>
void launch_f32(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
                int act, cudaStream_t s) {
  const bool vec_a = repro::aligned16(a) && K % 4 == 0;
  const bool vec_b = repro::aligned16(b) && N % 4 == 0;
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  mmm_f32_kernel<O><<<grid, F_NT, 0, s>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b), bias,
                                          static_cast<O*>(out), M, N, K, act, vec_a, vec_b);
}

template <typename O>
void launch(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
            int in_dtype, int act, cudaStream_t s, float* workspace) {
  if (in_dtype == repro::DT_F32) {
    launch_f32<O>(a, b, bias, out, M, N, K, act, s);
  } else if (M <= D_BM) {  // decode: one 16-row tile, 4 warps side by side over 64 columns
    launch_bf16<D_BM, D_BN, D_BK, 1, 4, O>(a, b, bias, out, M, N, K, act, s,
                                           plan_split(M, N, K, true), workspace);
  } else {  // prefill: 128x128 tile, 8 warps of 64x32
    launch_bf16<128, 128, 32, 2, 4, O>(a, b, bias, out, M, N, K, act, s);
  }
}

}  // namespace

// a: (M, K), b: (K, N), both row-major and of dtype `in_dtype`; bias: (N,)
// fp32 or null; out: (M, N) row-major of dtype `out_dtype`; workspace: at
// least split_workspace(M, N, K, in_dtype == bf16) bytes (null if that is
// 0).  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int systolic_mmm(const void* a, const void* b, const void* bias, void* out, int M,
                            int N, int K, int in_dtype, int out_dtype, int activation,
                            void* workspace, long long workspace_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if ((in_dtype != repro::DT_F32 && in_dtype != repro::DT_BF16) ||
      (out_dtype != repro::DT_F32 && out_dtype != repro::DT_BF16) || activation < ACT_NONE ||
      activation > ACT_TANH || M <= 0 || N <= 0 || K < 0 ||
      workspace_bytes < split_workspace(M, N, K, in_dtype == repro::DT_BF16) ||
      (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(workspace);
  if (out_dtype == repro::DT_F32)
    launch<float>(a, b, bf, out, M, N, K, in_dtype, activation, s, ws);
  else
    launch<__nv_bfloat16>(a, b, bf, out, M, N, K, in_dtype, activation, s, ws);
  return static_cast<int>(cudaGetLastError());
}
