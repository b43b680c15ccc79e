// The systolic GEMM's kernels and launch path, shared by the systolic GEMM
// (systolic_mmm.cu: C = act(A @ B [+ bias])) and the grouped expert GEMM
// (grouped_mmm.cu: y[e] = x[e] @ w[e], the same product batched over e).
//
// A block owns one (BM, BN) output tile and keeps its fp32 accumulator
// resident (the reference's C-stationary accumulator) while it walks the
// contraction in BK steps, the next k tile loading (cp.async, two stages)
// while the current one is multiplied.  Ragged M, N and K are masked while
// staging (zero fill) and at the store.
//
// BATCHED selects what the grid's z axis means.  Unbatched, block z
// contracts K slice z (split-K, decode tile only).  Batched, block z computes
// matrix z of the batch, all of K, from operands offset by z matrices; there
// is no split; and `rows`, when given, holds for each matrix the number of
// leading rows of A that can be nonzero: a block whose rows all lie at or
// past it loads nothing and writes zeros (the product of zero rows).  The
// unbatched instantiations are the systolic GEMM's code as it was before the
// batch existed: `if constexpr` and constant-folded ternaries leave them
// token for token what they were.
//
// KMB (unbatched only) reads B K-major: the (K, N) values stored as an
// (N, K) row-major matrix, as a tied head's (V, d) embedding table is the
// transpose of the (d, V) operand it multiplies.  A B tile is then staged as
// BN rows of BK contraction values, loaded and zero-filled as A's tiles are,
// and read as col_major WMMA fragments (bf16) or by column (fp32), so no
// transposed copy of B is ever made.  With KMB off (the default) every
// instantiation is what it was before KMB existed.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores through WMMA (16x16x16 bf16 -> fp32).
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

template <bool BATCHED, int BM, int BN, int BK, int WARPS_M, int WARPS_N, typename O, bool KMB = false>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    mmm_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                    const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K,
                    int act, bool vec_a, bool vec_b, int k_chunk, float* __restrict__ partial,
                    const int* __restrict__ rows) {
  // Unbatched: block z of the grid contracts K slice [z * k_chunk, (z + 1) *
  // k_chunk); k_chunk is a multiple of BK, so only the last slice meets K's
  // ragged end.  With `partial` set, the raw fp32 sums go to partial[z]
  // (M x N) and the epilogue is left to splitk_reduce.
  using namespace nvcuda;
  if constexpr (BATCHED) {  // block z: matrix z, all of K (k_chunk == K)
    const size_t z = blockIdx.z;
    A += z * M * K;
    B += z * K * N;
    out += z * M * N;
    if (rows != nullptr && (int)blockIdx.y * BM >= rows[z]) {
      zero_tile<BM, BN, 32 * WARPS_M * WARPS_N, false>(out, M, N, blockIdx.y * BM, blockIdx.x * BN);
      return;
    }
  }
  using C = TcCfg<BM, BN, BK, WARPS_M, WARPS_N>;
  static_assert(!(BATCHED && KMB), "K-major B is the unbatched GEMM's");
  // K-major B: BN rows of BK k each, padded as A's rows are.
  constexpr int LDB = KMB ? BK + 8 : C::LDB;
  using BLayout = typename std::conditional<KMB, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(128) __nv_bfloat16 As[2][C::A_ELEMS];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][KMB ? BN * LDB : C::B_ELEMS];
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

  const int kb = BATCHED ? 0 : blockIdx.z * k_chunk;
  const int nk = (min(K, kb + k_chunk) - kb + BK - 1) / BK;
  // B's k tile: BK x BN of a row-major (K, N) matrix, or BN x BK of the
  // (N, K) storage of a K-major one.
  if (nk > 0) {
    load_tile<__nv_bfloat16, BM, BK, C::LDA, C::NT>(As[0], A, M, K, m0, kb, vec_a);
    if constexpr (KMB)
      load_tile<__nv_bfloat16, BN, BK, LDB, C::NT>(Bs[0], B, N, K, n0, kb, vec_b);
    else
      load_tile<__nv_bfloat16, BK, BN, LDB, C::NT>(Bs[0], B, K, N, kb, n0, vec_b);
  }
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next k tile into the other stage
      const int k1 = kb + (kt + 1) * BK;
      load_tile<__nv_bfloat16, BM, BK, C::LDA, C::NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      if constexpr (KMB)
        load_tile<__nv_bfloat16, BN, BK, LDB, C::NT>(Bs[cur ^ 1], B, N, K, n0, k1, vec_b);
      else
        load_tile<__nv_bfloat16, BK, BN, LDB, C::NT>(Bs[cur ^ 1], B, K, N, k1, n0, vec_b);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the current stage has landed
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[C::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf[C::FN];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(af[i], &As[cur][(wm * C::WTM + i * 16) * C::LDA + kk], C::LDA);
#pragma unroll
      for (int j = 0; j < C::FN; ++j) {
        const int col = wn * C::WTN + j * 16;
        wmma::load_matrix_sync(bf[j], KMB ? &Bs[cur][col * LDB + kk] : &Bs[cur][kk * LDB + col], LDB);
      }
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
      if (!BATCHED && partial != nullptr) {
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
// fp32 operands: CUDA-core FMA, 64x64 tile, 4x4 outputs per thread (the
// reference computes fp32 products in full fp32; TF32 would not match it).
// ---------------------------------------------------------------------------

constexpr int F_BM = 64, F_BN = 64, F_BK = 16, F_NT = 256;

template <bool BATCHED, typename O, bool KMB = false>
__global__ void __launch_bounds__(F_NT)
    mmm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K,
                   int act, bool vec_a, bool vec_b, const int* __restrict__ rows) {
  if constexpr (BATCHED) {  // block z: matrix z
    const size_t z = blockIdx.z;
    A += z * M * K;
    B += z * K * N;
    out += z * M * N;
    if (rows != nullptr && (int)blockIdx.y * F_BM >= rows[z]) {
      zero_tile<F_BM, F_BN, F_NT, false>(out, M, N, blockIdx.y * F_BM, blockIdx.x * F_BN);
      return;
    }
  }
  static_assert(!(BATCHED && KMB), "K-major B is the unbatched GEMM's");
  constexpr int LDA = F_BK + 4, LDB = KMB ? F_BK + 4 : F_BN + 4;  // K-major B: F_BN rows of F_BK k
  __shared__ __align__(128) float As[2][F_BM * LDA];
  __shared__ __align__(128) float Bs[2][KMB ? F_BN * LDB : F_BK * LDB];

  const int tx = threadIdx.x % 16;  // output columns tx + 16 j
  const int ty = threadIdx.x / 16;  // output rows ty + 16 i
  const int m0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  float acc[4][4] = {};

  const int nk = (K + F_BK - 1) / F_BK;
  if (nk > 0) {
    load_tile<float, F_BM, F_BK, LDA, F_NT>(As[0], A, M, K, m0, 0, vec_a);
    if constexpr (KMB)
      load_tile<float, F_BN, F_BK, LDB, F_NT>(Bs[0], B, N, K, n0, 0, vec_b);
    else
      load_tile<float, F_BK, F_BN, LDB, F_NT>(Bs[0], B, K, N, 0, n0, vec_b);
  }
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      const int k1 = (kt + 1) * F_BK;
      load_tile<float, F_BM, F_BK, LDA, F_NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      if constexpr (KMB)
        load_tile<float, F_BN, F_BK, LDB, F_NT>(Bs[cur ^ 1], B, N, K, n0, k1, vec_b);
      else
        load_tile<float, F_BK, F_BN, LDB, F_NT>(Bs[cur ^ 1], B, K, N, k1, n0, vec_b);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[cur][(ty + 16 * i) * LDA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = KMB ? Bs[cur][(tx + 16 * j) * LDB + k] : Bs[cur][k * LDB + tx + 16 * j];
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

// ---------------------------------------------------------------------------
// Launch.  A batch's matrices follow one another, so every matrix's base is
// 16-byte aligned when the first is and its rows are whole 16-byte chunks.
// ---------------------------------------------------------------------------

template <bool BATCHED, int BM, int BN, int BK, int WM, int WN, typename O, bool KMB = false>
void launch_bf16(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
                 int act, int batch, cudaStream_t s, Split sp = {1, 0}, float* partial = nullptr,
                 const int* rows = nullptr) {
  const bool vec_a = aligned16(a) && K % 8 == 0;
  const bool vec_b = aligned16(b) && (KMB ? K : N) % 8 == 0;  // B's stored rows: K-major rows are K long
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, BATCHED ? batch : sp.splits);
  mmm_bf16_kernel<BATCHED, BM, BN, BK, WM, WN, O, KMB><<<grid, 32 * WM * WN, 0, s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), bias,
      static_cast<O*>(out), M, N, K, act, vec_a, vec_b, sp.splits > 1 ? sp.k_chunk : K,
      sp.splits > 1 ? partial : nullptr, rows);
  finish_split<O>(partial, sp, bias, static_cast<O*>(out), M, N, act, s);
}

template <bool BATCHED, typename O, bool KMB = false>
void launch_f32(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
                int act, int batch, cudaStream_t s, const int* rows = nullptr) {
  const bool vec_a = aligned16(a) && K % 4 == 0;
  const bool vec_b = aligned16(b) && (KMB ? K : N) % 4 == 0;
  dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, batch);
  mmm_f32_kernel<BATCHED, O, KMB><<<grid, F_NT, 0, s>>>(static_cast<const float*>(a),
                                                   static_cast<const float*>(b), bias,
                                                   static_cast<O*>(out), M, N, K, act, vec_a,
                                                   vec_b, rows);
}

template <bool BATCHED, typename O>
void launch(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
            int in_dtype, int act, int batch, cudaStream_t s, float* workspace, const int* rows) {
  if (in_dtype == DT_F32) {
    launch_f32<BATCHED, O>(a, b, bias, out, M, N, K, act, batch, s, rows);
  } else if (M <= D_BM) {  // decode: one 16-row tile, 4 warps side by side over 64 columns
    launch_bf16<BATCHED, D_BM, D_BN, D_BK, 1, 4, O>(a, b, bias, out, M, N, K, act, batch, s,
                                                    plan_split(M, N, K, !BATCHED), workspace, rows);
  } else {  // prefill: 128x128 tile, 8 warps of 64x32
    launch_bf16<BATCHED, 128, 128, 32, 2, 4, O>(a, b, bias, out, M, N, K, act, batch, s, {1, 0},
                                                nullptr, rows);
  }
}

// `batch` row-major (M, K) @ (K, N) products of dtype `in_dtype`, stored one
// after another, into `batch` (M, N) outputs of dtype `out_dtype`, with the
// bias (N,) fp32 or null and the activation applied.  Unbatched (batch 1)
// the decode tile splits K, and `workspace` holds at least
// split_workspace(M, N, K, in_dtype == bf16, 0) bytes (null if that is 0).
// Batched, `rows` (batch,) on the device or null: see BATCHED above.
// Launches on `s` and returns cudaGetLastError() (0 on success).
template <bool BATCHED>
int gemm(const void* a, const void* b, const float* bias, void* out, int M, int N, int K,
         int batch, int in_dtype, int out_dtype, int act, void* workspace,
         long long workspace_bytes, cudaStream_t s, const int* rows = nullptr) {
  if ((in_dtype != DT_F32 && in_dtype != DT_BF16) || (out_dtype != DT_F32 && out_dtype != DT_BF16) ||
      act < ACT_NONE || act > ACT_TANH || M <= 0 || N <= 0 || K < 0 || batch <= 0 ||
      batch > (BATCHED ? 65535 : 1) ||
      workspace_bytes < split_workspace(M, N, K, !BATCHED && in_dtype == DT_BF16, 0) ||
      (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* ws = static_cast<float*>(workspace);
  if (out_dtype == DT_F32)
    launch<BATCHED, float>(a, b, bias, out, M, N, K, in_dtype, act, batch, s, ws, rows);
  else
    launch<BATCHED, __nv_bfloat16>(a, b, bias, out, M, N, K, in_dtype, act, batch, s, ws, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
