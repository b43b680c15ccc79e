// Block-scaled int8 / fp8 (e4m3) GEMM for Hopper:
//   C[M,N] = act( sum over scale steps s of (A[:, s] . B[s, :]) * a_scale[row, s] * b_scale[s, col] )
// with an fp32 accumulator.
//
// Replaces the TPU kernel repro/kernels/systolic/kernel.py::_qmm_kernel (with
// its block dot _qdot), launched by quant_systolic_matmul_call.  A holds
// per-row x per-k-block scales (M, ceil(K/qk_a)), B per-k-block x per-column
// scales (ceil(K/qk_b), N); qk = 0 means one scale block spans all of K.
// Within a *scale step* -- the largest run of k inside one scale block of
// both operands, gcd(qk_a, qk_b), the reference's bk clamp -- the narrow
// products are summed exactly (int8 x int8 into int32; fp8 into fp32).  At
// the step's end the partial retires into the fp32 accumulator as
// (partial * a_scale) * b_scale, in the reference's order.  Scaling once
// after a whole-K int32 sum would be another function.
//
// What bounds it on the card: a decode projection (M = 4) does about 8
// operations per byte of weights read (1 byte per value), so it is bound by
// reading B from HBM; a prefill projection (M = 2048) does about 4000, far
// above the H100's ~590 int8 op/byte balance, so it is bound by tensor-core
// operations (1979e12 int8/fp8 op/s, datasheet).
// What the design does about that, kept simple for a first version:
//   * tensor cores through WMMA.  int8: signed-char 16x16x16 fragments into
//     int32 accumulators, A and B row-major as stored.  fp8: WMMA has no e4m3
//     type, so the staged e4m3 bytes are widened to bf16 in shared memory
//     (exact: e4m3's 3 mantissa bits and exponent range, subnormals
//     included, fit bf16) and go through bf16 WMMA with fp32 accumulation.
//   * tiles are staged with cp.async, two stages deep, in 16-byte k panels
//     (panel p holds columns [16p, 16p + 16) of every row, 16 bytes a row),
//     so every WMMA fragment is one contiguous, 256-byte-aligned block.
//   * WMMA's accumulator layout is opaque: at each scale-step boundary every
//     warp stores its narrow partial to a per-warp 16x16 scratch, reads back
//     the 8 values of each fragment it owns (element lane + 32 t), scales
//     them by row and column and adds them into fp32 registers, then zeroes
//     the partial.
//   * for M <= 16 (decode) a 16x64 tile is used and the contraction is split
//     across blocks (split-K) so about four blocks per SM read B; each slice
//     retires its own steps and writes an fp32 partial, and a second kernel
//     sums the partials in a fixed order and applies the activation / cast.
//   * ragged M, N and K are zero-filled while staging (0 under any scale);
//     scale reads outside the matrix are masked; the last, partial scale
//     block along K uses its own scale.  Nothing is padded in HBM.
// Not yet used (later work): wgmma, TMA, fusing the activation quantization
// into the A load.

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

namespace {

enum QDType { Q_INT8 = 0, Q_FP8 = 1 };

// e4m3 (1 sign, 4 exponent bits with bias 7, 3 mantissa bits; 0x7f / 0xff
// are NaN, no infinities) -> fp32, exactly.
__device__ __forceinline__ float e4m3_to_f32(uint32_t v) {
  const uint32_t sign = (v & 0x80u) << 24;
  const uint32_t e = (v >> 3) & 0xFu;
  const uint32_t m = v & 0x7u;
  if (e == 0xFu && m == 0x7u) return __uint_as_float(0x7fc00000u | sign);
  if (e == 0u) {  // subnormal: m * 2^-9
    const float f = static_cast<float>(m) * 0.001953125f;
    return sign ? -f : f;
  }
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

// Stage the ROWS x COLS byte window at (r0, c0) of a row-major (R, C) byte
// matrix as COLS/16 panels of ROWS x 16 bytes, zero-filling what lies outside
// the matrix.  `vec`: C is a multiple of 16 and the base 16-byte aligned, so
// whole in-bounds chunks go through cp.async (the caller commits and waits).
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void load_panels(uint8_t* s, const uint8_t* g, int R, int C, int r0,
                                            int c0, bool vec) {
  constexpr int CPR = COLS / 16;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR;
    const int p = i % CPR;
    const int gr = r0 + r;
    const int gc = c0 + 16 * p;
    uint8_t* d = s + (p * ROWS + r) * 16;
    if (vec && gr < R && gc < C) {
      repro::cp_async16(d, g + (size_t)gr * C + gc);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = (gr < R && gc + j < C) ? g[(size_t)gr * C + gc + j] : uint8_t(0);
    }
  }
}

// Widen N staged e4m3 bytes to bf16, 16 at a time (same panel layout).
template <int N, int NT>
__device__ __forceinline__ void widen_e4m3(__nv_bfloat16* dst, const uint8_t* src) {
  for (int i = threadIdx.x; i < N / 16; i += NT) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + 16 * i);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    __align__(16) __nv_bfloat16 out[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      out[j] = __float2bfloat16(e4m3_to_f32((w[j / 4] >> (8 * (j % 4))) & 0xFFu));
    reinterpret_cast<uint4*>(dst + 16 * i)[0] = reinterpret_cast<const uint4*>(out)[0];
    reinterpret_cast<uint4*>(dst + 16 * i)[1] = reinterpret_cast<const uint4*>(out)[1];
  }
}

// Fragment element types: int8 runs s8 WMMA into int32, fp8 bf16 WMMA into fp32.
template <int QD> struct QTraits;
template <> struct QTraits<Q_INT8> {
  using Frag = signed char;
  using Acc = int;
};
template <> struct QTraits<Q_FP8> {
  using Frag = __nv_bfloat16;
  using Acc = float;
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int QD, typename O>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
    qmm_kernel(const uint8_t* __restrict__ A, const float* __restrict__ A_s,
               const uint8_t* __restrict__ B, const float* __restrict__ B_s, O* __restrict__ out,
               int M, int N, int K, int qk_a, int qk_b, int n_sa, int step, int act, bool vec_a,
               bool vec_b, int k_chunk, float* __restrict__ partial) {
  // A_s: (M, n_sa) fp32; B_s: (ceil(K / qk_b) or 1, N) fp32.  `step` is the
  // scale step (0: all of K).  Block z contracts K slice [z k_chunk,
  // (z + 1) k_chunk), k_chunk a multiple of BK; with `partial` set the raw
  // fp32 sums go to partial[z] (M x N) and the epilogue to splitk_reduce.
  using Tr = QTraits<QD>;
  constexpr int NT = 32 * WARPS_M * WARPS_N;
  constexpr int WTM = BM / WARPS_M;
  constexpr int WTN = BN / WARPS_N;
  constexpr int FM = WTM / 16;
  constexpr int FN = WTN / 16;
  constexpr bool FP8 = QD == Q_FP8;
  static_assert(BK % 16 == 0 && WTM % 16 == 0 && WTN % 16 == 0, "tiles are whole fragments");
  __shared__ __align__(128) uint8_t As[2][BM * BK];
  __shared__ __align__(128) uint8_t Bs[2][BK * BN];
  __shared__ __align__(128) __nv_bfloat16 Aw[FP8 ? BM * BK : 16];  // fp8 widened to bf16
  __shared__ __align__(128) __nv_bfloat16 Bw[FP8 ? BK * BN : 16];
  __shared__ __align__(128) typename Tr::Acc scratch[WARPS_M * WARPS_N][16 * 16];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int row_base = m0 + wm * WTM;  // + 16 i + lane / 16 + 2 t
  const int col_base = n0 + wn * WTN;  // + 16 j + lane % 16

  wmma::fragment<wmma::accumulator, 16, 16, 16, typename Tr::Acc> part[FM][FN];
  float acc[FM][FN][8];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(part[i][j], typename Tr::Acc(0));
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[i][j][t] = 0.f;
    }

  const int kb = blockIdx.z * k_chunk;
  const int kend = min(K, kb + k_chunk);
  const int nk = (kend - kb + BK - 1) / BK;
  if (nk > 0) {
    load_panels<BM, BK, NT>(As[0], A, M, K, m0, kb, vec_a);
    load_panels<BK, BN, NT>(Bs[0], B, K, N, kb, n0, vec_b);
  }
  repro::cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next k tile into the other stage
      const int k1 = kb + (kt + 1) * BK;
      load_panels<BM, BK, NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      load_panels<BK, BN, NT>(Bs[cur ^ 1], B, K, N, k1, n0, vec_b);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();  // the current stage has landed
    __syncthreads();
    const typename Tr::Frag* a_t;
    const typename Tr::Frag* b_t;
    if constexpr (FP8) {
      widen_e4m3<BM * BK, NT>(Aw, As[cur]);
      widen_e4m3<BK * BN, NT>(Bw, Bs[cur]);
      __syncthreads();
      a_t = Aw;
      b_t = Bw;
    } else {
      a_t = reinterpret_cast<const signed char*>(As[cur]);
      b_t = reinterpret_cast<const signed char*>(Bs[cur]);
    }

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int k0 = kb + kt * BK + kk;
      if (k0 >= kend) break;  // the same for every thread of the block
      wmma::fragment<wmma::matrix_a, 16, 16, 16, typename Tr::Frag, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, typename Tr::Frag, wmma::row_major> bf[FN];
      // A panel kk/16 holds rows [0, BM) x 16 k; B panel c holds k rows [0, BK) x 16 columns.
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_t + ((kk / 16) * BM + wm * WTM + 16 * i) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_t + (((wn * WTN + 16 * j) / 16) * BK + kk) * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(part[i][j], af[i], bf[j], part[i][j]);

      // Retire the partial at the end of a scale step or of this block's slice.
      if (k0 + 16 >= kend || (step > 0 && (k0 + 16) % step == 0)) {
        const int ka = qk_a > 0 ? k0 / qk_a : 0;
        const int kb_s = qk_b > 0 ? k0 / qk_b : 0;
        typename Tr::Acc* sc = scratch[warp];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          float sa[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int r = row_base + 16 * i + lane / 16 + 2 * t;
            sa[t] = r < M ? A_s[(size_t)r * n_sa + ka] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const int c = col_base + 16 * j + lane % 16;
            const float sb = c < N ? B_s[(size_t)kb_s * N + c] : 0.f;
            wmma::store_matrix_sync(sc, part[i][j], 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float p = static_cast<float>(sc[lane + 32 * t]);
              acc[i][j][t] = __fadd_rn(acc[i][j][t], __fmul_rn(__fmul_rn(p, sa[t]), sb));
            }
            __syncwarp();
            wmma::fill_fragment(part[i][j], typename Tr::Acc(0));
          }
        }
      }
    }
    __syncthreads();  // everyone is done with `cur` before it is refilled
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = row_base + 16 * i + lane / 16 + 2 * t;
        const int c = col_base + 16 * j + lane % 16;
        if (partial != nullptr) {
          if (r < M && c < N) partial[(size_t)blockIdx.z * M * N + (size_t)r * N + c] = acc[i][j][t];
        } else {
          store_out(out, nullptr, act, M, N, r, c, acc[i][j][t]);
        }
      }
}

// Tiles: prefill 128x128 (8 warps of 64x32), decode (M <= 16) 16x64 (4 warps
// of 16x16).  The fp8 prefill tile takes k in 32s so the widened bf16 copy
// still fits the 48 KB of static shared memory.
constexpr int P_BM = 128, P_BN = 128;
constexpr int p_bk(int qd) { return qd == Q_FP8 ? 32 : 64; }

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int BM, int BN, int BK, int WM, int WN, int QD, typename O>
void launch_tile(const void* a, const float* a_s, const void* b, const float* b_s, void* out,
                 int M, int N, int K, int qk_a, int qk_b, int n_sa, int step, int act,
                 cudaStream_t s, Split sp, float* partial) {
  const bool vec_a = repro::aligned16(a) && K % 16 == 0;
  const bool vec_b = repro::aligned16(b) && N % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, sp.splits);
  qmm_kernel<BM, BN, BK, WM, WN, QD, O><<<grid, 32 * WM * WN, 0, s>>>(
      static_cast<const uint8_t*>(a), a_s, static_cast<const uint8_t*>(b), b_s,
      static_cast<O*>(out), M, N, K, qk_a, qk_b, n_sa, step, act, vec_a, vec_b,
      sp.splits > 1 ? sp.k_chunk : K, sp.splits > 1 ? partial : nullptr);
  repro::finish_split<O>(partial, sp, nullptr, static_cast<O*>(out), M, N, act, s);
}

template <int QD, typename O>
void launch(const void* a, const float* a_s, const void* b, const float* b_s, void* out, int M,
            int N, int K, int qk_a, int qk_b, int n_sa, int step, int act, cudaStream_t s,
            float* workspace) {
  if (M <= D_BM)
    launch_tile<D_BM, D_BN, D_BK, 1, 4, QD, O>(a, a_s, b, b_s, out, M, N, K, qk_a, qk_b, n_sa,
                                               step, act, s, plan_split(M, N, K, true), workspace);
  else
    launch_tile<P_BM, P_BN, p_bk(QD), 2, 4, QD, O>(a, a_s, b, b_s, out, M, N, K, qk_a, qk_b,
                                                   n_sa, step, act, s, {1, K}, nullptr);
}

// The scale step for scale blocks qk_a, qk_b (0 = all of K): gcd of the
// non-zero ones, 0 when both are whole-K.
int scale_step(int qk_a, int qk_b) {
  if (qk_a > 0 && qk_b > 0) return gcd(qk_a, qk_b);
  return qk_a > 0 ? qk_a : qk_b;
}

}  // namespace

// a: (M, K) and b: (K, N) row-major, 1-byte values of `qdtype` (0 int8, 1
// e4m3); a_scales: (M, qk_a ? ceil(K / qk_a) : 1) fp32; b_scales:
// (qk_b ? ceil(K / qk_b) : 1, N) fp32; out: (M, N) row-major of dtype
// `out_dtype`; workspace: at least split_workspace(M, N, K, 1) bytes.  The
// scale step must be 0 (whole K) or a multiple of 16.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int systolic_qmm(const void* a, const void* a_scales, const void* b,
                            const void* b_scales, void* out, int M, int N, int K, int qk_a,
                            int qk_b, int qdtype, int out_dtype, int activation, void* workspace,
                            long long workspace_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int step = scale_step(qk_a, qk_b);
  if ((qdtype != Q_INT8 && qdtype != Q_FP8) ||
      (out_dtype != repro::DT_F32 && out_dtype != repro::DT_BF16) || activation < ACT_NONE ||
      activation > ACT_TANH || M <= 0 || N <= 0 || K <= 0 || qk_a < 0 || qk_b < 0 ||
      step % 16 != 0 || workspace_bytes < split_workspace(M, N, K, 1) ||
      (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sa = qk_a > 0 ? (K + qk_a - 1) / qk_a : 1;
  const float* as = static_cast<const float*>(a_scales);
  const float* bs = static_cast<const float*>(b_scales);
  float* ws = static_cast<float*>(workspace);
  if (qdtype == Q_INT8) {
    if (out_dtype == repro::DT_F32)
      launch<Q_INT8, float>(a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step, activation, s, ws);
    else
      launch<Q_INT8, __nv_bfloat16>(a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step,
                                    activation, s, ws);
  } else {
    if (out_dtype == repro::DT_F32)
      launch<Q_FP8, float>(a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step, activation, s, ws);
    else
      launch<Q_FP8, __nv_bfloat16>(a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step,
                                   activation, s, ws);
  }
  return static_cast<int>(cudaGetLastError());
}
