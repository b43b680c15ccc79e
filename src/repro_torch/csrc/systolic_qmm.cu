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
// What the design does about that:
//   * B is read K-major on every tile: the (K, N) values stored as an
//     (N, K) row-major matrix.  8-bit wgmma takes 8-bit operands only
//     K-major (there is no transpose bit for them), so the w8a8 weights are
//     laid out so once, when they are quantized for the card
//     (quant.k_major), and ops.quant_matmul lays out any other weight so
//     before the call.
//   * int8 prefill (M > 16; K a multiple of 16, N of 8, aligned bases, a
//     scale step of whole K or a multiple of 128, as served): a
//     warp-specialised wgmma tile (below).  8-bit wgmma runs m64nNk32, twice
//     bf16's k per instruction, which is what reaches the int8 tensor-core
//     rate.  TMA loads A and B in 128-byte-swizzled 128-deep k
//     stages; the narrow partial stays in wgmma's accumulator registers,
//     whose row and column are known from its layout, so a step's retire is
//     done in registers (the WMMA tile below sends every fragment through
//     shared memory for that, 37-43 % of its time), and pipelined with the
//     products of the next stage.
//   * fp8 stays on the WMMA tiles.  An e4m3 wgmma variant of the tile above,
//     retiring every scale step into fp32 as DeepSeek's DeepGEMM promotes,
//     missed the plain version's tolerance (1e-5 of the largest sum) at
//     every scale block tried on the H100, whole-K, 128 and 32: Hopper's
//     fp8 tensor cores keep fewer bits while they accumulate (PERF.md;
//     tools/fp8_wgmma_error.py measures it).
//     The widened bf16 products below are exact and summed in fp32.
//   * decode (M <= 16) and shapes the wgmma tile does not take: tensor cores
//     through WMMA.  int8: signed-char 16x16x16 fragments into int32
//     accumulators.  fp8: WMMA has no e4m3 type, so the staged e4m3 bytes are
//     widened to bf16 in shared memory (exact: e4m3's 3 mantissa bits and
//     exponent range, subnormals included, fit bf16) and go through bf16
//     WMMA with fp32 accumulation.  Tiles are staged with cp.async, two
//     stages deep, in 16-byte k panels (panel p holds k [16p, 16p + 16) of
//     every row of A and every column of B, 16 bytes each), so every WMMA
//     fragment is one contiguous, 256-byte-aligned block (B's col_major).  WMMA's accumulator layout is opaque: at each
//     scale-step boundary every warp stores its narrow partial to a
//     per-warp 16x16 scratch, reads back the 8 values of each fragment it
//     owns, scales them by row and column and adds them into fp32
//     registers, then zeroes the partial.  For M <= 16 a 16x64 tile is used
//     and the contraction is split across blocks (split-K) so about four
//     blocks per SM read B; each slice retires its own steps and writes an
//     fp32 partial, and a second kernel sums the partials in a fixed order
//     and applies the activation / cast.
//   * ragged M, N and K are zero-filled while staging (0 under any scale);
//     scale reads outside the matrix are masked; the last, partial scale
//     block along K uses its own scale.  Nothing is padded in HBM.
//   * int8 sums within a step are exact in int32 and both prefill tiles
//     retire the steps in the same order, so they give the same int8 output
//     bit for bit (and the same as the earlier tiles on row-major B:
//     tools/ab_systolic.py).
// Not yet done (later work): fusing the activation quantization into the A
// load.

#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_gemm.cuh"

using namespace nvcuda;
namespace hp = repro::hopper;
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
  // B is stored (N, K) row-major (the (K, N) values, K-major) and staged as
  // A is, in 16-byte k panels of BN rows; its fragments are col_major.
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
    load_panels<BN, BK, NT>(Bs[0], B, N, K, n0, kb, vec_b);
  }
  repro::cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {  // prefetch the next k tile into the other stage
      const int k1 = kb + (kt + 1) * BK;
      load_panels<BM, BK, NT>(As[cur ^ 1], A, M, K, m0, k1, vec_a);
      load_panels<BN, BK, NT>(Bs[cur ^ 1], B, N, K, n0, k1, vec_b);
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
      wmma::fragment<wmma::matrix_b, 16, 16, 16, typename Tr::Frag, wmma::col_major> bf[FN];
      // A panel kk/16 holds rows [0, BM) x 16 k; B panel kk/16 columns [0, BN) x 16 k.
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a_t + ((kk / 16) * BM + wm * WTM + 16 * i) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bf[j], b_t + ((kk / 16) * BN + wn * WTN + 16 * j) * 16, 16);
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

// ---------------------------------------------------------------------------
// The int8 prefill tile on wgmma (M > 16, a scale step of whole K or a
// multiple of 128).  A 128x128 output tile per block: two consumer
// warpgroups of 64 rows and one producer warpgroup, whose warp w fills slot
// w of a ring of Q_STAGES = 4 stages, each 128 deep in k (one scale step in
// serving): its first lane issues the TMA loads of A (M, K) and of B stored
// (N, K) -- both K-major, as 8-bit wgmma requires -- into 128-byte-swizzled
// tiles; if the stage ends a scale step, the warp then stores that step's
// row scales (128) and column scales (128), which it loaded a ring turn
// ahead, and arrives a second time.  No scale load delays a TMA load.
// Each consumer issues the stage's four wgmma m64n128k32 (s8 -> s32) in one
// block into a narrow partial in registers, waits for them, and at the end
// of a scale step retires the partial into a separate fp32 register
// accumulator as (partial * a_scale) * b_scale, each value's row and column
// taken from the wgmma layout; the next step starts with scale_d = 0.
// While one consumer retires, the other's products may run.  The retire
// (a conversion, two multiplies and an add per value, in the reference's
// order) is what holds this tile back (PERF.md): overlapping it with the
// next stage's products needs a second partial in registers, and the
// compiler then serialised the products (ptxas C7514) in every variant
// tried.  The epilogue is the fp GEMM's staged one (wgmma_gemm.cuh).
// ---------------------------------------------------------------------------

constexpr int Q_BM = 128, Q_BN = 128, Q_BK = 128, Q_STAGES = 4;  // one producer warp per stage

struct QTile {
  static constexpr int NCONS = 2;
  static constexpr int NT = 128 * (NCONS + 1);
  static constexpr int A_BYTES = Q_BM * Q_BK;             // 128 rows of 128 k bytes
  static constexpr int B_BYTES = Q_BN * Q_BK;             // 128 columns of 128 k bytes
  static constexpr int SA = A_BYTES + B_BYTES;             // row scales of the step: Q_BM fp32
  static constexpr int SB = SA + Q_BM * 4;                 // column scales of the step: Q_BN fp32
  static constexpr int STAGE = SB + Q_BN * 4;              // 33 KB
  static constexpr int SMEM = Q_STAGES * STAGE + 2 * Q_STAGES * 8 + 1024;  // + barriers + alignment
};
static_assert(QTile::STAGE % 1024 == 0, "each stage's tiles start on a swizzle atom");

// Does stage kt end a scale step (or the contraction)?  `step` is 0 (whole
// K) or a multiple of Q_BK, so steps end on stage boundaries only.
__device__ __forceinline__ bool ends_step(int kt, int nk, int step) {
  return kt + 1 == nk || (step > 0 && ((kt + 1) * Q_BK) % step == 0);
}

// Retire a step's int32 partial into the fp32 accumulator as
// (partial * a_scale) * b_scale, each value at the row and column the wgmma
// layout gives it: rows lr and lr + 8 of the warpgroup's 64 (scales sa0,
// sa1), columns 8c + 2 (lane % 4) + {0, 1} (sb: the step's column scales).
// A step of Q_BK sums at most 128 products, |p| <= 2^21, so `small`
// partials convert exactly by the float trick (an integer add into
// 1.5 * 2^23's mantissa, then a subtract), at the FP32 and INT32 pipes'
// rate instead of the conversion unit's quarter rate; longer steps take an
// I2F, as exact.
__device__ __forceinline__ void retire(float (&acc)[64], const int (&part)[64], float sa0, float sa1, const float* sb,
                                       int lane, bool small) {
#pragma unroll
  for (int c = 0; c < Q_BN / 8; ++c) {
    const float2 sbc = *reinterpret_cast<const float2*>(sb + c * 8 + (lane % 4) * 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int x = 4 * c + 2 * i + j;
        const float p = small ? __fsub_rn(__int_as_float(0x4B400000 + part[x]), 12582912.f)
                              : static_cast<float>(part[x]);
        acc[x] = __fadd_rn(acc[x], __fmul_rn(__fmul_rn(p, i ? sa1 : sa0), j ? sbc.y : sbc.x));
      }
  }
}

// Issue stage kt's products for this warpgroup's 64 rows into `part`
// (overwriting it if `fresh`, else accumulating), one commit group.
__device__ __forceinline__ void issue_stage(int (&part)[64], const unsigned char* smem, int kt, int wg, bool fresh) {
  const unsigned char* st = smem + (kt % Q_STAGES) * QTile::STAGE;
  hp::fence_operand(part);
  hp::wgmma_fence();
  hp::wgmma_m64n128k128_s8(part, hp::desc_sw128(hp::smem_u32(st) + wg * 64 * 128, 16, 1024),
                           hp::desc_sw128(hp::smem_u32(st + QTile::A_BYTES), 16, 1024), fresh ? 0 : 1);
  hp::wgmma_commit();
}

template <typename O>
__global__ void __launch_bounds__(QTile::NT, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                     const float* __restrict__ A_s, const float* __restrict__ B_s, O* __restrict__ out, int M,
                     int N, int K, int qk_a, int qk_b, int n_sa, int step, int act) {
  using T = QTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Q_STAGES * T::STAGE);
  uint64_t* empty = full + Q_STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * Q_BM;
  const int n0 = blockIdx.x * Q_BN;
  const int nk = (K + Q_BK - 1) / Q_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      hp::mbar_init(&full[s], 2);             // the producer's two arrives + the stage's TMA bytes
      hp::mbar_init(&empty[s], T::NCONS);     // one arrive per consumer warpgroup
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == T::NCONS) {  // producer warpgroup: warp s fills ring slot s
    hp::setmaxnreg_dec<40>();
    const int s = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    // The scales of the warp's next stage, loaded a whole ring turn ahead
    // (lane l holds rows and columns l, l + 32, l + 64, l + 96).
    float ra[Q_BM / 32], rb[Q_BN / 32];
    auto load_scales = [&](int kt) {
      if (!ends_step(kt, nk, step)) return;  // the step's scales, read where its last k block lies
      const int k0 = kt * Q_BK;
      const int ka = qk_a > 0 ? k0 / qk_a : 0;
      const int kb = qk_b > 0 ? k0 / qk_b : 0;
#pragma unroll
      for (int i = 0; i < Q_BM / 32; ++i) {
        const int r = m0 + lane + 32 * i, c = n0 + lane + 32 * i;
        ra[i] = r < M ? A_s[(size_t)r * n_sa + ka] : 0.f;
        rb[i] = c < N ? B_s[(size_t)kb * N + c] : 0.f;
      }
    };
    if (s < nk) load_scales(s);
    for (int kt = s; kt < nk; kt += Q_STAGES) {
      hp::mbar_wait(&empty[s], ((kt / Q_STAGES) & 1) ^ 1);
      unsigned char* st = smem + s * T::STAGE;
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(&full[s], T::A_BYTES + T::B_BYTES);
        hp::tma_load_2d(st, &tma_a, &full[s], kt * Q_BK, m0);
        hp::tma_load_2d(st + T::A_BYTES, &tma_b, &full[s], kt * Q_BK, n0);
      }
      if (ends_step(kt, nk, step)) {
        float* sa = reinterpret_cast<float*>(st + T::SA);
        float* sb = reinterpret_cast<float*>(st + T::SB);
#pragma unroll
        for (int i = 0; i < Q_BM / 32; ++i) {
          sa[lane + 32 * i] = ra[i];
          sb[lane + 32 * i] = rb[i];
        }
      }
      __syncwarp();  // the warp's scale stores come before the arrive that publishes them
      if (lane == 0) hp::mbar_arrive(&full[s]);
      if (kt + Q_STAGES < nk) load_scales(kt + Q_STAGES);
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
    hp::setmaxnreg_inc<232>();
    int part[64];  // the step's narrow partial
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      part[i] = 0;
      acc[i] = 0.f;
    }
    const int lane = threadIdx.x % 32;
    const int lr = (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows lr and lr + 8 of the warpgroup's 64
    const bool small = step == Q_BK;  // at most 128 products per partial (the last step may be shorter)
    bool fresh = true;  // the stage starts a scale step: scale_d = 0
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % Q_STAGES;
      const unsigned char* st = smem + s * T::STAGE;
      hp::mbar_wait(&full[s], (kt / Q_STAGES) & 1);
      issue_stage(part, smem, kt, wg, fresh);
      hp::wgmma_wait<0>();
      hp::fence_operand(part);
      fresh = ends_step(kt, nk, step);
      if (fresh) {
        const float* sa = reinterpret_cast<const float*>(st + T::SA) + wg * 64;
        retire(acc, part, sa[lr], sa[lr + 8], reinterpret_cast<const float*>(st + T::SB), lane, small);
      }
      if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[s]);  // its products and scales are used
    }
    hp::named_barrier(1, 128 * T::NCONS);
    repro::wg::store_tile<Q_BN>(acc, smem, wg, nullptr, act, out, M, N, m0, n0);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Paths, as numbered by the Python binding's QPATHS (kernels/systolic/kernel.py):
//   decode  M <= 16: the WMMA 16x64 tile (4 warps of 16x16), split-K;
//   wmma    the WMMA 128x128 tile (8 warps of 64x32), for shapes the wgmma
//           tile does not take; the fp8 one takes k in 32s so the widened
//           bf16 copy still fits the 48 KB of static shared memory;
//   wgmma   the tile above (int8): K a multiple of 16, N of 8,
//           16-byte-aligned bases, a scale step of whole K or a multiple of 128.
enum QPath { QP_DECODE = 0, QP_WMMA = 1, QP_WGMMA = 2 };
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
  const bool vec_b = repro::aligned16(b) && K % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, sp.splits);
  qmm_kernel<BM, BN, BK, WM, WN, QD, O><<<grid, 32 * WM * WN, 0, s>>>(
      static_cast<const uint8_t*>(a), a_s, static_cast<const uint8_t*>(b), b_s,
      static_cast<O*>(out), M, N, K, qk_a, qk_b, n_sa, step, act, vec_a, vec_b,
      sp.splits > 1 ? sp.k_chunk : K, sp.splits > 1 ? partial : nullptr);
  repro::finish_split<O>(partial, sp, nullptr, static_cast<O*>(out), M, N, act, s);
}

template <typename O>
int launch_wgmma(const void* a, const float* a_s, const void* b, const float* b_s, void* out, int M, int N, int K,
                 int qk_a, int qk_b, int n_sa, int step, int act, cudaStream_t s) {
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t pitch[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {Q_BK, Q_BM}, b_box[2] = {Q_BK, Q_BN};
  int e = hp::encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, 2, a_dims, pitch, a_box);
  if (e == 0) e = hp::encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, 2, b_dims, pitch, b_box);
  if (e != 0) return e;
  auto kern = qmm_wgmma_kernel<O>;
  const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, QTile::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + Q_BN - 1) / Q_BN, (M + Q_BM - 1) / Q_BM);
  kern<<<grid, QTile::NT, QTile::SMEM, s>>>(ta, tb, a_s, b_s, static_cast<O*>(out), M, N, K, qk_a, qk_b, n_sa,
                                            step, act);
  return static_cast<int>(cudaGetLastError());
}

template <int QD, typename O>
int launch(int path, const void* a, const float* a_s, const void* b, const float* b_s, void* out, int M, int N,
           int K, int qk_a, int qk_b, int n_sa, int step, int act, cudaStream_t s, float* workspace) {
  if constexpr (QD == Q_INT8) {
    if (path == QP_WGMMA) return launch_wgmma<O>(a, a_s, b, b_s, out, M, N, K, qk_a, qk_b, n_sa, step, act, s);
  }
  if (path == QP_DECODE)
    launch_tile<D_BM, D_BN, D_BK, 1, 4, QD, O>(a, a_s, b, b_s, out, M, N, K, qk_a, qk_b, n_sa, step, act, s,
                                               plan_split(M, N, K, true), workspace);
  else
    launch_tile<P_BM, P_BN, p_bk(QD), 2, 4, QD, O>(a, a_s, b, b_s, out, M, N, K, qk_a, qk_b, n_sa, step, act, s,
                                                   {1, K}, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The scale step for scale blocks qk_a, qk_b (0 = all of K): gcd of the
// non-zero ones, 0 when both are whole-K.
int scale_step(int qk_a, int qk_b) {
  if (qk_a > 0 && qk_b > 0) return gcd(qk_a, qk_b);
  return qk_a > 0 ? qk_a : qk_b;
}

}  // namespace

// a: (M, K) row-major; b: the (K, N) values stored K-major, as an (N, K)
// row-major matrix; 1-byte values of `qdtype` (0 int8, 1
// e4m3); a_scales: (M, qk_a ? ceil(K / qk_a) : 1) fp32; b_scales:
// (qk_b ? ceil(K / qk_b) : 1, N) fp32; out: (M, N) row-major of dtype
// `out_dtype`; `path`: one of QPath, which must fit the operands (decode
// M <= 16, the others M > 16; wgmma as described there); workspace: at
// least split_workspace(M, N, K, 1) bytes.  The scale step must be 0
// (whole K) or a multiple of 16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int systolic_qmm(const void* a, const void* a_scales, const void* b,
                            const void* b_scales, void* out, int M, int N, int K, int qk_a,
                            int qk_b, int qdtype, int out_dtype, int activation, int path,
                            void* workspace, long long workspace_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int step = scale_step(qk_a, qk_b);
  if ((qdtype != Q_INT8 && qdtype != Q_FP8) ||
      (out_dtype != repro::DT_F32 && out_dtype != repro::DT_BF16) || activation < ACT_NONE ||
      activation > ACT_TANH || M <= 0 || N <= 0 || K <= 0 || qk_a < 0 || qk_b < 0 ||
      step % 16 != 0 || path < QP_DECODE || path > QP_WGMMA || (path == QP_DECODE) != (M <= D_BM) ||
      (path == QP_WGMMA && (qdtype != Q_INT8 || K % 16 != 0 || N % 8 != 0 || step % Q_BK != 0 ||
                            !repro::aligned16(a) || !repro::aligned16(b))) ||
      workspace_bytes < split_workspace(M, N, K, 1) ||
      (workspace_bytes > 0 && workspace == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sa = qk_a > 0 ? (K + qk_a - 1) / qk_a : 1;
  const float* as = static_cast<const float*>(a_scales);
  const float* bs = static_cast<const float*>(b_scales);
  float* ws = static_cast<float*>(workspace);
  if (qdtype == Q_INT8)
    return out_dtype == repro::DT_F32
               ? launch<Q_INT8, float>(path, a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step, activation, s, ws)
               : launch<Q_INT8, __nv_bfloat16>(path, a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step,
                                               activation, s, ws);
  return out_dtype == repro::DT_F32
             ? launch<Q_FP8, float>(path, a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step, activation, s, ws)
             : launch<Q_FP8, __nv_bfloat16>(path, a, as, b, bs, out, M, N, K, qk_a, qk_b, n_sa, step,
                                            activation, s, ws);
}
