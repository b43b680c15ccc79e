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
// The WMMA and FMA kernels and their launch are in gemm.cuh, shared with the
// grouped expert GEMM (grouped_mmm.cu); the Hopper building blocks are in
// hopper.cuh.  No path uses atomics: every output element is written once by
// one thread, so two runs give the same bits.

#include "gemm.cuh"
#include "hopper.cuh"

using namespace repro;
namespace hp = repro::hopper;

namespace {

// Paths, as numbered by the Python binding's PATHS.
enum Path { P_FMA = 0, P_DECODE = 1, P_WMMA = 2, P_WGMMA_128 = 3, P_WGMMA_64 = 4, P_WGMMA_256 = 5 };

constexpr int W_BK = 64, W_STAGES = 4;

template <int NCONS, int BN>  // consumer warpgroups of 64 rows, tile width
struct WgTile {
  static constexpr int BM = 64 * NCONS;
  static constexpr int NT = 128 * (NCONS + 1);     // + the producer warpgroup
  static constexpr int A_BYTES = BM * W_BK * 2;    // BM rows of one 128-byte k panel
  static constexpr int B_PANEL = W_BK * 64 * 2;    // 64 k rows of 64 columns
  static constexpr int STAGE = A_BYTES + BN / 64 * B_PANEL;
  static constexpr int SMEM = W_STAGES * STAGE + 2 * W_STAGES * 8 + 1024;  // + barriers + alignment
};

// Bias, activation and cast of two neighbouring accumulators (row r, columns
// c and c + 1 of the matrix), as the bf16 or fp32 pair the output stores.
template <typename O>
__device__ __forceinline__ void finish_pair(O* dst, const float* bias, int act, int N, int c, float v0, float v1) {
  if (bias != nullptr && c < N) {  // N is a multiple of 8 and c even: c + 1 < N too
    v0 += bias[c];
    v1 += bias[c + 1];
  }
  v0 = activate(v0, act);
  v1 = activate(v1, act);
  if constexpr (sizeof(O) == 2)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

template <int NCONS, int BN, typename O>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
    mmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                     const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K, int act) {
  using T = WgTile<NCONS, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_STAGES * T::STAGE);
  uint64_t* empty = full + W_STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + W_BK - 1) / W_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);          // the producer's arrive + the stage's TMA bytes
      hp::mbar_init(&empty[s], NCONS);     // one arrive per consumer warpgroup
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NCONS) {  // producer warpgroup: one thread keeps the ring full
    if constexpr (NCONS == 2) hp::setmaxnreg_dec<40>();
    if (threadIdx.x == NCONS * 128) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % W_STAGES;
        hp::mbar_wait(&empty[s], ((kt / W_STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * T::STAGE;
        hp::mbar_arrive_expect_tx(&full[s], T::STAGE);
        hp::tma_load_2d(st, &tma_a, &full[s], kt * W_BK, m0);
        for (int p = 0; p < BN / 64; ++p)
          hp::tma_load_2d(st + T::A_BYTES + p * T::B_PANEL, &tma_b, &full[s], n0 + 64 * p, kt * W_BK);
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg .. + 63
    if constexpr (NCONS == 2) hp::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % W_STAGES;
      hp::mbar_wait(&full[s], (kt / W_STAGES) & 1);
      const uint32_t a = hp::smem_u32(smem + s * T::STAGE) + wg * 64 * 128;
      const uint32_t b = hp::smem_u32(smem + s * T::STAGE + T::A_BYTES);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BK / 16; ++kk)
        hp::wgmma_ss_tb<BN>(acc, hp::desc_sw128(a + kk * 32, 16, 1024),
                            hp::desc_sw128(b + kk * 16 * 128, T::B_PANEL, 1024), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous stage's products are done: release it
      if (kt > 0 && threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[(kt - 1) % W_STAGES]);
    }
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);

    // Epilogue: bias, activation and cast in registers, each value at the
    // (row, column) the wgmma layout gives it; then through the ring, which
    // every consumer has finished with, so that each warp stores whole rows
    // (stores straight from the accumulator layout write 16-byte pieces of
    // eight rows at a time and ran at ~0.5 TB/s).  The staging tile is
    // 128-byte-swizzled against bank conflicts.
    hp::named_barrier(1, 128 * NCONS);
    constexpr int EPC = 16 / sizeof(O);    // elements per 16-byte chunk
    constexpr int ROW = BN * sizeof(O);    // bytes per staged row
    constexpr int CPR = ROW / 16;          // chunks per row
    unsigned char* stage = smem + wg * 64 * ROW;
    const int lane = threadIdx.x % 32;
    const int lr = (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows lr and lr + 8 of the warpgroup's 64
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = c * 8 + (lane % 4) * 2;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = lr + 8 * i;
        O* dst = reinterpret_cast<O*>(stage + rr * ROW + hp::swizzle128(rr, col / EPC) * 16) + col % EPC;
        finish_pair(dst, bias, act, N, n0 + col, acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
      }
    }
    hp::named_barrier(2 + wg, 128);
    for (int e = threadIdx.x % 128; e < 64 * CPR; e += 128) {
      const int rr = e / CPR, ch = e % CPR;
      const int gr = m0 + wg * 64 + rr, gc = n0 + ch * EPC;  // N % 8 == 0: a chunk is wholly in or out
      if (gr < M && gc < N)
        *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) =
            *reinterpret_cast<const uint4*>(stage + rr * ROW + hp::swizzle128(rr, ch) * 16);
    }
  }
}

template <int NCONS, int BN, typename O>
int launch_wgmma(const void* a, const void* b, const float* bias, void* out, int M, int N, int K, int act,
                 cudaStream_t s) {
  using T = WgTile<NCONS, BN>;
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, b_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t a_box[2] = {W_BK, T::BM}, b_box[2] = {64, W_BK};
  int e = hp::encode_bf16_map(&ta, a, 2, a_dims, a_strides, a_box);
  if (e == 0) e = hp::encode_bf16_map(&tb, b, 2, b_dims, b_strides, b_box);
  if (e != 0) return e;
  auto kern = mmm_wgmma_kernel<NCONS, BN, O>;
  const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM);
  kern<<<grid, T::NT, T::SMEM, s>>>(ta, tb, bias, static_cast<O*>(out), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

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
      return launch_wgmma<2, 256, O>(a, b, bias, out, M, N, K, act, s);
    case P_WGMMA_128:
      return launch_wgmma<2, 128, O>(a, b, bias, out, M, N, K, act, s);
    case P_WGMMA_64:
      return launch_wgmma<1, 128, O>(a, b, bias, out, M, N, K, act, s);
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
