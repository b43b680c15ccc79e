// The wgmma prefill tile of the GEMMs, shared by the systolic GEMM
// (systolic_mmm.cu, K1: C = act(A @ B [+ bias])) and the grouped expert GEMM
// (grouped_mmm.cu, K4: y[e] = x[e] @ w[e], the same product batched over
// experts), and the staged epilogue, also used by the block-scaled GEMM's
// prefill tile (systolic_qmm.cu).
//
// Warp-specialised: one producer thread issues TMA loads of A (K-major) and
// B (N-major) into a ring of four 64-deep k stages in 128-byte-swizzled
// shared memory, with a full and an empty mbarrier per stage; each consumer
// warpgroup runs wgmma m64n{128,256}k16 on 64 rows, both operands from
// shared memory (B through the transpose bit), keeping one k stage of
// products in flight while it issues the next.  With two consumers,
// setmaxnreg moves registers from the producer warpgroup to them (one or
// three consumers fit without it).  TMA zero-fills ragged M, N and K.  The
// epilogue adds the bias, applies the activation and casts in the
// accumulator registers (their row and column follow from the wgmma
// layout), then stages the tile through the drained ring, swizzled, so that
// each warp stores whole rows, masked at the edge.  One block per SM.
//
// BATCHED selects what the grid's z axis means.  Unbatched (K1) there is one
// matrix and 2-D tensor maps.  Batched (K4), block z computes matrix z: the
// tensor maps are 3-D, (K, M, batch) for A and (N, K, batch) for B, with the
// matrix as the outer coordinate, so TMA zero-fills rows past M instead of
// reading the next matrix's; the output is offset by z matrices; and
// `rows`, when given, holds for each matrix the number of leading rows that
// can be nonzero: a block whose rows all lie at or past it loads nothing
// and writes zeros, which is the product when those rows of A are zero.
// The unbatched instantiations are K1's code as it was before the batch
// existed: `if constexpr` leaves them token for token what they were.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace wg {

namespace hp = repro::hopper;

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

// Epilogue of consumer warpgroup `wg` (rows m0 + 64 wg .. + 63 of the output,
// columns n0 .. n0 + BN - 1): bias, activation and cast in registers, each
// value at the (row, column) the wgmma layout gives it; then through
// `smem`, which every consumer has finished with, so that each warp stores
// whole rows (stores straight from the accumulator layout write 16-byte
// pieces of eight rows at a time and ran at ~0.5 TB/s).  The staging tile
// is 128-byte-swizzled against bank conflicts.  N must be a multiple of 8.
// The caller has synchronised the consumers (every one is done with smem).
template <int BN, typename O>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], unsigned char* smem, int wg,
                                           const float* bias, int act, O* out, int M, int N, int m0, int n0) {
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

template <bool BATCHED, int NCONS, int BN, typename O>
__global__ void __launch_bounds__(128 * (NCONS + 1), 1)
    mmm_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
                     const float* __restrict__ bias, O* __restrict__ out, int M, int N, int K, int act,
                     const int* __restrict__ rows) {
  using T = WgTile<NCONS, BN>;
  const int m0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  if constexpr (BATCHED) {  // block z: matrix z
    out += (size_t)blockIdx.z * M * N;
    if (rows != nullptr && m0 >= rows[blockIdx.z]) {  // every row of the tile is zero in A: so is the product
      zero_tile<T::BM, BN, T::NT, true>(out, M, N, m0, n0);
      return;
    }
  }
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_STAGES * T::STAGE);
  uint64_t* empty = full + W_STAGES;
  const int wg = threadIdx.x / 128;
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
        if constexpr (BATCHED) {
          const int z = blockIdx.z;
          hp::tma_load_3d(st, &tma_a, &full[s], kt * W_BK, m0, z);
          for (int p = 0; p < BN / 64; ++p)
            hp::tma_load_3d(st + T::A_BYTES + p * T::B_PANEL, &tma_b, &full[s], n0 + 64 * p, kt * W_BK, z);
        } else {
          hp::tma_load_2d(st, &tma_a, &full[s], kt * W_BK, m0);
          for (int p = 0; p < BN / 64; ++p)
            hp::tma_load_2d(st + T::A_BYTES + p * T::B_PANEL, &tma_b, &full[s], n0 + 64 * p, kt * W_BK);
        }
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
    hp::named_barrier(1, 128 * NCONS);
    store_tile<BN>(acc, smem, wg, bias, act, out, M, N, m0, n0);
  }
}

// `batch` row-major (M, K) @ (K, N) bf16 products stored one after another
// (batch 1 unbatched), with `rows` (batched only; null = all M rows) as
// above.  K and N multiples of 8 and 16-byte-aligned bases (TMA's row
// pitch and base).  Returns a CUDA error code (0 = ok); given `q`,
// describes the launch instead (LaunchQuery).
template <bool BATCHED, int NCONS, int BN, typename O>
int launch_wgmma(const void* a, const void* b, const float* bias, void* out, int M, int N, int K, int act,
                 int batch, const int* rows, cudaStream_t s, LaunchQuery* q = nullptr) {
  using T = WgTile<NCONS, BN>;
  auto kern = mmm_wgmma_kernel<BATCHED, NCONS, BN, O>;
  // x fastest, then y, then z: the tiles of one matrix are adjacent in launch order.
  const dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM, batch);
  if (q != nullptr) return describe(q, kern, grid, T::NT, T::SMEM);
  CUtensorMap ta, tb;
  int e;
  if constexpr (BATCHED) {
    const cuuint64_t a_dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)batch};
    const cuuint64_t a_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)M * K * 2};
    const cuuint64_t b_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)batch};
    const cuuint64_t b_strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
    const cuuint32_t a_box[3] = {W_BK, T::BM, 1}, b_box[3] = {64, W_BK, 1};
    e = hp::encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 3, a_dims, a_strides, a_box);
    if (e == 0) e = hp::encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, 3, b_dims, b_strides, b_box);
  } else {
    const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M}, a_strides[1] = {(cuuint64_t)K * 2};
    const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K}, b_strides[1] = {(cuuint64_t)N * 2};
    const cuuint32_t a_box[2] = {W_BK, T::BM}, b_box[2] = {64, W_BK};
    e = hp::encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 2, a_dims, a_strides, a_box);
    if (e == 0) e = hp::encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, 2, b_dims, b_strides, b_box);
  }
  if (e != 0) return e;
  const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<grid, T::NT, T::SMEM, s>>>(ta, tb, bias, static_cast<O*>(out), M, N, K, act, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace repro
