// Forward flash attention for Hopper over (BH, S, D) tensors, D <= 128.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::_flash_kernel
// (launched by flash_attention_call).  Same algorithm and numerics: one block
// owns a resident tile of BQ query rows and streams K/V tiles of BKV keys
// through shared memory, keeping the running max m, the running sum l and
// the output accumulator in fp32 (online softmax).  Scores are q.k in fp32
// times `scale`; masked scores become -1e30 (never -inf, so exp never sees
// inf - inf) under the reference rule
//     kpos < kv_valid  [and kpos <= qpos if causal]  [and kpos > qpos - window];
// whole K/V tiles outside the mask are skipped by the reference's `needed`
// test; P is cast to V's dtype for P @ V; rows whose l stayed 0 are written
// as 0.  The TPU's sequential kv grid dimension becomes the loop inside the
// block.
//
// What bounds it on the card: at the prefill shape (S = 512, D = 128) a head
// does ~S/2 operations per byte of Q/K/V/O under the causal mask, above the
// H100's ~295 FLOP/byte balance, so it is bound by tensor-core throughput and
// by the softmax's exp on the CUDA cores.  What the design does about that,
// kept simple for a first version:
//   * bf16 inputs run both products on the tensor cores (WMMA 16x16x16,
//     fp32 accumulate); fp32 inputs run them on the CUDA cores in fp32;
//   * four warps each own 16 query rows; scores, probabilities and the
//     output accumulator of a warp live in its own slice of shared memory, so
//     the per-row rescale by exp(m_old - m_new) needs no fragment layout;
//   * the causal / window tile skip halves the work of a causal prefill.
// Not yet used (later work): wgmma, TMA, a K/V pipeline, head-aware GQA.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int BQ = 64;    // query rows per block (4 warps x 16)
constexpr int BKV = 64;   // keys per streamed tile
constexpr int NT = 128;
constexpr float NEG_INF = -1e30f;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
struct Layout {  // dynamic shared-memory carve-up for head dim padded to DP
  int ldt, ldp, ldo;
  size_t q, k, v, s, p, o, bytes;
  __host__ __device__ Layout(int DP) {
    ldt = DP + 16 / (int)sizeof(T);   // +16 bytes per row against bank conflicts
    ldp = BKV + 16 / (int)sizeof(T);
    ldo = DP + 4;
    q = 0;
    k = q + align128(sizeof(T) * BQ * ldt);
    v = k + align128(sizeof(T) * BKV * ldt);
    s = v + align128(sizeof(T) * BKV * ldt);
    p = s + align128(sizeof(float) * BQ * BKV);
    o = p + align128(sizeof(T) * BQ * ldp);
    bytes = o + align128(sizeof(float) * BQ * ldo);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int Sq, int Skv, int D, int DP, float scale, int causal,
                     int window, int kv_valid, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(DP);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* S = reinterpret_cast<float*>(smem + L.s) + warp * 16 * BKV;
  T* P = reinterpret_cast<T*>(smem + L.p) + warp * 16 * L.ldp;
  float* O = reinterpret_cast<float*>(smem + L.o) + warp * 16 * L.ldo;

  const int bh = blockIdx.y;
  const int q_lo = blockIdx.x * BQ;
  const T* qg = q + (size_t)bh * Sq * D;
  const T* kg = k + (size_t)bh * Skv * D;
  const T* vg = v + (size_t)bh * Skv * D;
  T* og = o + (size_t)bh * Sq * D;

  // Lanes 2r and 2r+1 own row r of the warp's 16 rows, each half of its columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qpos = q_lo + warp * 16 + r;
  float m_i = NEG_INF, l_i = 0.f;
  for (int e = lane; e < 16 * DP; e += 32) O[(e / DP) * L.ldo + e % DP] = 0.f;

  repro::load_tile_dyn<T, NT>(Qs, qg, Sq, D, q_lo, BQ, DP, L.ldt, vec);
  repro::cp_async_commit();

  for (int k_lo = 0; k_lo < Skv; k_lo += BKV) {
    // The reference's whole-tile skip (uniform over the block).
    bool needed = k_lo < kv_valid;
    if (causal) needed = needed && k_lo <= q_lo + BQ - 1;
    if (window > 0) needed = needed && k_lo + BKV - 1 >= q_lo - window + 1;
    if (!needed) continue;

    __syncthreads();  // every warp is done with the previous K/V tile
    repro::load_tile_dyn<T, NT>(Ks, kg, Skv, D, k_lo, BKV, DP, L.ldt, vec);
    repro::load_tile_dyn<T, NT>(Vs, vg, Skv, D, k_lo, BKV, DP, L.ldt, vec);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32).
    if constexpr (sizeof(T) == 2) {
      for (int j = 0; j < BKV / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int d0 = 0; d0 < DP; d0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(a, Qs + warp * 16 * L.ldt + d0, L.ldt);
          wmma::load_matrix_sync(b, Ks + j * 16 * L.ldt + d0, L.ldt);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(S + j * 16, acc, BKV, wmma::mem_row_major);
      }
    } else {
      for (int e = lane; e < 16 * BKV; e += 32) {
        const T* qr = Qs + (warp * 16 + e / BKV) * L.ldt;
        const T* kr = Ks + (e % BKV) * L.ldt;
        float acc = 0.f;
        for (int d = 0; d < DP; ++d) acc = fmaf(to_f32(qr[d]), to_f32(kr[d]), acc);
        S[e] = acc;
      }
    }
    __syncwarp();

    // Online softmax on row r: mask, new max, rescale factor, P, row sum.
    float* srow = S + r * BKV;
    T* prow = P + r * L.ldp;
    const int c0 = half * (BKV / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const int kpos = k_lo + c;
      bool ok = kpos < kv_valid;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      const float s = ok ? srow[c] * scale : NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float p = expf(srow[c] - m_new);
      prow[c] = from_f32<T>(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) O[r * L.ldo + c] *= alpha;
    __syncwarp();

    // O += P V (P in V's dtype, fp32 accumulate).
    if constexpr (sizeof(T) == 2) {
      for (int j = 0; j < DP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, O + j * 16, L.ldo, wmma::mem_row_major);
        for (int kk = 0; kk < BKV; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(a, P + kk, L.ldp);
          wmma::load_matrix_sync(b, Vs + kk * L.ldt + j * 16, L.ldt);
          wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(O + j * 16, acc, L.ldo, wmma::mem_row_major);
      }
    } else {
      for (int e = lane; e < 16 * DP; e += 32) {
        const int row = e / DP, col = e % DP;
        float acc = O[row * L.ldo + col];
        for (int t = 0; t < BKV; ++t)
          acc = fmaf(to_f32(P[row * L.ldp + t]), to_f32(Vs[t * L.ldt + col]), acc);
        O[row * L.ldo + col] = acc;
      }
    }
    __syncwarp();
  }

  if (qpos < Sq) {
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2) && c < D; ++c) {
      const float y = l_i > 0.f ? O[r * L.ldo + c] / l_i : 0.f;
      og[(size_t)qpos * D + c] = from_f32<T>(y);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Skv, int D,
           float scale, int causal, int window, int kv_valid, cudaStream_t s) {
  const int DP = (D + 15) / 16 * 16;
  const Layout<T> L(DP);
  auto kern = flash_fwd_kernel<T>;
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool vec = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) &&
                   D % (16 / (int)sizeof(T)) == 0;
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  kern<<<grid, NT, L.bytes, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, D, DP,
                                 scale, causal, window, kv_valid, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BH, Sq, D), k/v: (BH, Skv, D), o: (BH, Sq, D), all row-major of dtype
// `dtype`; window <= 0 means no sliding window; keys at kv_valid and beyond
// are masked.  Launches on `stream`; returns the CUDA error code (0 = ok).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int BH, int Sq,
                              int Skv, int D, float scale, int causal, int window, int kv_valid,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::DT_BF16)
    return launch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, D, scale, causal, window, kv_valid, s);
  if (dtype == repro::DT_F32)
    return launch<float>(q, k, v, o, BH, Sq, Skv, D, scale, causal, window, kv_valid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
