// Helpers shared by the port's CUDA kernels (built for sm_90a, bound with ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes of the C interface; the Python bindings use the same numbers.
enum DType { DT_F32 = 0, DT_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as the reference's astype
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the ROWS x COLS window at (r0, c0) of a row-major (R, C) matrix into
// shared memory (row stride LDS elements), zero-filling whatever lies outside
// the matrix: the kernels mask ragged edges here instead of padding in HBM.
// `vec` says the rows are 16-byte aligned (C a multiple of 16 / sizeof(T) and
// an aligned base), so whole in-bounds chunks go through cp.async; the caller
// commits and waits.  Every other chunk is copied element by element.
template <typename T, int ROWS, int COLS, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* smem, const T* g, int R, int C, int r0, int c0,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0, "tile width must be a whole number of 16-byte chunks");
  constexpr int CPR = COLS / V;  // chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * V;
    const int gr = r0 + r;
    const int gc = c0 + c;
    T* s = smem + r * LDS + c;
    if (vec && gr < R && gc < C) {
      cp_async16(s, g + (size_t)gr * C + gc);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        s[j] = (gr < R && gc + j < C) ? g[(size_t)gr * C + gc + j] : from_f32<T>(0.f);
    }
  }
}

// Same, for a window whose row count is only known at run time.
template <typename T, int NTHREADS>
__device__ __forceinline__ void load_tile_dyn(T* smem, const T* g, int R, int C, int r0, int rows,
                                              int cols, int lds, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = cols / V;
  for (int i = threadIdx.x; i < rows * cpr; i += NTHREADS) {
    const int r = i / cpr;
    const int c = (i % cpr) * V;
    const int gr = r0 + r;
    T* s = smem + r * lds + c;
    if (vec && gr < R && c < C) {
      cp_async16(s, g + (size_t)gr * C + c);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        s[j] = (gr < R && c + j < C) ? g[(size_t)gr * C + c + j] : from_f32<T>(0.f);
    }
  }
}

// Epilogue shared by the GEMM kernels: the reference's ACTIVATIONS ("gelu" is
// the tanh form, jax.nn.gelu's default), then the cast, masked to the matrix.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };

// The reference's ACTIVATIONS; "gelu" is the tanh form (jax.nn.gelu's default).
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_GELU: {
      const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(u));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    case ACT_TANH:
      return tanhf(x);
    default:
      return x;
  }
}

template <typename O>
__device__ __forceinline__ void store_out(O* out, const float* bias, int act, int M, int N, int r,
                                          int c, float v) {
  if (r < M && c < N) {
    if (bias != nullptr) v += bias[c];
    out[(size_t)r * N + c] = from_f32<O>(activate(v, act));
  }
}

// Split-K epilogue: out = act(sum_z partial[z] + bias), summed in z order.
template <typename O>
__global__ void splitk_reduce(const float* __restrict__ partial, int splits,
                              const float* __restrict__ bias, O* __restrict__ out, int M, int N,
                              int act) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += partial[z * mn + i];
    store_out(out, bias, act, M, N, (int)(i / N), (int)(i % N), v);
  }
}

// Streaming multiprocessors of the current device (cached per device).
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Batched GEMMs: zero the (BM, BN) output tile at (m0, n0) of one matrix,
// masked to the matrix (the tile of a block whose A rows are all zero), one
// element a store, or with VEC 16 bytes a store (N a multiple of 16 bytes,
// `out` 16-byte aligned; a chunk then lies wholly in or out).
template <int BM, int BN, int NT, bool VEC, typename O>
__device__ __forceinline__ void zero_tile(O* out, int M, int N, int m0, int n0) {
  constexpr int EPC = VEC ? 16 / sizeof(O) : 1;
  for (int e = threadIdx.x; e < BM * BN / EPC; e += NT) {
    const int r = m0 + e / (BN / EPC), c = n0 + e % (BN / EPC) * EPC;
    if (r < M && c < N) {
      if constexpr (VEC)
        *reinterpret_cast<uint4*>(out + (size_t)r * N + c) = make_uint4(0, 0, 0, 0);
      else
        out[(size_t)r * N + c] = from_f32<O>(0.f);
    }
  }
}

// The decode tile (M <= 16) of the GEMMs, and how its contraction is split.
constexpr int D_BM = 16, D_BN = 64, D_BK = 64;

struct Split {
  int splits;   // blocks along K
  int k_chunk;  // contraction per block, a multiple of D_BK
};

// Enough K slices that about four decode blocks per SM stream B (the
// N / D_BN column tiles alone may fill a few SMs only); one slice when the
// GEMM is not a splittable decode or the column tiles already fill the card.
// A caller's `k_chunk` (> 0, a multiple of D_BK: a tuned plan's) sets the
// contraction per block instead.  kernels/systolic/kernel.py plan_split is
// the same rule in Python.
inline Split plan_split(int M, int N, int K, bool splittable, int k_chunk = 0) {
  if (!splittable || M > D_BM || K <= D_BK) return {1, K};
  if (k_chunk > 0) return k_chunk >= K ? Split{1, K} : Split{(K + k_chunk - 1) / k_chunk, k_chunk};
  const int col_tiles = (N + D_BN - 1) / D_BN;
  const int k_tiles = (K + D_BK - 1) / D_BK;
  const int want = (4 * sm_count() + col_tiles - 1) / col_tiles;
  const int splits = want < k_tiles ? want : k_tiles;
  if (splits <= 1) return {1, K};
  const int per = (k_tiles + splits - 1) / splits;  // k tiles per slice
  return {(k_tiles + per - 1) / per, per * D_BK};
}

// After a split-K launch: sum its partials in z order into `out`.
template <typename O>
void finish_split(const float* partial, Split sp, const float* bias, O* out, int M, int N, int act,
                  cudaStream_t s) {
  if (sp.splits <= 1) return;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce<O><<<blocks, 256, 0, s>>>(partial, sp.splits, bias, out, M, N, act);
}

}  // namespace repro

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of fp32 scratch that a GEMM of this shape needs on the current
// device (its split-K partials; 0 when the contraction is not split).
// `splittable`: the kernel splits its decode tile along K; `k_chunk`: the
// contraction per block, 0 for plan_split's choice.
extern "C" long long split_workspace(int M, int N, int K, int splittable, int k_chunk) {
  const repro::Split sp = repro::plan_split(M, N, K, splittable != 0, k_chunk);
  return sp.splits > 1 ? (long long)sp.splits * M * N * (long long)sizeof(float) : 0;
}
