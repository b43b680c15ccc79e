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

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace repro

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
