// The block-scaled GEMM's product with e4m3 (fp8) operands on Hopper's 8-bit
// wgmma, retiring the narrow partial into an fp32 accumulator at the end of
// every scale step as the int8 prefill tile of csrc/systolic_qmm.cu does:
// (partial * a_scale) * b_scale, each value at the row and column the wgmma
// layout gives it, the next step starting with scale_d = 0.  A measuring
// probe for tools/fp8_wgmma_error.py, not a kernel of the port: it shows how
// far the tensor cores' fp8 accumulation lies from the plain version, which
// is why the port keeps fp8 on the WMMA tiles (widened to bf16, exact).
//
// Kept simple: one warpgroup per 64x128 output tile; every thread copies
// its share of each 128-deep k stage of A (64 rows) and B (128 columns,
// K-major) into 128-byte-swizzled shared memory, then the warpgroup issues
// the stage's four m64n128k32 products one at a time, retiring after each
// one that ends a scale step.  M a multiple of 64, N of 128, K of 128, the
// scale step 32, a multiple of 128, or 0 (whole K).

#include "hopper.cuh"

namespace hp = repro::hopper;

namespace {

// d (+)= A @ B over one 32-deep k step of e4m3 operands into fp32, 128
// columns, both K-major in shared memory.  scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k32_e4m3(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

constexpr int BM = 64, BN = 128, BK = 128;

// Copy the ROWS x 128-byte k window at (r0, k0) of a row-major (R, K) byte
// matrix into `s` with the 128-byte swizzle (chunk c of row r at c ^ (r % 8)).
template <int ROWS>
__device__ __forceinline__ void stage(unsigned char* s, const unsigned char* g, int K, int r0, int k0) {
  for (int i = threadIdx.x; i < ROWS * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    *reinterpret_cast<uint4*>(s + r * 128 + hp::swizzle128(r, c) * 16) =
        *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * K + k0 + 16 * c);
  }
}

__global__ void __launch_bounds__(128) fp8_wgmma_kernel(const unsigned char* __restrict__ A,
                                                        const float* __restrict__ A_s,
                                                        const unsigned char* __restrict__ B,
                                                        const float* __restrict__ B_s, float* __restrict__ out,
                                                        int N, int K, int step, int n_sa) {
  __shared__ __align__(1024) unsigned char sa_tile[BM * BK];
  __shared__ __align__(1024) unsigned char sb_tile[BN * BK];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x % 32;
  const int lr = threadIdx.x / 32 * 16 + lane / 4;  // rows lr and lr + 8 of the tile
  float part[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    part[i] = 0.f;
    acc[i] = 0.f;
  }
  const int run = step > 0 ? step : K;
  bool fresh = true;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous stage's products are done with the tiles
    stage<BM>(sa_tile, A, K, m0, k0);
    stage<BN>(sb_tile, B, K, n0, k0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes, read by wgmma
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BK / 32; ++j) {
      hp::fence_operand(part);
      hp::wgmma_fence();
      wgmma_m64n128k32_e4m3(part, hp::desc_sw128(hp::smem_u32(sa_tile) + 32 * j, 16, 1024),
                            hp::desc_sw128(hp::smem_u32(sb_tile) + 32 * j, 16, 1024), fresh ? 0 : 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_operand(part);
      const int kend = k0 + 32 * (j + 1);
      fresh = kend % run == 0 || kend == K;
      if (fresh) {  // retire the step that started at kend - run (or at 0)
        const int ks = step > 0 ? (kend - 1) / step : 0;
        const float s0 = A_s[(size_t)(m0 + lr) * n_sa + ks], s1 = A_s[(size_t)(m0 + lr + 8) * n_sa + ks];
#pragma unroll
        for (int c = 0; c < BN / 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * c + 2 * i + e;
              const float sb = B_s[(size_t)ks * N + n0 + 8 * c + 2 * (lane % 4) + e];
              acc[x] = __fadd_rn(acc[x], __fmul_rn(__fmul_rn(part[x], i ? s1 : s0), sb));
            }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(size_t)(m0 + lr + 8 * i) * N + n0 + 8 * c + 2 * (lane % 4) + e] = acc[4 * c + 2 * i + e];
}

}  // namespace

// a: (M, K) e4m3 row-major; b: the (K, N) values stored (N, K) row-major;
// a_scales (M, K / step or 1), b_scales (K / step or 1, N) fp32; out (M, N)
// fp32.  step: 32, a multiple of 128, or 0 (whole K).  Returns
// cudaGetLastError() after the launch on the default stream.
extern "C" int fp8_wgmma(const void* a, const void* a_scales, const void* b, const void* b_scales, void* out,
                         int M, int N, int K, int step) {
  if (M % BM || N % BN || K % BK || !(step == 0 || step == 32 || step % BK == 0) || (step > 0 && K % step))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_sa = step > 0 ? K / step : 1;
  fp8_wgmma_kernel<<<dim3(N / BN, M / BM), 128>>>(
      static_cast<const unsigned char*>(a), static_cast<const float*>(a_scales),
      static_cast<const unsigned char*>(b), static_cast<const float*>(b_scales), static_cast<float*>(out), N, K,
      step, n_sa);
  return static_cast<int>(cudaGetLastError());
}
