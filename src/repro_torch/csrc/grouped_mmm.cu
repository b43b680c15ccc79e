// Grouped (per-expert) GEMM for Hopper: y[e] = x[e] @ w[e] for every expert e,
// x: (E, C, K), w: (E, K, N) -> y: (E, C, N), fp32 accumulator, no epilogue.
//
// Replaces the TPU kernel repro/kernels/grouped/kernel.py::_grouped_kernel
// (launched by grouped_matmul_call), the MoE expert GEMM.  The TPU grid is
// (E, C/bc, N/bn, K/bk) with k innermost and sequential.  Here the expert is
// the grid's z axis and k the loop inside each block, so every expert slice
// is an independent (C, K) @ (K, N) product with a C-stationary fp32
// accumulator.
//
// What bounds it on the card: the MoE path gives every expert C capacity
// rows, so a call over all rows reads all E expert weights once.  At
// prefill (C = 160 rows of 2048 tokens x 8 / 128 experts x 1.25) a call
// does about 125 operations per byte, below the H100's ~295 FLOP/byte
// balance, and at decode (C = 8) about 8: both are bound by reading w from
// HBM (403 MB a call at qwen3-moe's widths).
// What the design does about that:
//   * prefill (bf16, C > 16, K and N multiples of 8, 16-byte-aligned bases):
//     the systolic GEMM's warp-specialised wgmma tile (wgmma_gemm.cuh)
//     batched over experts: one producer thread keeps a four-stage TMA ring
//     full from 3-D tensor maps, (K, C, E) for x and (N, K, E) for w, the
//     expert the outer coordinate, so rows past C are zero-filled and never
//     the next expert's tokens; consumer warpgroups of 64 rows run wgmma
//     m64n128k16.  The tile covers 64, 128 or 192 rows (one to three
//     consumers), picked by C (kernels/grouped/kernel.py grouped_path): the
//     fewest row tiles, since each re-reads the expert's weights, then the
//     fewest padding rows.  At C = 160 one 192-row tile covers an expert,
//     so each weight tile is read from HBM once; each stage holds 16 KB of
//     weights, 64 KB in flight per SM.  Blocks of one expert are adjacent in
//     launch order (x fastest), so an expert's token tile is read from HBM
//     once and from L2 by its other column tiles.
//   * decode (C <= 16): the systolic GEMM's WMMA 16-row tile (gemm.cuh),
//     4 warps over 64 columns, batched; no split-K (E x N / 64 blocks fill
//     the card).  Shapes TMA cannot take: the WMMA 128x128 tile.  fp32: the
//     CUDA-core FMA tile (the reference computes fp32 products in full fp32;
//     TF32 would not match it).
//   * empty capacity rows: the caller may pass `rows`, each expert's number
//     of leading rows that can hold a token (min(count, C) from the
//     dispatch).  On every tile, a block whose rows all lie at or past it
//     loads no weights and writes zeros, which is what the reference
//     computes for those rows, because the dispatch filled them with zeros.
//     At decode (batch 4, top-8) at most 32 of 128 experts hold a token, so
//     at most a quarter of the weights are read.
//   * ragged C, K and N: TMA zero-fill and masked stores (wgmma), masked
//     staging (WMMA and FMA).  Every output element is written once by one
//     thread, no atomics: two runs give the same bits.

#include "gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

// Paths, as numbered by the Python binding's PATHS (kernels/grouped/kernel.py).
enum Path { P_FMA = 0, P_DECODE = 1, P_WMMA = 2, P_WGMMA_64 = 3, P_WGMMA_128 = 4, P_WGMMA_192 = 5 };

// The launch of `path` once the pointers are checked (`q` as for the
// launchers: given one, it describes the launch and launches nothing).
int launch(const void* x, const void* w, void* y, int E, int C, int K, int N, int dtype, const int* rows, int path,
           cudaStream_t s, repro::LaunchQuery* q) {
  const bool fp32 = dtype == repro::DT_F32;
  if ((dtype != repro::DT_F32 && dtype != repro::DT_BF16) || E <= 0 || E > 65535 || C <= 0 || N <= 0 || K < 0 ||
      path < P_FMA || path > P_WGMMA_192 || fp32 != (path == P_FMA) ||
      (!fp32 && (path == P_DECODE) != (C <= repro::D_BM)) ||
      (path >= P_WGMMA_64 && (K == 0 || K % 8 != 0 || N % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  using B16 = __nv_bfloat16;
  namespace wg = repro::wg;
  switch (path) {
    case P_WGMMA_64:
      return wg::launch_wgmma<true, 1, 128, B16>(x, w, nullptr, y, C, N, K, repro::ACT_NONE, E, rows, s, q);
    case P_WGMMA_128:
      return wg::launch_wgmma<true, 2, 128, B16>(x, w, nullptr, y, C, N, K, repro::ACT_NONE, E, rows, s, q);
    case P_WGMMA_192:
      return wg::launch_wgmma<true, 3, 128, B16>(x, w, nullptr, y, C, N, K, repro::ACT_NONE, E, rows, s, q);
    default:  // FMA, the decode tile or the WMMA tile: gemm.cuh picks by dtype and C as the path did
      return repro::gemm<true>(x, w, nullptr, y, C, N, K, E, dtype, dtype, repro::ACT_NONE, nullptr, 0, s, rows, q);
  }
}

}  // namespace

// x: (E, C, K), w: (E, K, N), y: (E, C, N), all row-major and of dtype
// `dtype` (bf16 or fp32); rows: (E,) int32 on the device, or null (all C
// rows); `path`: one of Path, which must fit the operands (fp32 <-> FMA;
// the decode tile C <= 16; wgmma bf16, C > 16, K and N multiples of 8 and
// 16-byte-aligned bases).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int grouped_mmm(const void* x, const void* w, void* y, int E, int C, int K, int N, int dtype,
                           const void* rows, int path, void* stream) {
  if (path >= P_WGMMA_64 && (!repro::aligned16(x) || !repro::aligned16(w)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, w, y, E, C, K, N, dtype, static_cast<const int*>(rows), path, static_cast<cudaStream_t>(stream),
                nullptr);
}

// What a grouped_mmm launch of `path` at (E, C, K, N) and `dtype` runs,
// taken from the launch above with a LaunchQuery (no launch):
// QUERY_FIELDS values into `out`.  Returns 0, or the code the launch's
// checks would give (aligned bases assumed).
extern "C" int grouped_mmm_query(int E, int C, int K, int N, int dtype, int path, long long* out) {
  repro::LaunchQuery q{};
  const int e = launch(nullptr, nullptr, nullptr, E, C, K, N, dtype, nullptr, path, nullptr, &q);
  if (e == 0) repro::export_query(q, out);
  return e;
}
