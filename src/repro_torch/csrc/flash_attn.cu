// Forward flash attention for Hopper over (B, S, H, D) tensors, D <= 128,
// with grouped-query K/V read in place.
//
// Replaces the TPU kernel repro/kernels/attention/kernel.py::_flash_kernel
// (launched by flash_attention_call).  Same algorithm and numerics: one block
// owns a resident tile of query rows and streams K/V tiles of 64 keys,
// keeping the running max m, the running sum l and the output accumulator in
// fp32 (online softmax).  Scores are q.k in fp32 times `scale`; masked scores
// become -1e30 (never -inf, so exp never sees inf - inf) under the reference
// rule
//     kpos < kv_valid  [and kpos <= qpos if causal]  [and kpos > qpos - window];
// whole K/V tiles outside the mask are skipped by the reference's `needed`
// test at this kernel's tile sizes; P is rounded to bf16 for P @ V; rows
// whose l stayed 0 are written as 0.  The TPU's sequential kv grid dimension
// becomes the loop inside the block.  Query head h reads K/V head
// h / (H / Hkv): the reference's callers repeat K/V in HBM, this kernel does
// not.  q, k and v are read through their strides (last dimension
// contiguous, rows 16-byte aligned); o is written (B, Sq, H, D) contiguous.
//
// What bounds it on the card: at the prefill shape (S = 512, D = 128) a head
// does ~S/2 = 256 operations per byte of Q/K/V/O under the causal mask, near
// the H100's ~295 FLOP/byte balance, so neither bound dominates: the bytes
// bound is 7.5 us at internlm2's shape, the tensor-core bound 4.3 us.  The
// kernel is held back by the softmax, whose dependent chain (products, row
// max over four threads, exp2, the rescale) sits between the two products of
// each warpgroup, and by each block filling its own pipeline (measured on
// the H100 with 64-key tiles: the kernel with the softmax cut out took 58 %
// of the time, with all compute cut out 38 %).
//
// Design, bf16 (the served type):
//   * a block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and a producer warpgroup one thread of
//     which issues every load; setmaxnreg moves registers to the consumers;
//     the two consumers interleave on the tensor cores, one's softmax
//     running while the other's products do;
//   * Q is loaded once by TMA; K and V tiles of 128 keys stream by TMA
//     through a two-stage ring of 128-byte-swizzled shared memory, with a
//     full and an empty mbarrier per stage; TMA zero-fills D up to DP (64 or
//     128) and the ragged sequence tail.  128-key tiles halve the softmax's
//     fixed cost per key against 64-key ones (4-17 % faster, measured);
//   * S = Q K^T is wgmma m64n128k16 over DP/16 steps, both operands in
//     shared memory (a K tile, keys x D row-major, is already the K-major B
//     operand);
//   * the softmax runs on the S registers: mask (only on tiles that touch an
//     edge), row max and row sum over the four threads that share a row by
//     shuffles, exp2 with log2(e) * scale folded into the scores, the O
//     rescale in registers;
//   * O += P V is wgmma m64n{DP}k16 with A from registers: P is packed to
//     bf16 in the accumulator's own layout, which is the A-fragment layout;
//     V is the B operand from shared memory, MN-major (the transpose bit);
//   * no shared-memory round trip of S or P, and O stays in registers until
//     the end: O / l is then staged once through the warpgroup's own Q tile
//     (128-byte-swizzled) so that each warp stores whole rows;
//   * under the causal mask, q tiles launch longest first, so the tail of the
//     grid is short blocks.
// fp32 inputs (not on any served path) run on the CUDA cores: 64 query rows
// per block, four warps of 16 rows, scores and output in shared memory.

#include "common.cuh"
#include "hopper.cuh"

namespace hp = repro::hopper;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BKV = 64;  // keys per streamed tile of the fp32 path

struct Mask {
  int Sq, Skv, kv_valid, causal, window;
};

// The reference's whole-tile skip for q rows [q_lo, q_lo + bq) and keys [k_lo, k_lo + bkv).
__device__ __forceinline__ bool tile_needed(int k_lo, int q_lo, int bq, int bkv, const Mask& mk) {
  bool need = k_lo < mk.kv_valid;
  if (mk.causal) need = need && k_lo <= q_lo + bq - 1;
  if (mk.window > 0) need = need && k_lo + bkv - 1 >= q_lo - mk.window + 1;
  return need;
}

__device__ __forceinline__ bool key_ok(int kpos, int qpos, const Mask& mk) {
  bool ok = kpos < mk.kv_valid;
  if (mk.causal) ok = ok && kpos <= qpos;
  if (mk.window > 0) ok = ok && kpos > qpos - mk.window;
  return ok;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, warp-specialised.
// ---------------------------------------------------------------------------

constexpr int W_BQ = 128, W_BKV = 128, W_STAGES = 2, W_NT = 384;
constexpr int PANEL = 64 * 128;              // 64 rows x 128 bytes: one Q box, 8 KB
constexpr int KV_PANEL = W_BKV * 128;        // W_BKV rows x 128 bytes: one K or V box, 16 KB

template <int DP>
struct WgLayout {
  static constexpr int NP = DP / 64;            // 64-wide d panels per row
  static constexpr int Q_HALF = NP * PANEL;     // one consumer's 64 query rows
  static constexpr int TILE = NP * KV_PANEL;    // one K or V tile of W_BKV keys
  static constexpr int STAGE = 2 * TILE;        // K then V
  static constexpr int RING = 2 * Q_HALF;       // the ring starts after Q
  static constexpr int BARS = RING + W_STAGES * STAGE;
  static constexpr int SMEM = BARS + (1 + 2 * W_STAGES) * 8 + 1024;  // + alignment
};

template <int DP>
__global__ void __launch_bounds__(W_NT, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H, int Hkv,
                       int D, float scale_log2, Mask mk) {
  using L = WgLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = hp::align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + W_STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;  // longest first
  const int q0 = tile * W_BQ;
  const int hk = h / (H / Hkv);
  const int n_kv = (mk.Skv + W_BKV - 1) / W_BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < W_STAGES; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 2);  // both consumer warpgroups release a stage
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hp::mbar_arrive_expect_tx(q_full, 2 * L::Q_HALF);
      for (int half = 0; half < 2; ++half)
        for (int p = 0; p < L::NP; ++p)
          hp::tma_load_4d(smem + (half * L::NP + p) * PANEL, &tq, q_full, p * 64, h, q0 + half * 64, b);
      int it = 0;
      for (int j = 0; j < n_kv; ++j) {
        if (!tile_needed(j * W_BKV, q0, W_BQ, W_BKV, mk)) continue;
        const int s = it % W_STAGES;
        hp::mbar_wait(&empty[s], ((it / W_STAGES) & 1) ^ 1);
        unsigned char* st = smem + L::RING + s * L::STAGE;
        hp::mbar_arrive_expect_tx(&full[s], L::STAGE);
        for (int p = 0; p < L::NP; ++p) {
          hp::tma_load_4d(st + p * KV_PANEL, &tk, &full[s], p * 64, hk, j * W_BKV, b);
          hp::tma_load_4d(st + L::TILE + p * KV_PANEL, &tv, &full[s], p * 64, hk, j * W_BKV, b);
        }
        ++it;
      }
    }
    return;
  }

  // Consumer warpgroup cw owns query rows q0 + 64 cw .. + 63; this thread
  // holds rows row0 and row0 + 8 of them (the wgmma accumulator layout).
  hp::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32;
  const int wq_lo = q0 + cw * 64, wq_hi = wq_lo + 63;
  const int row0 = wq_lo + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int col0 = (lane % 4) * 2;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t qa = hp::smem_u32(smem + cw * L::Q_HALF);
  hp::mbar_wait(q_full, 0);

  int it = 0;
  for (int j = 0; j < n_kv; ++j) {
    const int k_lo = j * W_BKV;
    if (!tile_needed(k_lo, q0, W_BQ, W_BKV, mk)) continue;
    const int s = it % W_STAGES;
    hp::mbar_wait(&full[s], (it / W_STAGES) & 1);
    const uint32_t ka = hp::smem_u32(smem + L::RING + s * L::STAGE);
    const uint32_t va = ka + L::TILE;
    float sc[W_BKV / 2];
#pragma unroll
    for (int i = 0; i < W_BKV / 2; ++i) sc[i] = 0.f;
    hp::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      const uint32_t off = (kd % 4) * 32;
      hp::wgmma_m64n128k16_ss(sc, hp::desc_sw128(qa + (kd / 4) * PANEL + off, 16, 1024),
                              hp::desc_sw128(ka + (kd / 4) * KV_PANEL + off, 16, 1024), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operand(sc);

    // Mask (only where the tile meets an edge of the mask), then the row max.
    const bool edge = k_lo + W_BKV > mk.kv_valid || (mk.causal && k_lo + W_BKV - 1 > wq_lo) ||
                      (mk.window > 0 && k_lo <= wq_hi - mk.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < W_BKV / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float t = sc[4 * c + 2 * i + jj] * scale_log2;
          if (edge && !key_ok(k_lo + 8 * c + col0 + jj, row0 + 8 * i, mk)) t = NEG_INF;
          sc[4 * c + 2 * i + jj] = t;
          mx[i] = fmaxf(mx[i], t);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P = exp2(t - m), its partial row sums (the four threads of a row are
    // summed once, at the end), and P packed as the A fragments of P @ V.
    uint32_t pa[W_BKV / 16][4];
#pragma unroll
    for (int c = 0; c < W_BKV / 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = fast_exp2(sc[4 * c + 2 * i] - m[i]);
        const float p1 = fast_exp2(sc[4 * c + 2 * i + 1] - m[i]);
        l[i] += p0 + p1;
        pa[c / 2][(c % 2) * 2 + i] = hp::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      acc[4 * c] *= alpha[0];
      acc[4 * c + 1] *= alpha[0];
      acc[4 * c + 2] *= alpha[1];
      acc[4 * c + 3] *= alpha[1];
    }
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W_BKV / 16; ++kk)
      hp::wgmma_rs_tb<DP>(acc, pa[kk], hp::desc_sw128(va + kk * 16 * 128, KV_PANEL, 1024), 1);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_operand(acc);
    if (threadIdx.x % 128 == 0) hp::mbar_arrive(&empty[s]);
    ++it;
  }

  // O / l in registers, then through this warpgroup's own Q tile (its last
  // product that reads Q is done), 128-byte-swizzled, so that each warp
  // stores whole rows; rows past Sq and columns past D are dropped.
  constexpr int ROW = DP * 2;  // bytes per staged row
  constexpr int CPR = ROW / 16;
  unsigned char* stage = smem + cw * L::Q_HALF;
  const int lr = row0 - wq_lo;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const int rr = lr + 8 * i;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(stage + rr * ROW + hp::swizzle128(rr, c) * 16 + col0 * 2) =
          __floats2bfloat162_rn(acc[4 * c + 2 * i] * inv, acc[4 * c + 2 * i + 1] * inv);
  }
  hp::named_barrier(1 + cw, 128);
  for (int e = threadIdx.x % 128; e < 64 * CPR; e += 128) {
    const int rr = e / CPR, ch = e % CPR;
    const int qpos = wq_lo + rr;
    if (qpos < mk.Sq && ch * 8 < D)  // D is a multiple of 8: a chunk is wholly in or out
      *reinterpret_cast<uint4*>(o + (((size_t)b * mk.Sq + qpos) * H + h) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + rr * ROW + hp::swizzle128(rr, ch) * 16);
  }
}

// Tensor map of a (B, S, heads, D) bf16 operand, boxes of `rows` rows x 64 d of one head.
int map_bshd(CUtensorMap* map, const void* base, int B, int S, int heads, int D, long long sb, long long ss,
             long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hp::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box);
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int D,
                 const long long* qs, const long long* ks, const long long* vs, float scale, const Mask& mk,
                 cudaStream_t s) {
  using L = WgLayout<DP>;
  CUtensorMap tq, tk, tv;
  int e = map_bshd(&tq, q, B, mk.Sq, H, D, qs[0], qs[1], qs[2], 64);
  if (e == 0) e = map_bshd(&tk, k, B, mk.Skv, Hkv, D, ks[0], ks[1], ks[2], W_BKV);
  if (e == 0) e = map_bshd(&tv, v, B, mk.Skv, Hkv, D, vs[0], vs[1], vs[2], W_BKV);
  if (e != 0) return e;
  auto kern = flash_wgmma_kernel<DP>;
  const cudaError_t attr = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid(H, B, (mk.Sq + W_BQ - 1) / W_BQ);
  kern<<<grid, W_NT, L::SMEM, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hkv, D,
                                   scale * 1.4426950408889634f, mk);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores.
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;  // query rows per block (4 warps x 16)
constexpr int F_NT = 128;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

struct F32Layout {  // dynamic shared-memory carve-up for head dim padded to DP
  int ld;
  size_t q, k, v, s, o, bytes;
  __host__ __device__ explicit F32Layout(int DP) {
    ld = DP + 4;  // +16 bytes per row against bank conflicts
    q = 0;
    k = q + align128(sizeof(float) * F_BQ * ld);
    v = k + align128(sizeof(float) * BKV * ld);
    s = v + align128(sizeof(float) * BKV * ld);
    o = s + align128(sizeof(float) * F_BQ * BKV);
    bytes = o + align128(sizeof(float) * F_BQ * ld);
  }
};

// Rows [r0, r0 + rows) of a strided operand (row r at g + r * stride) into
// shared memory, DP columns of which the first D are data and the rest zero;
// rows past R are zero.  `vec`: 16-byte chunks through cp.async.
__device__ __forceinline__ void load_rows(float* smem, int ld, const float* g, long long stride, int r0, int rows,
                                          int R, int D, int DP, bool vec) {
  const int cpr = DP / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += F_NT) {
    const int r = i / cpr, c = (i % cpr) * 4, gr = r0 + r;
    float* dst = smem + r * ld + c;
    const float* src = g + (long long)gr * stride + c;
    if (vec && gr < R && c < D) {
      repro::cp_async16(dst, src);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j] = (gr < R && c + j < D) ? src[j] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(F_NT)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, int H, int Hkv, int D, int DP, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss, long long ksh, long long vsb, long long vss,
                     long long vsh, float scale, Mask mk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L(DP);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* S = reinterpret_cast<float*>(smem + L.s) + warp * 16 * BKV;
  float* O = reinterpret_cast<float*>(smem + L.o) + warp * 16 * L.ld;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tile = mk.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q_lo = tile * F_BQ;
  const int hk = h / (H / Hkv);
  const float* qg = q + b * qsb + h * qsh;
  const float* kg = k + b * ksb + hk * ksh;
  const float* vg = v + b * vsb + hk * vsh;

  // Lanes 2r and 2r+1 own row r of the warp's 16 rows, each half of its columns.
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qpos = q_lo + warp * 16 + r;
  float m_i = NEG_INF, l_i = 0.f;
  for (int e = lane; e < 16 * DP; e += 32) O[(e / DP) * L.ld + e % DP] = 0.f;

  load_rows(Qs, L.ld, qg, qss, q_lo, F_BQ, mk.Sq, D, DP, vec);
  repro::cp_async_commit();

  for (int k_lo = 0; k_lo < mk.Skv; k_lo += BKV) {
    if (!tile_needed(k_lo, q_lo, F_BQ, BKV, mk)) continue;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows(Ks, L.ld, kg, kss, k_lo, BKV, mk.Skv, D, DP, vec);
    load_rows(Vs, L.ld, vg, vss, k_lo, BKV, mk.Skv, D, DP, vec);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    for (int e = lane; e < 16 * BKV; e += 32) {  // S = Q K^T for this warp's 16 rows
      const float* qr = Qs + (warp * 16 + e / BKV) * L.ld;
      const float* kr = Ks + (e % BKV) * L.ld;
      float a = 0.f;
      for (int d = 0; d < DP; ++d) a = fmaf(qr[d], kr[d], a);
      S[e] = a;
    }
    __syncwarp();

    // Online softmax on row r: mask, new max, rescale factor, P, row sum.
    float* srow = S + r * BKV;
    const int c0 = half * (BKV / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float s = key_ok(k_lo + c, qpos, mk) ? srow[c] * scale : NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float sum = 0.f;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float p = expf(srow[c] - m_new);
      srow[c] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) O[r * L.ld + c] *= alpha;
    __syncwarp();

    for (int e = lane; e < 16 * DP; e += 32) {  // O += P V
      const int row = e / DP, col = e % DP;
      float a = O[row * L.ld + col];
      for (int t = 0; t < BKV; ++t) a = fmaf(S[row * BKV + t], Vs[t * L.ld + col], a);
      O[row * L.ld + col] = a;
    }
    __syncwarp();
  }

  if (qpos < mk.Sq) {
    float* orow = o + (((size_t)b * mk.Sq + qpos) * H + h) * D;
    for (int c = half * (DP / 2); c < (half + 1) * (DP / 2) && c < D; ++c)
      orow[c] = l_i > 0.f ? O[r * L.ld + c] / l_i : 0.f;
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int D,
               const long long* qs, const long long* ks, const long long* vs, float scale, const Mask& mk,
               cudaStream_t s) {
  const int DP = (D + 15) / 16 * 16;
  const F32Layout L(DP);
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bool vec = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) && D % 4 == 0;
  for (int i = 0; i < 3; ++i) vec = vec && qs[i] % 4 == 0 && ks[i] % 4 == 0 && vs[i] % 4 == 0;
  dim3 grid(H, B, (mk.Sq + F_BQ - 1) / F_BQ);
  flash_f32_kernel<<<grid, F_NT, L.bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, D, DP, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale,
      mk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D) of dtype `dtype`, each through its
// element strides (batch, sequence, head; the last dimension contiguous);
// o: (B, Sq, H, D) contiguous.  Hkv divides H; window <= 0 means no sliding
// window; keys at kv_valid and beyond are masked.  bf16 needs 16-byte
// aligned bases and strides that are multiples of 8 (TMA).  Launches on
// `stream`; returns the CUDA error code (0 = ok).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int Sq,
                              int Skv, int D, long long qsb, long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb, long long vss, long long vsh, float scale,
                              int causal, int window, int kv_valid, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qs[3] = {qsb, qss, qsh}, ks[3] = {ksb, kss, ksh}, vs[3] = {vsb, vss, vsh};
  if (B <= 0 || B > 65535 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Skv <= 0 || D <= 0 || D > 128 ||
      (Sq + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{Sq, Skv, kv_valid, causal, window};
  if (dtype == repro::DT_BF16) {
    bool tma_ok = repro::aligned16(q) && repro::aligned16(k) && repro::aligned16(v) && D % 8 == 0;
    for (int i = 0; i < 3; ++i) tma_ok = tma_ok && qs[i] % 8 == 0 && ks[i] % 8 == 0 && vs[i] % 8 == 0;
    if (!tma_ok) return static_cast<int>(cudaErrorInvalidValue);
    if (D <= 64) return launch_wgmma<64>(q, k, v, o, B, H, Hkv, D, qs, ks, vs, scale, mk, s);
    return launch_wgmma<128>(q, k, v, o, B, H, Hkv, D, qs, ks, vs, scale, mk, s);
  }
  if (dtype == repro::DT_F32) return launch_f32(q, k, v, o, B, H, Hkv, D, qs, ks, vs, scale, mk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
