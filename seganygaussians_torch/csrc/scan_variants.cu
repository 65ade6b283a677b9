// Transmittance-scan micro-benchmark for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel tools/bench_scan_variants.py:kernel (launched by
// run through pl.pallas_call).  For a (P = 256, K = 256) fp32 block s it
// loops n_chunk times
//
//     alpha    = min(0.99, exp(s + 1e-6 * acc[:, :1]))
//     T_before = exclusive cumulative product of (1 - alpha) along the scan axis
//     acc     += alpha * T_before
//
// and writes acc.  The variants differ in how T_before is computed, which is
// the question the tool asks: which way of taking a cumulative product along
// the instance axis is fastest on this card.
//
// The design rests on one fact: the chunks are coupled only through
// acc[:, 0].  In the five row variants column 0's T_before is exactly 1, so
// row r's feedback follows its own recurrence a <- a + min(0.99, exp(s[r, 0]
// + 1e-6 a)); in roll_sub it is a 256-row exclusive product scan of column 0
// a chunk.  So a call is three launches:
//
//   1. the chain: chain[i, r] = acc[r, 0] before chunk i, for i < n_chunk.
//      One thread a row (chain_rows_kernel, the same fp32 operations in the
//      same order as the plain version's column 0), or for roll_sub one warp
//      with 8 rows a lane: an in-lane running product, then shuffles
//      (chain_sub_kernel).  A latency-bound chain that touches nothing else:
//      timed alone it is the measured floor of the whole function.
//   2. the work: with the table every (row, chunk) pair is independent.  The
//      grid covers (row or column tile) x (chunk range), 132 blocks or more;
//      each block reads its rows' feedback from the table (1 KB a chunk,
//      L2-resident), accumulates its range in registers or shared memory and
//      writes one partial into a (n_range, 256, 256) scratch.
//   3. the sum: the partials added in range order, so the output is bitwise
//      repeatable.  No atomics; the wrapper allocates the table and the
//      scratch, the kernels allocate nothing.
//
// The variants' work launches, each keeping the strategy it is named for:
//
//   exp_only    no scan, acc += alpha: a warp a row, 8 columns a lane.
//   roll_lane   product scan along K, a warp a row with 8 consecutive
//               columns a lane: an in-lane running product, a 5-step
//               __shfl_up_sync Hillis-Steele scan of the lane totals, the
//               exclusive shift by one shuffle.  No shared memory.
//   seq_march   one thread a row marching K in order (the blend kernels'
//               inner loop); s and acc in shared memory.  A block holds 32
//               rows and 6 warps, each warp a sixth of the block's chunk
//               range; the warps' sums are added in order after the loop.
//   roll_sub    the same scan as roll_lane down the rows (axis 0): a warp
//               owns 8 columns and all 256 rows of them, 8 rows a lane.
//               Column 0's state comes from the table.
//   log_tri     exp(log1p(-alpha) @ strict-upper-triangular ones), the
//               product on the tensor cores with wgmma.mma_async .tf32
//               (fp32 accumulate).  A warpgroup owns 64 rows; a block holds
//               two, each on half of the block's chunk range, so two run on
//               every SM.  A (log1p(-alpha), TF32) comes from registers, as
//               the thread computed it; B from shared memory, written once.
//               In 64-column tiles the ones split into the tile's 8
//               diagonal k8 blocks (m64n64k8 against 8 x 64 triangles), the
//               all-zero blocks below them (skipped) and all-ones blocks
//               above, whose product is the row sums of the earlier tiles: a
//               running m64n8k8 product against ones that starts the next
//               tile's accumulator.  32 n64 and 24 n8 products a chunk
//               instead of the 128 n64 of the whole matrix.  B's columns are
//               permuted inside each group of 8 so that the accumulator holds
//               each element in the thread that holds it in A: alpha,
//               log1p(-alpha), the product and acc of an element all live in
//               one thread, and no barrier is needed in the chunk loop (a
//               warp's share of a wgmma reads only its own 16 rows of A).
//   log_tri_hs  the same product, compensated (the counterpart of the TPU's
//               HIGHEST): hi = tf32(x), lo = tf32(x - hi), two products
//               (hi.B + lo.B) since the ones are exact in TF32, about 21 bits.
//
// What bounds it.  Device memory is touched once at each end (256 KB in, 256
// KB out) plus the table and the partials (about 9 MB at 1000 chunks, mostly
// in L2), so operations bound it: per chunk one exp, the scan's multiply and
// the accumulate for each of the 65,536 elements at the whole card's rate,
// 0.0068 us (bound_us in the port's tools/bench_scan_variants.py).  Two
// things stand above that bound.  The chain, a dependent sequence of mul,
// add, expf, fminf and add a chunk (or the 256-row scan for roll_sub), which
// no design overlaps with itself: every variant pays it once, then its work
// launch.  And the accurate expf, 8 instructions where the bound counts one
// special-function operation; the log variants add log1pf and a second expf.

// Numerics.  IEEE fp32, expf and log1pf (not the fast intrinsics); built with
// --fmad=false like the blend kernels.  log_tri rounds log1p(-alpha) to TF32
// (cvt.rna: round to nearest, ties away) before the product; everything else
// is fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 256;  // rows
constexpr int K = 256;  // columns
constexpr float ALPHA_MAX = 0.99f;
constexpr float FEEDBACK = 1e-6f;
constexpr int MAX_RANGES = 33;  // chunk ranges: 4 x 33 = 132 blocks for log_tri
constexpr unsigned FULL = 0xffffffffu;

enum Variant { EXP_ONLY = 0, LOG_TRI = 1, LOG_TRI_HS = 2, ROLL_LANE = 3, ROLL_SUB = 4, SEQ_MARCH = 5 };

// f is the row's feedback term a * 1e-6f, computed once a row and chunk.
__device__ __forceinline__ float alpha_at(float s, float f) {
  return fminf(ALPHA_MAX, expf(s + f));
}

// First chunk of range j of n_range (the last range ends at n_chunk).
__device__ __forceinline__ int range_start(int j, int n_range, int n_chunk) {
  return (int)((long long)j * n_chunk / n_range);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// t[e]: the product of x over the warp's elements before this lane's element
// e, with 8 consecutive elements a lane and the lanes in order.  An in-lane
// running product, a Hillis-Steele scan of the lane totals over 5 shuffles,
// then the exclusive shift.
__device__ __forceinline__ void exclusive_product8(const float (&x)[8], float (&t)[8], int lane) {
  float p[8];
  p[0] = x[0];
#pragma unroll
  for (int e = 1; e < 8; ++e) p[e] = p[e - 1] * x[e];
  float incl = p[7];
#pragma unroll
  for (int sh = 1; sh < 32; sh <<= 1) {
    const float y = __shfl_up_sync(FULL, incl, sh);
    if (lane >= sh) incl *= y;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 1.0f;
  t[0] = excl;
#pragma unroll
  for (int e = 1; e < 8; ++e) t[e] = excl * p[e - 1];
}

// ---------------------------------------------------------------------------
// 1. The feedback chain.
// ---------------------------------------------------------------------------

// The five row variants: one thread a row, 8 single-warp blocks.
__global__ void __launch_bounds__(32) chain_rows_kernel(const float* __restrict__ s_in,
                                                       float* __restrict__ chain, int n_chunk) {
  const int r = blockIdx.x * 32 + threadIdx.x;
  const float s0 = s_in[r * K];
  float a = 0.0f;
  for (int i = 0; i < n_chunk; ++i) {
    chain[(size_t)i * P + r] = a;
    a = a + alpha_at(s0, a * FEEDBACK);
  }
}

// roll_sub: column 0 in one warp, rows 8 * lane .. 8 * lane + 7.
__global__ void __launch_bounds__(32) chain_sub_kernel(const float* __restrict__ s_in,
                                                      float* __restrict__ chain, int n_chunk) {
  const int lane = threadIdx.x;
  float s0[8], a[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    s0[e] = s_in[(8 * lane + e) * K];
    a[e] = 0.0f;
  }
  for (int i = 0; i < n_chunk; ++i) {
    store8(chain + (size_t)i * P + 8 * lane, a);
    float alpha[8], x[8], t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      alpha[e] = alpha_at(s0[e], a[e] * FEEDBACK);
      x[e] = 1.0f - alpha[e];
    }
    exclusive_product8(x, t, lane);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = a[e] + alpha[e] * t[e];
  }
}

// ---------------------------------------------------------------------------
// 2. The work launches: grid (tile, chunk range), one partial a range.
// ---------------------------------------------------------------------------

// exp_only and roll_lane: a warp a row, lane l on columns 8l .. 8l + 7.
constexpr int ROW_WARPS = 8;

template <int V>
__global__ void __launch_bounds__(ROW_WARPS * 32) row_warp_kernel(
    const float* __restrict__ s_in, const float* __restrict__ chain,
    float* __restrict__ partial, int n_chunk, int n_range) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int j = blockIdx.y;
  const int c0 = range_start(j, n_range, n_chunk), c1 = range_start(j + 1, n_range, n_chunk);
  float s[8], acc[8];
  load8(s_in + r * K + 8 * lane, s);
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int i = c0; i < c1; ++i) {
    const float f = chain[(size_t)i * P + r] * FEEDBACK;
    float alpha[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) alpha[e] = alpha_at(s[e], f);
    if (V == EXP_ONLY) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += alpha[e];
    } else {
      float x[8], t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 1.0f - alpha[e];
      exclusive_product8(x, t, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += alpha[e] * t[e];
    }
  }
  store8(partial + (size_t)j * P * K + r * K + 8 * lane, acc);
}

// roll_sub: a warp owns 8 columns and all 256 rows of them, lane l on rows
// 8l .. 8l + 7; the feedback of row r is chain[i, r].
constexpr int SUB_COLS = 8;
constexpr int SUB_WARPS = 4;

__global__ void __launch_bounds__(SUB_WARPS * 32) roll_sub_kernel(
    const float* __restrict__ s_in, const float* __restrict__ chain,
    float* __restrict__ partial, int n_chunk, int n_range) {
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * SUB_WARPS + (threadIdx.x >> 5)) * SUB_COLS;
  const int j = blockIdx.y;
  const int c0 = range_start(j, n_range, n_chunk), c1 = range_start(j + 1, n_range, n_chunk);
  float s[8][SUB_COLS], acc[8][SUB_COLS];  // [row e][column c]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    load8(s_in + (8 * lane + e) * K + col0, s[e]);
#pragma unroll
    for (int c = 0; c < SUB_COLS; ++c) acc[e][c] = 0.0f;
  }
  for (int i = c0; i < c1; ++i) {
    float f[8];
    load8(chain + (size_t)i * P + 8 * lane, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] *= FEEDBACK;
#pragma unroll
    for (int c = 0; c < SUB_COLS; ++c) {
      float alpha[8], x[8], t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        alpha[e] = alpha_at(s[e][c], f[e]);
        x[e] = 1.0f - alpha[e];
      }
      exclusive_product8(x, t, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e][c] += alpha[e] * t[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) store8(partial + (size_t)j * P * K + (8 * lane + e) * K + col0, acc[e]);
}

// seq_march: one thread a row marching K in order.  A block holds 32 rows
// (s once, row stride K + 1 so a warp's rows fall in distinct banks) and
// SEQ_WARPS warps, warp w on the w-th of SEQ_WARPS sub-ranges of the block's
// chunk range with its own acc.
constexpr int SEQ_ROWS = 32;
constexpr int SEQ_WARPS = 6;
constexpr int SEQ_LD = K + 1;
constexpr int SEQ_BATCH = 16;  // alphas computed ahead of the march
constexpr int SEQ_SMEM = (1 + SEQ_WARPS) * SEQ_ROWS * SEQ_LD * (int)sizeof(float);  // 230,272 B

__global__ void __launch_bounds__(SEQ_WARPS * 32) seq_march_kernel(
    const float* __restrict__ s_in, const float* __restrict__ chain,
    float* __restrict__ partial, int n_chunk, int n_range) {
  extern __shared__ float sh_seq[];
  float* sh_s = sh_seq;
  float* sh_acc = sh_seq + SEQ_ROWS * SEQ_LD;  // [warp][row][k]
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * SEQ_ROWS;
  const int j = blockIdx.y;
  const int c0 = range_start(j, n_range, n_chunk), c1 = range_start(j + 1, n_range, n_chunk);
  const int b0 = c0 + (int)((long long)w * (c1 - c0) / SEQ_WARPS);
  const int b1 = c0 + (int)((long long)(w + 1) * (c1 - c0) / SEQ_WARPS);
  for (int idx = threadIdx.x; idx < SEQ_ROWS * K; idx += SEQ_WARPS * 32) {
    const int rr = idx / K, k = idx % K;
    sh_s[rr * SEQ_LD + k] = s_in[(r0 + rr) * K + k];
  }
  for (int idx = threadIdx.x; idx < SEQ_WARPS * SEQ_ROWS * SEQ_LD; idx += SEQ_WARPS * 32)
    sh_acc[idx] = 0.0f;
  __syncthreads();
  const float* my_s = sh_s + t * SEQ_LD;
  float* my_acc = sh_acc + (w * SEQ_ROWS + t) * SEQ_LD;
  for (int i = b0; i < b1; ++i) {
    const float f = chain[(size_t)i * P + r0 + t] * FEEDBACK;
    float T = 1.0f;
    // 16 alphas at a time, independent of one another, then the march
    // through them in order: a warp's only company is 5 others on its SM,
    // so the latency of expf has to hide behind its own neighbours.
    for (int k0 = 0; k0 < K; k0 += SEQ_BATCH) {
      float alpha[SEQ_BATCH];
#pragma unroll
      for (int e = 0; e < SEQ_BATCH; ++e) alpha[e] = alpha_at(my_s[k0 + e], f);
#pragma unroll
      for (int e = 0; e < SEQ_BATCH; ++e) {
        my_acc[k0 + e] += alpha[e] * T;
        T *= 1.0f - alpha[e];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < SEQ_ROWS * K; idx += SEQ_WARPS * 32) {
    const int rr = idx / K, k = idx % K;
    float sum = sh_acc[rr * SEQ_LD + k];
#pragma unroll
    for (int w2 = 1; w2 < SEQ_WARPS; ++w2) sum += sh_acc[(w2 * SEQ_ROWS + rr) * SEQ_LD + k];
    partial[(size_t)j * P * K + (r0 + rr) * K + k] = sum;
  }
}

// log_tri and log_tri_hs: a warpgroup on 64 rows, the triangular product on
// the tensor cores.  A block holds 64 rows and two warpgroups, each on half
// of the block's chunk range with its own acc; s is shared.
constexpr int LOG_ROWS = 64;  // wgmma's M
constexpr int LOG_WG = 2;     // warpgroups a block
constexpr int WG_THREADS = 128;
constexpr int LOG_EL = LOG_ROWS * K / WG_THREADS;  // 128 elements a thread
constexpr int TILE_N = 64;                         // columns of a product tile
constexpr int N_TILES = K / TILE_N;
constexpr int KB_TILE = TILE_N / 8;  // k8 blocks across one tile
constexpr int B_BLOCK = 8 * TILE_N;  // floats in one 8 x 64 diagonal block of B
constexpr int ONES_BLOCK = 8 * 8;    // floats in the 8 x 8 block of ones
constexpr int LOG_SMEM =
    ((1 + LOG_WG) * LOG_EL * WG_THREADS + KB_TILE * B_BLOCK + ONES_BLOCK) * (int)sizeof(float);

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// B's column p of a group of 8 holds logical column (p >> 1) + 4 (p & 1), so
// the accumulator's pair (2t, 2t + 1) is A's pair (t, t + 4).
__device__ __forceinline__ int logical_col(int p) { return (p >> 1) + 4 * (p & 1); }

// A K-major operand without swizzle: core matrices of 8 rows x 16 bytes,
// 128 bytes apart along K (LBO) and 256 bytes apart along N (SBO).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of r across the wgmma fences.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// d += A (64 x 8, from registers) @ B (8 x 64, shared memory), TF32 in,
// fp32 accumulate.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// r += A (64 x 8) @ ones (8 x 8): every column of r is the row sums.
__device__ __forceinline__ void wgmma_n8(float (&r)[4], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(r[0]), "+f"(r[1]), "+f"(r[2]), "+f"(r[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Thread (warp w of its warpgroup, lane = 4g + t) holds element e = 4 kb + v
// at row 16w + g + 8 (v & 1), column 8 kb + t + 4 (v >> 1): wgmma's A
// fragment of k8 block kb.  Its s lives in shared slot e * 128 + (its index
// in the warpgroup), its acc in the same slot of its warpgroup's array.
//
// The strict-upper-triangular ones of K = 256, in 64-column tiles, are the
// tile's own 8 diagonal k8 blocks (8 x 64 each, kept in shared memory), the
// all-zero blocks below the diagonal (skipped), and all-ones blocks above it,
// whose product is the row sums of the earlier tiles: a running m64n8k8
// product against ones (r), which starts the next tile's accumulator.  So a
// chunk is 32 n64 and 24 n8 products, all on the tensor cores.
template <bool HS>
__global__ void __launch_bounds__(LOG_WG * WG_THREADS, 1) log_tri_kernel(
    const float* __restrict__ s_in, const float* __restrict__ chain,
    float* __restrict__ partial, int n_chunk, int n_range) {
  extern __shared__ __align__(128) float sh_log[];
  float* sh_s = sh_log;                              // [LOG_EL][128]
  float* sh_acc = sh_s + LOG_EL * WG_THREADS;        // [LOG_WG][LOG_EL][128]
  float* sh_b = sh_acc + LOG_WG * LOG_EL * WG_THREADS;  // [KB_TILE][B_BLOCK], then ones
  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * LOG_ROWS + 16 * (tid >> 5) + g;  // and row0 + 8
  const int j = blockIdx.y;
  const int c0 = range_start(j, n_range, n_chunk), c1 = range_start(j + 1, n_range, n_chunk);
  const int b0 = c0 + wg * (c1 - c0) / LOG_WG, b1 = c0 + (wg + 1) * (c1 - c0) / LOG_WG;
  float* my_acc = sh_acc + wg * LOG_EL * WG_THREADS;

  for (int e = 0; e < LOG_EL; ++e) {
    const int kb = e >> 2, v = e & 3;
    if (wg == 0) sh_s[e * WG_THREADS + tid] = s_in[(row0 + 8 * (v & 1)) * K + 8 * kb + t + 4 * (v >> 1)];
    my_acc[e * WG_THREADS + tid] = 0.0f;
  }
  // Diagonal block dd at element (k, n): core matrix (n / 8, k / 4) of 8
  // rows x 4; 1 where the global row 8 dd + k lies before the column.
  for (int idx = threadIdx.x; idx < KB_TILE * B_BLOCK + ONES_BLOCK; idx += LOG_WG * WG_THREADS) {
    const int dd = idx / B_BLOCK, o = idx % B_BLOCK;
    const int core = o >> 5, within = o & 31;
    const int n = (core >> 1) * 8 + (within >> 2);
    const int k = (core & 1) * 4 + (within & 3);
    const int col = (n & ~7) + logical_col(n & 7);
    sh_b[idx] = (dd == KB_TILE || 8 * dd + k < col) ? 1.0f : 0.0f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // B is read by wgmma
  __syncthreads();
  const uint64_t desc_diag = smem_desc(sh_b);
  const uint64_t desc_ones = smem_desc(sh_b + KB_TILE * B_BLOCK);
  constexpr uint64_t DESC_STEP = B_BLOCK * sizeof(float) / 16;  // one block, in 16-byte units

  for (int i = b0; i < b1; ++i) {
    const float f0 = chain[(size_t)i * P + row0] * FEEDBACK;
    const float f1 = chain[(size_t)i * P + row0 + 8] * FEEDBACK;
    float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // row sums of log1p(-alpha) over the earlier tiles
#pragma unroll
    for (int q = 0; q < N_TILES; ++q) {
      // alpha and the A fragments of log1p(-alpha) for the tile's columns.
      float alpha[4 * KB_TILE];
      uint32_t hi[KB_TILE][4], lo[KB_TILE][4];
#pragma unroll
      for (int kk = 0; kk < KB_TILE; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = 4 * (KB_TILE * q + kk) + v;
          const float a = alpha_at(sh_s[e * WG_THREADS + tid], (v & 1) ? f1 : f0);
          alpha[4 * kk + v] = a;
          const float l = log1pf(-a);
          hi[kk][v] = to_tf32(l);
          lo[kk][v] = HS ? to_tf32(l - __uint_as_float(hi[kk][v])) : 0u;
        }
      }
      // Accumulator pair (v >> 1) of row half (v & 1) in n8 block kk; it
      // starts at the row's sum over the earlier tiles.
      float d[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) d[x] = r[(x & 2)];
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_operand(d[x]);
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_operand(r[x]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB_TILE; ++kk) {
        wgmma_n64(d, hi[kk], desc_diag + (uint64_t)kk * DESC_STEP);
        if (HS) wgmma_n64(d, lo[kk], desc_diag + (uint64_t)kk * DESC_STEP);
      }
      if (q + 1 < N_TILES) {
#pragma unroll
        for (int kk = 0; kk < KB_TILE; ++kk) {
          wgmma_n8(r, hi[kk], desc_ones);
          if (HS) wgmma_n8(r, lo[kk], desc_ones);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_operand(d[x]);
#pragma unroll
      for (int x = 0; x < 4; ++x) fence_operand(r[x]);
#pragma unroll
      for (int kk = 0; kk < KB_TILE; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          fence_operand(hi[kk][v]);
          if (HS) fence_operand(lo[kk][v]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KB_TILE; ++kk) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int e = 4 * (KB_TILE * q + kk) + v;
          my_acc[e * WG_THREADS + tid] += alpha[4 * kk + v] * expf(d[4 * kk + (v >> 1) + 2 * (v & 1)]);
        }
      }
    }
  }
  __syncthreads();
  // The warpgroups' sums added in order: one partial a block.
  for (int idx = threadIdx.x; idx < LOG_EL * WG_THREADS; idx += LOG_WG * WG_THREADS) {
    const int e = idx / WG_THREADS, ti = idx % WG_THREADS;
    const int kb = e >> 2, v = e & 3, ln = ti & 31;
    const int row = blockIdx.x * LOG_ROWS + 16 * (ti >> 5) + (ln >> 2) + 8 * (v & 1);
    float sum = sh_acc[idx];
#pragma unroll
    for (int w2 = 1; w2 < LOG_WG; ++w2) sum += sh_acc[w2 * LOG_EL * WG_THREADS + idx];
    partial[(size_t)j * P * K + row * K + 8 * kb + (ln & 3) + 4 * (v >> 1)] = sum;
  }
}

// ---------------------------------------------------------------------------
// 3. The partials added in range order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) sum_partials_kernel(const float* __restrict__ partial,
                                                           float* __restrict__ out, int n_range) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  float sum = partial[idx];
  for (int j = 1; j < n_range; ++j) sum += partial[(size_t)j * P * K + idx];
  out[idx] = sum;
}

int launch_chain(int variant, const float* s, float* chain, int n_chunk, cudaStream_t st) {
  if (n_chunk == 0) return 0;
  if (variant == ROLL_SUB) chain_sub_kernel<<<1, 32, 0, st>>>(s, chain, n_chunk);
  else chain_rows_kernel<<<P / 32, 32, 0, st>>>(s, chain, n_chunk);
  return (int)cudaGetLastError();
}

// Chunk ranges (and partials) of a call: one range a chunk up to
// MAX_RANGES, and one (empty) range for no chunk.
int ranges_of(int n_chunk) { return n_chunk < 1 ? 1 : (n_chunk < MAX_RANGES ? n_chunk : MAX_RANGES); }

// The work launch's grid: (row or column tiles, chunk ranges).
dim3 work_grid(int variant, int n_range) {
  switch (variant) {
    case EXP_ONLY:
    case ROLL_LANE: return dim3(P / ROW_WARPS, n_range);
    case ROLL_SUB: return dim3(K / (SUB_WARPS * SUB_COLS), n_range);
    case SEQ_MARCH: return dim3(P / SEQ_ROWS, n_range);
    default: return dim3(P / LOG_ROWS, n_range);  // LOG_TRI, LOG_TRI_HS
  }
}

int launch_work(int variant, const float* s, const float* chain, float* partial, int n_chunk,
                int n_range, cudaStream_t st) {
  const dim3 grid = work_grid(variant, n_range);
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case EXP_ONLY:
      row_warp_kernel<EXP_ONLY><<<grid, ROW_WARPS * 32, 0, st>>>(s, chain, partial, n_chunk,
                                                                  n_range);
      break;
    case ROLL_LANE:
      row_warp_kernel<ROLL_LANE><<<grid, ROW_WARPS * 32, 0, st>>>(s, chain, partial, n_chunk,
                                                                   n_range);
      break;
    case ROLL_SUB:
      roll_sub_kernel<<<grid, SUB_WARPS * 32, 0, st>>>(s, chain, partial, n_chunk, n_range);
      break;
    case SEQ_MARCH:
      err = cudaFuncSetAttribute(seq_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SEQ_SMEM);
      if (err != cudaSuccess) return (int)err;
      seq_march_kernel<<<grid, SEQ_WARPS * 32, SEQ_SMEM, st>>>(s, chain, partial, n_chunk,
                                                              n_range);
      break;
    case LOG_TRI:
      err = cudaFuncSetAttribute(log_tri_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, LOG_SMEM);
      if (err != cudaSuccess) return (int)err;
      log_tri_kernel<false><<<grid, LOG_WG * WG_THREADS, LOG_SMEM, st>>>(s, chain, partial,
                                                                         n_chunk, n_range);
      break;
    case LOG_TRI_HS:
      err = cudaFuncSetAttribute(log_tri_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, LOG_SMEM);
      if (err != cudaSuccess) return (int)err;
      log_tri_kernel<true><<<grid, LOG_WG * WG_THREADS, LOG_SMEM, st>>>(s, chain, partial,
                                                                        n_chunk, n_range);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool valid(int variant, int n_chunk) {
  return variant >= EXP_ONLY && variant <= SEQ_MARCH && n_chunk >= 0;
}

}  // namespace

// The whole function: chain, work and sum.  s and out are (256, 256) fp32,
// chain (n_chunk, 256) and partial (n_range, 256, 256) fp32 scratch, all
// contiguous; 1 <= n_range <= ranges_of(n_chunk).  Returns a
// cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for an unknown
// variant or a bad count.
extern "C" int scan_variants_launch(int variant, const void* s, void* out, void* chain,
                                    void* partial, int n_chunk, int n_range, void* stream) {
  if (!valid(variant, n_chunk) || n_range < 1 || n_range > ranges_of(n_chunk))
    return (int)cudaErrorInvalidValue;
  const auto* in = static_cast<const float*>(s);
  auto* ch = static_cast<float*>(chain);
  auto* part = static_cast<float*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  int err = launch_chain(variant, in, ch, n_chunk, st);
  if (err != 0) return err;
  err = launch_work(variant, in, ch, part, n_chunk, n_range, st);
  if (err != 0) return err;
  sum_partials_kernel<<<P * K / 256, 256, 0, st>>>(part, static_cast<float*>(out), n_range);
  return (int)cudaGetLastError();
}

// The chain launch alone (the measured floor): chain (n_chunk, 256) fp32.
extern "C" int scan_variants_chain(int variant, const void* s, void* chain, int n_chunk,
                                   void* stream) {
  if (!valid(variant, n_chunk)) return (int)cudaErrorInvalidValue;
  return launch_chain(variant, static_cast<const float*>(s), static_cast<float*>(chain), n_chunk,
                      static_cast<cudaStream_t>(stream));
}

// Thread blocks of the variant's work launch at n_chunk chunks (with
// ranges_of(n_chunk) ranges, as the wrapper launches it); -1 for an unknown
// variant or a bad count.
extern "C" int scan_variants_grid(int variant, int n_chunk) {
  if (!valid(variant, n_chunk)) return -1;
  const dim3 grid = work_grid(variant, ranges_of(n_chunk));
  return (int)(grid.x * grid.y);
}
