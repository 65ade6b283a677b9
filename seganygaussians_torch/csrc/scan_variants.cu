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
// the question the tool asks before anyone redesigns the blend kernels: which
// way of taking a cumulative product along the instance axis is fastest on
// this card.  Each variant computes the TPU variant's function with its own
// way of making threads cooperate:
//
//   exp_only    no scan, acc += alpha (the floor).
//   log_tri     exp(log1p(-alpha) @ strict-upper-triangular ones) with the
//               product on the tensor cores in TF32 (wmma m16n16k8, fp32
//               accumulate).  A block owns 16 rows; only three kinds of
//               8 x 16 triangular tile exist (all ones, and the two that
//               straddle the diagonal), so the matrix is never stored.
//   log_tri_hs  the same product as IEEE fp32 multiply-adds on the CUDA
//               cores: thread k sums log1p(-alpha_j) * [j < k] over the row
//               held in shared memory.
//   roll_lane   product scan along K: Hillis-Steele with __shfl_up_sync
//               inside each warp, the carry across the row's 8 warps through
//               shared memory.
//   roll_sub    the same scan along axis 0 (down the rows): eight
//               stride-doubling passes through shared memory.  The feedback
//               acc[:, 0] couples all rows, so each block owns a strip of 8
//               columns and also carries column 0 for itself.
//   seq_march   one thread per row marching K in order, the inner loop of
//               csrc/blend_fwd.cu; it computes roll_lane's function.
//
// What bounds it.  The block and the feedback column stay in registers and
// shared memory for all n_chunk iterations; device memory is touched once at
// each end (256 KB in, 256 KB out), so the bound is operations: per chunk one
// expf, the scan's one multiply and the accumulate for each of the 65,536
// elements, the same for every variant, at the whole card's rate.  The
// feedback through acc[:, 0] chains the chunks, and that chain's latency is a
// second floor (an estimate: tools/bench_scan_variants.py:latency_floor_us).
// A (256, 256) block cannot fill 132 SMs with much work each: the row
// variants use 256 blocks of one row, roll_sub 32 blocks, log_tri 16 and
// seq_march 8, and what a variant loses by leaving SMs empty is the kernel's
// loss, not a lower bound.
//
// Numerics.  IEEE fp32, expf and log1pf (not the fast intrinsics); built with
// --fmad=false like the blend kernels.  log_tri rounds log1p(-alpha) to TF32
// (round to nearest, ties away) before the product; everything else is fp32.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int P = 256;  // rows
constexpr int K = 256;  // columns
constexpr float ALPHA_MAX = 0.99f;
constexpr float FEEDBACK = 1e-6f;

enum Variant { EXP_ONLY = 0, LOG_TRI = 1, LOG_TRI_HS = 2, ROLL_LANE = 3, ROLL_SUB = 4, SEQ_MARCH = 5 };

__device__ __forceinline__ float alpha_of(float s, float acc0) {
  return fminf(ALPHA_MAX, expf(s + acc0 * FEEDBACK));
}

// ---------------------------------------------------------------------------
// One block per row, one thread per column: exp_only, roll_lane, log_tri_hs.
// Column 0's T_before is 1 in every variant, so thread 0 knows the next
// chunk's feedback before the scan and publishes it through a double buffer:
// one __syncthreads per chunk.
// ---------------------------------------------------------------------------
template <int V>
__global__ void __launch_bounds__(K) row_kernel(const float* __restrict__ s_in,
                                                float* __restrict__ out, int n_chunk) {
  __shared__ float sh_acc0[2];
  __shared__ float sh_tot[2][K / 32];
  __shared__ float sh_log[2][K];
  const int r = blockIdx.x, k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const float s = s_in[r * K + k];
  float acc = 0.0f;
  if (k == 0) sh_acc0[0] = 0.0f;
  __syncthreads();
  for (int i = 0; i < n_chunk; ++i) {
    const int b = i & 1;
    const float alpha = alpha_of(s, sh_acc0[b]);
    if (k == 0) sh_acc0[b ^ 1] = acc + alpha;
    if (V == EXP_ONLY) {
      acc += alpha;
      __syncthreads();
    } else if (V == ROLL_LANE) {
      float x = 1.0f - alpha;
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x, sh);
        if (lane >= sh) x *= y;
      }
      if (lane == 31) sh_tot[b][warp] = x;
      __syncthreads();
      float carry = 1.0f;
      for (int w = 0; w < warp; ++w) carry *= sh_tot[b][w];
      const float incl = x * carry;
      float t_before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) t_before = carry;
      acc += alpha * t_before;
    } else {  // LOG_TRI_HS
      sh_log[b][k] = log1pf(-alpha);
      __syncthreads();
      float cum = 0.0f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) cum += sh_log[b][j] * (j < k ? 1.0f : 0.0f);
      acc += alpha * expf(cum);
    }
  }
  out[r * K + k] = acc;
}

// ---------------------------------------------------------------------------
// log_tri: 16 rows per block, the triangular product on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int TRI_ROWS = 16;
constexpr int TRI_LD = K + 8;  // padded leading dimension (floats)

__global__ void __launch_bounds__(256) log_tri_kernel(const float* __restrict__ s_in,
                                                      float* __restrict__ out, int n_chunk) {
  using namespace nvcuda;
  __shared__ __align__(32) float sh_a[TRI_ROWS * TRI_LD];  // log1p(-alpha)
  __shared__ __align__(32) float sh_c[TRI_ROWS * TRI_LD];  // exclusive sums
  __shared__ __align__(32) float sh_tri[3][8 * 16];        // ones, diagonal 0, diagonal 1
  __shared__ float sh_acc0[2][TRI_ROWS];
  const int t = threadIdx.x, warp = t >> 5;
  const int row = t >> 4;          // 0..15
  const int col0 = (t & 15) * 16;  // 16 consecutive columns
  const int r_glob = blockIdx.x * TRI_ROWS + row;

  if (t < 128) {
    const int jj = t >> 4, kk = t & 15;
    sh_tri[0][t] = 1.0f;
    sh_tri[1][t] = jj < kk ? 1.0f : 0.0f;
    sh_tri[2][t] = 8 + jj < kk ? 1.0f : 0.0f;
  }
  if (t < TRI_ROWS) sh_acc0[0][t] = 0.0f;
  float s[16], acc[16], alpha[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    s[e] = s_in[r_glob * K + col0 + e];
    acc[e] = 0.0f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> tri[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    wmma::load_matrix_sync(tri[q], sh_tri[q], 16);
#pragma unroll
    for (int e = 0; e < tri[q].num_elements; ++e) tri[q].x[e] = wmma::__float_to_tf32(tri[q].x[e]);
  }

  for (int i = 0; i < n_chunk; ++i) {
    const int b = i & 1;
    const float a0 = sh_acc0[b][row];
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      alpha[e] = alpha_of(s[e], a0);
      sh_a[row * TRI_LD + col0 + e] = log1pf(-alpha[e]);
    }
    if (col0 == 0) sh_acc0[b ^ 1][row] = acc[0] + alpha[0];
    __syncthreads();
    // Warp w owns column blocks w and 15 - w (2w + 2 and 32 - 2w depth steps).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kb = half == 0 ? warp : 15 - warp;
      wmma::fragment<wmma::accumulator, 16, 16, 8, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int jb = 0; jb <= 2 * kb + 1; ++jb) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> a;
        wmma::load_matrix_sync(a, sh_a + jb * 8, TRI_LD);
#pragma unroll
        for (int e = 0; e < a.num_elements; ++e) a.x[e] = wmma::__float_to_tf32(a.x[e]);
        const int kind = jb < 2 * kb ? 0 : (jb == 2 * kb ? 1 : 2);
        if (kind == 0) wmma::mma_sync(c, a, tri[0], c);
        else if (kind == 1) wmma::mma_sync(c, a, tri[1], c);
        else wmma::mma_sync(c, a, tri[2], c);
      }
      wmma::store_matrix_sync(sh_c + kb * 16, c, TRI_LD, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += alpha[e] * expf(sh_c[row * TRI_LD + col0 + e]);
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) out[r_glob * K + col0 + e] = acc[e];
}

// ---------------------------------------------------------------------------
// roll_sub: scan down the rows.  One thread per row; a block owns SUB_W
// columns plus its own copy of column 0 (slot SUB_W), whose acc is the
// feedback of every row.
// ---------------------------------------------------------------------------
constexpr int SUB_W = 8;
constexpr int SUB_LD = SUB_W + 1;  // odd: rows r and r - sh fall in distinct banks

__global__ void __launch_bounds__(P) roll_sub_kernel(const float* __restrict__ s_in,
                                                     float* __restrict__ out, int n_chunk) {
  __shared__ float sh_x[2][P * SUB_LD];
  const int r = threadIdx.x;
  const int c0 = blockIdx.x * SUB_W;
  float s[SUB_LD], acc[SUB_LD], alpha[SUB_LD], x[SUB_LD];
#pragma unroll
  for (int e = 0; e < SUB_W; ++e) s[e] = s_in[r * K + c0 + e];
  s[SUB_W] = s_in[r * K];
#pragma unroll
  for (int e = 0; e < SUB_LD; ++e) acc[e] = 0.0f;
  int buf = 0;
  for (int i = 0; i < n_chunk; ++i) {
    const float a0 = acc[SUB_W];
#pragma unroll
    for (int e = 0; e < SUB_LD; ++e) {
      alpha[e] = alpha_of(s[e], a0);
      x[e] = 1.0f - alpha[e];
    }
    for (int sh = 1; sh < P; sh <<= 1) {
#pragma unroll
      for (int e = 0; e < SUB_LD; ++e) sh_x[buf][r * SUB_LD + e] = x[e];
      __syncthreads();
      if (r >= sh) {
#pragma unroll
        for (int e = 0; e < SUB_LD; ++e) x[e] *= sh_x[buf][(r - sh) * SUB_LD + e];
      }
      buf ^= 1;
    }
#pragma unroll
    for (int e = 0; e < SUB_LD; ++e) sh_x[buf][r * SUB_LD + e] = x[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < SUB_LD; ++e) {
      const float t_before = r >= 1 ? sh_x[buf][(r - 1) * SUB_LD + e] : 1.0f;
      acc[e] += alpha[e] * t_before;
    }
    buf ^= 1;
  }
#pragma unroll
  for (int e = 0; e < SUB_W; ++e) out[r * K + c0 + e] = acc[e];
}

// ---------------------------------------------------------------------------
// seq_march: one thread per row, K steps in order; the row's s and acc live
// in (dynamic) shared memory, row stride K + 1 so that a warp's 32 rows fall
// in distinct banks.
// ---------------------------------------------------------------------------
constexpr int SEQ_ROWS = 32;
constexpr int SEQ_LD = K + 1;
constexpr int SEQ_SMEM = 2 * SEQ_ROWS * SEQ_LD * (int)sizeof(float);

__global__ void __launch_bounds__(SEQ_ROWS) seq_march_kernel(const float* __restrict__ s_in,
                                                             float* __restrict__ out,
                                                             int n_chunk) {
  extern __shared__ float sh_seq[];
  float* sh_s = sh_seq;
  float* sh_acc = sh_seq + SEQ_ROWS * SEQ_LD;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * SEQ_ROWS;
  // Coalesced load: the warp reads one row at a time.
  for (int rr = 0; rr < SEQ_ROWS; ++rr) {
    for (int k = t; k < K; k += SEQ_ROWS) {
      sh_s[rr * SEQ_LD + k] = s_in[(r0 + rr) * K + k];
      sh_acc[rr * SEQ_LD + k] = 0.0f;
    }
  }
  __syncwarp();
  float* my_s = sh_s + t * SEQ_LD;
  float* my_acc = sh_acc + t * SEQ_LD;
  for (int i = 0; i < n_chunk; ++i) {
    const float a0 = my_acc[0];
    float T = 1.0f;
    for (int k = 0; k < K; ++k) {
      const float alpha = alpha_of(my_s[k], a0);
      my_acc[k] += alpha * T;
      T *= 1.0f - alpha;
    }
  }
  __syncwarp();
  for (int rr = 0; rr < SEQ_ROWS; ++rr) {
    for (int k = t; k < K; k += SEQ_ROWS) out[(r0 + rr) * K + k] = sh_acc[rr * SEQ_LD + k];
  }
}

}  // namespace

// Returns a cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for an
// unknown variant.  s and out are (256, 256) fp32, contiguous.
extern "C" int scan_variants_launch(int variant, const void* s, void* out, int n_chunk,
                                    void* stream) {
  const auto* in = static_cast<const float*>(s);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case EXP_ONLY: row_kernel<EXP_ONLY><<<P, K, 0, st>>>(in, o, n_chunk); break;
    case LOG_TRI: log_tri_kernel<<<P / TRI_ROWS, 256, 0, st>>>(in, o, n_chunk); break;
    case LOG_TRI_HS: row_kernel<LOG_TRI_HS><<<P, K, 0, st>>>(in, o, n_chunk); break;
    case ROLL_LANE: row_kernel<ROLL_LANE><<<P, K, 0, st>>>(in, o, n_chunk); break;
    case ROLL_SUB: roll_sub_kernel<<<K / SUB_W, P, 0, st>>>(in, o, n_chunk); break;
    case SEQ_MARCH: {
      cudaError_t err = cudaFuncSetAttribute(
          seq_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SEQ_SMEM);
      if (err != cudaSuccess) return (int)err;
      seq_march_kernel<<<P / SEQ_ROWS, SEQ_ROWS, SEQ_SMEM, st>>>(in, o, n_chunk);
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
