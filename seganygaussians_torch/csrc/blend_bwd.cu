// Backward tile alpha-blend for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel seganygaussians_tpu/ops/blend_pallas.py:_bwd_kernel
// (launched by _bwd_call) together with the reduction after it,
// segment_reduce_by_rank.  For every instance in a tile's depth-sorted range
// [tile_starts[t], tile_starts[t+1]) it computes the gradient of the loss with
// respect to that instance's table row (mean x, mean y, conic a, b, c,
// opacity, colors[C]) and adds it into the row of the instance's depth rank
// in d_table (N, 6 + C).
//
// The math, per pixel, for an included instance i (the forward's march):
//   w_i = alpha_i T_i,  u_i = (g . c_i) w_i,  U_total = g . (out - T_end bg)
//   suffix S_i = sum_{j > i} u_j = U_total - (u_0 + ... + u_i)
//   dL/dalpha_i = (g . c_i) T_i - (S_i + (g . bg + g_T) T_end) / (1 - alpha_i)
//   no gradient through the 0.99 clamp; s = power + log(opacity), so
//   d_s = dL/dalpha_i alpha_i feeds the conic, mean and opacity rows.
// Coordinates are absolute pixel coordinates (pixel centers are integers).
//
// Design.  One thread block per tile, one thread per tile pixel.  The block
// walks its range in batches of BATCH instances gathered into shared memory,
// exactly as blend_fwd.cu does, and every pixel re-marches the batch front
// to back with the forward's arithmetic (same expression order, expf,
// --fmad=false), so it includes exactly the instances the forward included.
// Per instance, each warp sums its 32 pixels' partials with shuffles (only
// when some lane of the warp included the instance) and lane 0 adds them into
// a shared (BATCH, 6 + C) accumulator.  After the batch the block adds each
// nonzero accumulator entry into d_table with one global atomicAdd.  Atomics,
// not a per-instance (M, 6 + C) buffer and an index_add_: the buffer would
// write and re-read M x (6 + C) floats (2.3 GB at C = 32 on a 3M-Gaussian
// frame) and index_add_ on the card uses atomics as well.  The order of the
// atomic adds changes from run to run, so the sums are not bitwise
// reproducible.
//
// What bounds it on this card.  It reads the instance list (an int64 rank per
// instance, its table row), the forward's outputs and the incoming gradients
// (T x P x (2C + 2) floats) and writes N x (6 + C) floats.  Its work is the
// forward's per visited pair (~14 flops and one expf) plus, per included
// pair, ~3C + 29 flops for the gradient terms and 6 + C adds to sum them over
// the tile's pixels.  Its least time is set by those bytes; what holds it
// above that is the per-instance shuffles and atomics and the sequential
// march.  Making it fast (wgmma moments, a back-to-front march, fewer
// atomics) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

template <int C>
__global__ void blend_bwd_kernel(
    const int64_t* __restrict__ gauss_s,   // (M,) depth rank per sorted instance
    const int* __restrict__ tile_starts,   // (T + 1,)
    const float* __restrict__ table,       // (N, 6 + C) depth-ranked rows
    const float* __restrict__ bg,          // (C,)
    const float* __restrict__ g_tiles,     // (T, P, C) dL/d tiles
    const float* __restrict__ g_final_t,   // (T, P) dL/d final_t
    const float* __restrict__ tiles,       // (T, P, C) forward output
    const float* __restrict__ final_t,     // (T, P) forward output
    float* __restrict__ d_table,           // (N, 6 + C), zeroed by the caller
    long long n, int grid_x, int tile_size) {
  constexpr int F = 6 + C;
  // Shared memory holds the batch's rows and their gradient accumulators
  // (2 x BATCH x F floats): 128 instances keep C = 32 under 48 KB.
  constexpr int BATCH = C > 8 ? 128 : 256;
  __shared__ float s_rows[BATCH * F];
  __shared__ float s_grad[BATCH * F];
  __shared__ int64_t s_gid[BATCH];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];

  const float px = (float)((t % grid_x) * tile_size + p % tile_size);
  const float py = (float)((t / grid_x) * tile_size + p / tile_size);

  const size_t pix = (size_t)t * P + p;
  float g[C];
  float g_dot_bg = 0.0f;
  float g_dot_out = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    g[k] = g_tiles[pix * C + k];
    g_dot_bg += g[k] * bg[k];
    g_dot_out += g[k] * tiles[pix * C + k];
  }
  const float t_end = final_t[pix];
  const float u_total = g_dot_out - t_end * g_dot_bg;
  // The terms that multiply -1 / (1 - alpha_i): background and final_t.
  const float tail_const = (g_dot_bg + g_final_t[pix]) * t_end;

  for (int k = p; k < BATCH * F; k += P) s_grad[k] = 0.0f;

  float T = 1.0f;
  float u_prefix = 0.0f;
  int done = 0;

  for (int b0 = start; b0 < end; b0 += BATCH) {
    // Also the barrier that keeps this batch's loads behind the last flush.
    if (__syncthreads_count(done) == P) break;
    const int nb = min(BATCH, end - b0);
    for (int j = p; j < nb; j += P) s_gid[j] = gauss_s[b0 + j];
    __syncthreads();
    for (int k = p; k < nb * F; k += P) {
      const int j = k / F;
      const int f = k - j * F;
      s_rows[k] = table[s_gid[j] * F + f];
    }
    __syncthreads();

    for (int j = 0; j < nb; ++j) {
      if (__all_sync(FULL_MASK, done)) break;  // warp-uniform
      const float* row = s_rows + j * F;
      float dx = 0.0f, dy = 0.0f, ds = 0.0f, w = 0.0f;
      bool inc = false;
      if (!done) {
        dx = row[0] - px;
        dy = row[1] - py;
        const float power =
            -0.5f * (row[2] * dx * dx + row[4] * dy * dy) - row[3] * dx * dy;
        // The forward's skip test, NaN included: !(power > 0), not power <= 0.
        if (!(power > 0.0f)) {
          const float alpha = fminf(ALPHA_MAX, row[5] * expf(power));
          if (alpha >= ALPHA_MIN) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < T_EPS) {
              done = 1;
            } else {
              inc = true;
              w = alpha * T;
              float gc = 0.0f;
#pragma unroll
              for (int k = 0; k < C; ++k) gc += g[k] * row[6 + k];
              u_prefix += gc * w;
              const float suffix = u_total - u_prefix;
              const float d_alpha =
                  gc * T - (suffix + tail_const) / fmaxf(1.0f - alpha, 1e-6f);
              ds = alpha < ALPHA_MAX ? d_alpha * alpha : 0.0f;
              T = test_t;
            }
          }
        }
      }
      if (!__any_sync(FULL_MASK, inc)) continue;  // warp-uniform
      float* acc = s_grad + j * F;
      float v;
      v = warp_sum(-ds * (row[2] * dx + row[3] * dy));
      if (lane == 0) atomicAdd(acc + 0, v);
      v = warp_sum(-ds * (row[4] * dy + row[3] * dx));
      if (lane == 0) atomicAdd(acc + 1, v);
      v = warp_sum(-0.5f * ds * dx * dx);
      if (lane == 0) atomicAdd(acc + 2, v);
      v = warp_sum(-ds * dx * dy);
      if (lane == 0) atomicAdd(acc + 3, v);
      v = warp_sum(-0.5f * ds * dy * dy);
      if (lane == 0) atomicAdd(acc + 4, v);
      v = warp_sum(ds / fmaxf(row[5], 1e-12f));
      if (lane == 0) atomicAdd(acc + 5, v);
#pragma unroll
      for (int k = 0; k < C; ++k) {
        v = warp_sum(g[k] * w);
        if (lane == 0) atomicAdd(acc + 6 + k, v);
      }
    }
    __syncthreads();
    for (int k = p; k < nb * F; k += P) {
      const float v = s_grad[k];
      if (v != 0.0f) {
        const int j = k / F;
        const int64_t gid = s_gid[j];
        if (gid < n) atomicAdd(d_table + gid * F + (k - j * F), v);
      }
      s_grad[k] = 0.0f;
    }
  }
}

template <int C>
cudaError_t launch(const int64_t* gauss_s, const int* tile_starts,
                   const float* table, const float* bg, const float* g_tiles,
                   const float* g_final_t, const float* tiles,
                   const float* final_t, float* d_table, long long n,
                   int num_tiles, int grid_x, int tile_size,
                   cudaStream_t stream) {
  blend_bwd_kernel<C><<<num_tiles, tile_size * tile_size, 0, stream>>>(
      gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles, final_t,
      d_table, n, grid_x, tile_size);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for a
// channel count without an instance here.
extern "C" int blend_bwd_launch(int channels, const void* gauss_s,
                                const void* tile_starts, const void* table,
                                const void* bg, const void* g_tiles,
                                const void* g_final_t, const void* tiles,
                                const void* final_t, void* d_table,
                                long long n, int num_tiles, int grid_x,
                                int tile_size, void* stream) {
  if (num_tiles == 0) return 0;
  const auto* gs = static_cast<const int64_t*>(gauss_s);
  const auto* s = static_cast<const int*>(tile_starts);
  const auto* tb = static_cast<const float*>(table);
  const auto* b = static_cast<const float*>(bg);
  const auto* gt = static_cast<const float*>(g_tiles);
  const auto* gf = static_cast<const float*>(g_final_t);
  const auto* o = static_cast<const float*>(tiles);
  const auto* ft = static_cast<const float*>(final_t);
  auto* d = static_cast<float*>(d_table);
  auto st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 3: return launch<3>(gs, s, tb, b, gt, gf, o, ft, d, n, num_tiles, grid_x, tile_size, st);
    case 4: return launch<4>(gs, s, tb, b, gt, gf, o, ft, d, n, num_tiles, grid_x, tile_size, st);
    case 5: return launch<5>(gs, s, tb, b, gt, gf, o, ft, d, n, num_tiles, grid_x, tile_size, st);
    case 32: return launch<32>(gs, s, tb, b, gt, gf, o, ft, d, n, num_tiles, grid_x, tile_size, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
