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
// Summed over a tile's pixels, an instance's row is two small products:
//   d_colors[c] = sum_p w_p g_p[c]
//   moments m = sum_p d_s,p [1, qx, qy, qx^2, qy^2, qx qy]   (q: the pixel's
//   coordinates inside its tile, 0..15, or 0..31 in a 32 x 32 tile)
// and with the mean taken relative to the tile's corner, dx = gx - qx, so
//   d_a = -1/2 (gx^2 m0 - 2 gx mx + mxx),  d_b = -(gx gy m0 - gx my - gy mx + mxy),
//   d_c = -1/2 (gy^2 m0 - 2 gy my + myy),  d_opacity = m0 / opacity,
//   d_x = -(a (gx m0 - mx) + b (gy m0 - my)),  d_y = -(c (gy m0 - my) + b (gx m0 - mx)),
// as the TPU kernel does on its matrix unit (blend_pallas.py:512-570).  The
// coordinates are tile-local because the expansion cancels: with absolute
// pixel coordinates (up to 1297) it would lose four digits of fp32.
//
// What bounds it on this card.  It reads the instance list (an int64 rank per
// instance, its table row), the forward's outputs and the incoming gradients
// (T x P x (2C + 2) floats) and writes N x (6 + C) floats; those bytes set
// its least time.  What held the first version (one thread per pixel, every
// instance's 6 + C values summed over the warp with 5 shuffles each and added
// to shared memory from lane 0) far above that was this sum over pixels:
// a build without it took 0.82 instead of 2.10 ms at C = 3 and 1.63 instead
// of 8.24 ms at C = 32 on a 3M-Gaussian 1297x840 frame (NVIDIA H100 80GB
// HBM3, 700 W limit); the gather alone took 0.08 / 0.20 ms.
//
// Design.  The skeleton of blend_common.cuh (one block per tile, or per
// 16 x 16 quadrant of a 32 x 32 tile, one thread per pixel, a warp on 8 x 4
// pixels, 64-row batches streamed by cp.async, one barrier a batch, each warp
// marching only the instances that can touch its pixels), and inside a batch
// each warp works alone on its 32 pixels, 8 marched instances (a sub-chunk)
// at a time:
//   1. the two-stage march of the forward, expression for expression (α of
//      four instances without a branch, then the chain through T), which
//      also gives each pixel's w and d_s (0 where not included), stored as
//      W[pixel][8] and DS[pixel][8] in the warp's corner of shared memory;
//   2. the two products over the warp's 32 pixels in fp32 FMAs: for the
//      colors every lane owns a 2 x 4 (instances x channels) block of the
//      8 x C outputs and reads W and the staged g (G[pixel][C]) with 8- and
//      16-byte loads; for the moments a lane owns 2 instances on one column
//      of the warp's pixels, and the 8 columns are summed with shuffles that
//      halve what a lane holds at each step (12 shuffles, not 36).  Skipped
//      when no pixel of the warp included any of the 8 instances;
//   3. the partial sums go into the block's (64, 6 + C) accumulator.  A
//      shared-memory atomicAdd of a float is a compare-and-swap loop on this
//      card and a lane's 2 to 8 of them in a row took as long as the product
//      itself, so shared_add keeps a lane's loads and swaps in flight
//      together.
// After the batch's barrier the block turns the moments into the six
// geometry entries and adds every nonzero entry to d_table with one global
// atomicAdd, while the warps already march the next batch (two accumulators,
// three row buffers).  Atomics, not a per-instance (M, 6 + C) buffer and an
// index_add_: the buffer would write and re-read M x (6 + C) floats (2.3 GB
// at C = 32 on a 3M-Gaussian frame) and index_add_ on the card uses atomics
// as well.  The order of the atomic adds changes from run to run, so the
// sums are not bitwise reproducible.  The four blocks of a 32 x 32 tile each
// add their quadrant's share of an instance's row the same way.
//
// Channel counts.  Instances for C = 3, 4, 5, 8, 16, 24 and 32, as in
// blend_fwd.cu; ops/blend_cuda.py pads any other C <= 32 with zero columns
// (their gradient rows are zero and are cut off again there).
//
// Numerics.  The march is the forward's (expf, --fmad=false, kept only on
// power <= 0, so a NaN power is skipped), so both include the same
// instances.  The products use fmaf; no tensor cores: TF32 inputs lose the
// gradient (blend_pallas.py:164-170).

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int SUB = 8;        // instances a warp marches between two products
constexpr int KS = SUB + 4;   // floats per pixel in W and DS: 16-byte stores without bank conflicts
static_assert(SUB % GROUP == 0 && GROUP == 4, "a sub-chunk is whole groups of four");

// How a warp's 32 lanes split the SUB x CP outputs of a color product: CT
// lanes across the channels (TC each), KT across the instances (TK each).
template <int CP>
struct Split {
  static constexpr int CT = CP < 8 ? CP : 8;
  static constexpr int TC = CP / CT;
  static constexpr int KT = 32 / CT;
  static constexpr int TK = SUB / KT;
  static_assert(TC * CT == CP && TK * KT == SUB && TK >= 1, "lanes do not tile the outputs");
};

template <int N>
__device__ __forceinline__ void load_floats(float* dst, const float* src) {
  static_assert(N >= 1 && N <= 4, "1 to 4 floats");
  if constexpr (N == 1 || N == 3) {  // 3: 12-byte steps, no wider load is aligned
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// addr[i] += v[i] in shared memory for the nonzero v[i], all N in flight
// together.  atomicAdd on a shared float compiles to a loop of load, add and
// compare-and-swap, and N of them in a row wait for each other; here the N
// loads, then the N swaps, go out back to back, and only a swap that lost
// a race against another warp falls back to atomicAdd.
template <int N>
__device__ __forceinline__ void shared_add(float* const* addr, const float* v) {
  unsigned old[N], got[N];
#pragma unroll
  for (int i = 0; i < N; ++i) old[i] = *reinterpret_cast<volatile unsigned*>(addr[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    got[i] = old[i];
    if (v[i] != 0.0f)
      got[i] = atomicCAS(reinterpret_cast<unsigned*>(addr[i]), old[i],
                         __float_as_uint(__uint_as_float(old[i]) + v[i]));
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (got[i] != old[i]) atomicAdd(addr[i], v[i]);
}

template <int C>
struct BwdSmem {
  using Pipe = Pipeline<C, 3>;
  static constexpr int F = 6 + C;
  static constexpr int CP = (C + 3) / 4 * 4;                   // channels of a staged g row
  static constexpr int ACC_FLOATS = (BATCH * F + 3) / 4 * 4;   // one accumulator
  static constexpr size_t ACC_OFFSET = Pipe::RING_BYTES + Pipe::ROWS_BYTES;
  static constexpr size_t G_OFFSET = ACC_OFFSET + 2 * ACC_FLOATS * sizeof(float);
  static __host__ __device__ size_t wd_offset(int P) { return G_OFFSET + size_t(P) * CP * sizeof(float); }
  static __host__ __device__ size_t bytes(int P) { return wd_offset(P) + size_t(P) * 2 * KS * sizeof(float); }
};

// acc[row of slot k][6 + c] += sum over the warp's 32 pixels of
// W[pixel][k] G[pixel][c], k < SUB, c < C.  ``wt`` is the warp's W, ``gw`` its
// pixels' rows of G, lane s < SUB holds slot s's row of the batch.
template <int C>
__device__ __forceinline__ void color_product(const float* wt, const float* gw, float* acc,
                                              int slot_row, int lane) {
  constexpr int CP = BwdSmem<C>::CP;
  constexpr int F = 6 + C;
  using S = Split<CP>;
  const int ct = lane % S::CT;
  const int kt = lane / S::CT;
  float o[S::TK][S::TC];
#pragma unroll
  for (int i = 0; i < S::TK; ++i)
#pragma unroll
    for (int j = 0; j < S::TC; ++j) o[i][j] = 0.0f;
#pragma unroll 8
  for (int q = 0; q < 32; ++q) {
    float w[S::TK], e[S::TC];
    load_floats<S::TK>(w, wt + q * KS + S::TK * kt);
    load_floats<S::TC>(e, gw + q * CP + S::TC * ct);
#pragma unroll
    for (int i = 0; i < S::TK; ++i)
#pragma unroll
      for (int j = 0; j < S::TC; ++j) o[i][j] = fmaf(w[i], e[j], o[i][j]);
  }
  float* addr[S::TK * S::TC];
  float v[S::TK * S::TC];
#pragma unroll
  for (int i = 0; i < S::TK; ++i) {
    const int row = __shfl_sync(FULL_MASK, slot_row, S::TK * kt + i);
#pragma unroll
    for (int j = 0; j < S::TC; ++j) {
      const int col = S::TC * ct + j;
      addr[i * S::TC + j] = acc + row * F + 6 + min(col, C - 1);
      v[i * S::TC + j] = col < C ? o[i][j] : 0.0f;  // padding channels own no entry
    }
  }
  shared_add<S::TK * S::TC>(addr, v);
}

// acc[row of slot k][0..5] += sum over the warp's 32 pixels of DS[pixel][k]
// times [1, qx, qy, qx^2, qy^2, qx qy].  A lane owns slots 2 kt, 2 kt + 1 on
// the warp's threads pg, pg + 8, pg + 16, pg + 24: column pg of the warp's
// 8 x 4 pixel block (pixel_of), so qx is one value and qy counts up from the
// block's first row.  (block_x0, block_y0): the block's corner in its tile.
template <int F>
__device__ __forceinline__ void moment_product(const float* dst, float* acc, int slot_row,
                                               int lane, float block_x0, float block_y0) {
  const int kt = lane & 3;
  const int pg = lane >> 2;
  const float qx = block_x0 + (float)pg;
  float s[2][3];  // per slot: sum of d, of d qy, of d qy^2
#pragma unroll
  for (int r = 0; r < 3; ++r) s[0][r] = s[1][r] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float qy = block_y0 + (float)i;
    const float2 d = *reinterpret_cast<const float2*>(dst + (pg + 8 * i) * KS + 2 * kt);
    s[0][0] += d.x;
    s[1][0] += d.y;
    s[0][1] = fmaf(d.x, qy, s[0][1]);
    s[1][1] = fmaf(d.y, qy, s[1][1]);
    s[0][2] = fmaf(d.x, qy * qy, s[0][2]);
    s[1][2] = fmaf(d.y, qy * qy, s[1][2]);
  }
  float m[2][6];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    m[a][0] = s[a][0];
    m[a][1] = qx * s[a][0];
    m[a][2] = s[a][1];
    m[a][3] = qx * qx * s[a][0];
    m[a][4] = s[a][2];
    m[a][5] = qx * s[a][1];
  }
  // Sum over the 8 pixel groups (lane bits 2, 3, 4), halving what a lane
  // holds at each step: one instance's 6 moments, then 3 of them; the last
  // step sums those 3 on both lanes, which then share the adds.
  const bool b2 = lane & 4, b3 = lane & 8, b4 = lane & 16;
  float h6[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float keep = b2 ? m[1][r] : m[0][r];
    const float send = b2 ? m[0][r] : m[1][r];
    h6[r] = keep + __shfl_xor_sync(FULL_MASK, send, 4);
  }
  float h3[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float keep = b3 ? h6[3 + r] : h6[r];
    const float send = b3 ? h6[r] : h6[3 + r];
    h3[r] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) h3[r] += __shfl_xor_sync(FULL_MASK, h3[r], 16);
  const int row = __shfl_sync(FULL_MASK, slot_row, 2 * kt + (b2 ? 1 : 0));
  float* const first = acc + row * F + (b3 ? 3 : 0);
  float* const addr[2] = {first + (b4 ? 2 : 0), first + 1};
  const float v[2] = {b4 ? h3[2] : h3[0], b4 ? 0.0f : h3[1]};
  shared_add<2>(addr, v);
}

template <int C, bool QUAD>
__global__ void __launch_bounds__(MAX_THREADS, C > 8 ? 2 : 3) blend_bwd_kernel(
    const int64_t* __restrict__ gauss_s,   // (M,) depth rank per sorted instance
    const int* __restrict__ tile_starts,   // (T + 1,)
    const float* __restrict__ table,       // (N, 6 + C) depth-ranked rows
    const float* __restrict__ bg,          // (C,)
    const float* __restrict__ g_tiles,     // (T, P, C) dL/d tiles
    const float* __restrict__ g_final_t,   // (T, P) dL/d final_t
    const float* __restrict__ tiles,       // (T, P, C) forward output
    const float* __restrict__ final_t,     // (T, P) forward output
    float* __restrict__ d_table,           // (N, 6 + C), zeroed by the caller
    int grid_x, int tile_size) {
  using R = Row<C>;
  using M = BwdSmem<C>;
  using Pipe = typename M::Pipe;
  constexpr int F = M::F;
  constexpr int CP = M::CP;
  extern __shared__ __align__(16) unsigned char smem[];

  const Region reg = region_of<QUAD>(blockIdx.x, grid_x, tile_size);
  const int t = reg.tile;
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  if (end <= start) return;  // the whole block: an empty tile has no gradient

  const int p = threadIdx.x;
  const int P = blockDim.x;  // pixels of the block's square
  const int lane = p & 31;
  const int warp = p >> 5;

  float* acc = reinterpret_cast<float*>(smem + M::ACC_OFFSET);   // two of (BATCH, F)
  float* gs = reinterpret_cast<float*>(smem + M::G_OFFSET);      // (P, CP)
  float* wt = reinterpret_cast<float*>(smem + M::wd_offset(P)) + warp * (2 * 32 * KS);
  float* dst = wt + 32 * KS;                                     // the warp's W, then its DS
  const Pipe pipe{reinterpret_cast<int64_t*>(smem),
                  reinterpret_cast<float*>(smem + Pipe::RING_BYTES),
                  gauss_s, table, start, end};

  const float tile_x0 = reg.tile_x0;
  const float tile_y0 = reg.tile_y0;
  const int pixel = pixel_of(p, reg.side);
  // The square's corner in the image.
  const float x0 = QUAD ? tile_x0 + (float)reg.qx0 : tile_x0;
  const float y0 = QUAD ? tile_y0 + (float)reg.qy0 : tile_y0;
  const float px = x0 + (float)(pixel % reg.side);
  const float py = y0 + (float)(pixel / reg.side);
  const Box box = warp_box(p, reg.side, x0, y0);

  const size_t pix = (size_t)t * (QUAD ? 4 * P : P) + tile_pixel<QUAD>(reg, pixel, tile_size);
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

#pragma unroll
  for (int k = 0; k < CP; ++k) gs[p * CP + k] = k < C ? g[k] : 0.0f;
  for (int k = p; k < 2 * M::ACC_FLOATS; k += P) acc[k] = 0.0f;
  pipe.start_up();  // its barriers also publish gs and the zeroed accumulators

  // Adds batch b's accumulator to d_table and zeroes it: 4 threads an
  // instance, the first also turns the moments into the geometry entries.
  auto flush = [&](int b) {
    const int nb = pipe.count(b);
    float* a0 = acc + (b & 1) * M::ACC_FLOATS;
    const int64_t* gid = pipe.gids(b);
    const float* rows = pipe.batch(b);
    for (int idx = p; idx < nb * 4; idx += P) {
      const int j = idx >> 2;
      const int part = idx & 3;
      float* a = a0 + j * F;
      // Padding ranks (= N) lie past tile_starts[T], in no tile's range.
      float* out = d_table + gid[j] * F;
      if (part == 0) {
        const float m0 = a[0], mx = a[1], my = a[2], mxx = a[3], myy = a[4], mxy = a[5];
        if (m0 != 0.0f || mx != 0.0f || my != 0.0f || mxx != 0.0f || myy != 0.0f ||
            mxy != 0.0f) {
#pragma unroll
          for (int r = 0; r < 6; ++r) a[r] = 0.0f;
          const float* row = rows + j * R::STRIDE;
          const float gx = row[0] - tile_x0;
          const float gy = row[1] - tile_y0;
          const float ca = row[2], cb = row[3], cc = row[4];
          const float ex = gx * m0 - mx;  // sum of d_s dx
          const float ey = gy * m0 - my;  // sum of d_s dy
          atomicAdd(out + 0, -(ca * ex + cb * ey));
          atomicAdd(out + 1, -(cc * ey + cb * ex));
          atomicAdd(out + 2, -0.5f * (gx * gx * m0 - 2.0f * gx * mx + mxx));
          atomicAdd(out + 3, -(gx * gy * m0 - gx * my - gy * mx + mxy));
          atomicAdd(out + 4, -0.5f * (gy * gy * m0 - 2.0f * gy * my + myy));
          atomicAdd(out + 5, m0 / fmaxf(row[5], 1e-12f));
        }
      }
      for (int c = part; c < C; c += 4) {
        const float v = a[6 + c];
        if (v != 0.0f) {
          a[6 + c] = 0.0f;
          atomicAdd(out + 6 + c, v);
        }
      }
    }
  };

  float T = 1.0f;
  float u_prefix = 0.0f;
  bool done = false;

  const int nbatch = pipe.batches();
  for (int b = 0; b < nbatch; ++b) {
    pipe.prefetch(b);
    if (b > 0) flush(b - 1);
    const float4* rows4 = reinterpret_cast<const float4*>(pipe.batch(b));
    float* acc_b = acc + (b & 1) * M::ACC_FLOATS;
    const int nb = pipe.count(b);
    // W and DS fill with the instances the warp marches, a group at a time;
    // lane s < SUB keeps the batch row of slot s.  A full sub-chunk, or what
    // is left when the batch ends, goes through the products.
    int filled = 0;
    int slot_row = 0;
    bool any = false;
    auto products = [&]() {
      if (__any_sync(FULL_MASK, any)) {  // the same for the whole warp
        __syncwarp();
        color_product<C>(wt, gs + warp * 32 * CP, acc_b, slot_row, lane);
        moment_product<F>(dst, acc_b, slot_row, lane, box.x0 - tile_x0, box.y0 - tile_y0);
        __syncwarp();
      }
      filled = 0;
      any = false;
    };
    bool warp_done = __all_sync(FULL_MASK, done);
    for (int first = 0; first < nb && !warp_done; first += 32) {
      unsigned todo = rows_to_march<C>(rows4, first, nb, lane, box);
      while (todo != 0) {
        warp_done = __all_sync(FULL_MASK, done);
        if (warp_done) break;  // the same for the whole warp
        int row[GROUP];
        float alpha[GROUP];
        next_group<C>(todo, first, rows4, px, py, row, alpha);
        // The chain through T and the prefix of u, in depth order.
        float w4[GROUP], ds4[GROUP];
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          const float a = alpha[i];
          float t_after;
          float w = 0.0f, ds = 0.0f;
          if (includes(a, T, done, t_after)) {
            const float4* r4 = rows4 + row[i] * (R::STRIDE / 4);
            w = a * T;
            float gc = 0.0f;
            for_each_color<C>(r4, [&](int k, float c) { gc = fmaf(g[k], c, gc); });
            u_prefix += gc * w;
            const float suffix = u_total - u_prefix;
            const float d_alpha = gc * T - (suffix + tail_const) / fmaxf(1.0f - a, 1e-6f);
            ds = a < ALPHA_MAX ? d_alpha * a : 0.0f;
            T = t_after;
            any = true;
          }
          w4[i] = w;
          ds4[i] = ds;
          if (lane == filled * GROUP + i) slot_row = max(row[i], 0);
        }
        *reinterpret_cast<float4*>(wt + lane * KS + filled * GROUP) =
            make_float4(w4[0], w4[1], w4[2], w4[3]);
        *reinterpret_cast<float4*>(dst + lane * KS + filled * GROUP) =
            make_float4(ds4[0], ds4[1], ds4[2], ds4[3]);
        if (++filled == SUB / GROUP) products();
      }
    }
    if (filled > 0) {  // the same for the whole warp
      for (int h = filled; h < SUB / GROUP; ++h) {
        *reinterpret_cast<float4*>(wt + lane * KS + h * GROUP) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dst + lane * KS + h * GROUP) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      products();
    }
    cp_async_wait_all();
    // Ends the batch: the next one's rows are visible, every warp's sums are
    // in this batch's accumulator, and the block leaves once every pixel has
    // saturated.
    const bool all_done = __syncthreads_count(done) == P;
    if (all_done || b + 1 == nbatch) {
      flush(b);
      break;
    }
  }
}

template <int C>
cudaError_t launch(const int64_t* gauss_s, const int* tile_starts,
                   const float* table, const float* bg, const float* g_tiles,
                   const float* g_final_t, const float* tiles,
                   const float* final_t, float* d_table, int num_tiles,
                   int grid_x, int tile_size, cudaStream_t stream) {
  const int side = block_side(tile_size);
  if (side == 0) return cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_size == 32 ? 4 : 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 8 != 0) return cudaErrorMisalignedAddress;
  const int P = side * side;  // threads a block
  const size_t bytes = BwdSmem<C>::bytes(P);
  auto kernel = tile_size == 32 ? blend_bwd_kernel<C, true> : blend_bwd_kernel<C, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, P, bytes, stream>>>(
      gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles, final_t,
      d_table, grid_x, tile_size);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for a
// channel count without an instance here or a tile that is not 8 x 8, 16 x 16
// or 32 x 32.
extern "C" int blend_bwd_launch(int channels, const void* gauss_s,
                                const void* tile_starts, const void* table,
                                const void* bg, const void* g_tiles,
                                const void* g_final_t, const void* tiles,
                                const void* final_t, void* d_table,
                                int num_tiles, int grid_x, int tile_size,
                                void* stream) {
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
    case 3: return launch<3>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 4: return launch<4>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 5: return launch<5>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 8: return launch<8>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 16: return launch<16>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 24: return launch<24>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    case 32: return launch<32>(gs, s, tb, b, gt, gf, o, ft, d, num_tiles, grid_x, tile_size, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
