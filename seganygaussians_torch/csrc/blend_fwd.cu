// Forward tile alpha-blend for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel seganygaussians_tpu/ops/blend_pallas.py:_fwd_kernel
// (launched by _fwd_call).  It computes what ops/blend.py computes: per tile,
// a front-to-back alpha composite over the tile's depth-sorted instance range
// [tile_starts[t], tile_starts[t+1]).
//
// What bounds it on this card.  It reads the instance list (one int64 depth
// rank per instance plus its (6 + C)-float table row, M x 8 + N x (6 + C) x 4
// bytes) and writes T x P x (C + 2) x 4 bytes; those bytes set its least
// time.  What held the first version (256-row batches gathered between two
// barriers, every pixel marching every instance one dependent step after the
// other) above that, measured on a 3M-Gaussian 1297x840 frame (NVIDIA H100
// 80GB HBM3, 700 W limit): the march.  Nearly half of such a frame's tiles
// are busy and walk some 410 instances each (the longest 2,463); the gather
// was a tenth of the time at C = 3, and the march took as long at C = 3 as at
// C = 32, so it was bound by the operations and the latency of a step, not
// by the color sums.  At C = 32 a second cost was each pixel writing its 32
// colors 128 bytes apart.
//
// Design.  The skeleton of blend_common.cuh: one block per tile (per 16 x 16
// quadrant of a 32 x 32 tile), one thread per pixel, a warp on a block of
// 8 x 4 pixels; batches of 64 rows streamed
// through shared memory by cp.async while the previous batch is marched, one
// barrier a batch; each warp marches only the instances that can touch its
// pixels (about half of a tile's), four at a time in two stages: their four
// α without a branch, then the chain through T, inclusion and the color sum.
// Pixels outside the image are computed too, so the (T, P, C) output matches
// ops/blend.py before cropping.  At C > 8 the colors go out through shared
// memory, so that a warp writes whole 128-byte lines: the block's pixels in
// one run, or at 32 x 32 one run per row of its quadrant.
//
// Channel counts.  Instances for C = 3, 4, 5 (RGB, RGB + depth, + mask) and
// for 8, 16, 24 and 32; ops/blend_cuda.py pads any other C <= 32 with zero
// color columns to the next of these, as blend_pallas.py pads C to a
// multiple of 8.
//
// Numerics.  IEEE fp32, expf (not __expf) and --fmad=false for α and T,
// because n_contrib is compared exactly and the 1/255 and 1e-4 thresholds sit
// on the exponential; the color sum alone uses fmaf.  Pixel centers are
// integer coordinates.

#include "blend_common.cuh"

namespace {

using namespace blend;

template <int C>
struct FwdSmem {
  using Pipe = Pipeline<C, 2>;
  static constexpr int STAGE_STRIDE = C + 1;  // odd: a warp's pixels hit 32 banks
  static size_t bytes(int P) {
    const size_t stream = Pipe::RING_BYTES + Pipe::ROWS_BYTES;
    const size_t stage = C > 8 ? size_t(P) * STAGE_STRIDE * sizeof(float) : 0;
    return stream > stage ? stream : stage;
  }
};

template <int C, bool QUAD>
__global__ void __launch_bounds__(MAX_THREADS) blend_fwd_kernel(
    const int64_t* __restrict__ gauss_s,   // (M,) depth rank per sorted instance
    const int* __restrict__ tile_starts,   // (T + 1,)
    const float* __restrict__ table,       // (N, 6 + C) depth-ranked rows
    const float* __restrict__ bg,          // (C,)
    float* __restrict__ tiles,             // (T, P, C)
    float* __restrict__ final_t,           // (T, P)
    int* __restrict__ n_contrib,           // (T, P)
    int grid_x, int tile_size) {
  using R = Row<C>;
  using Pipe = Pipeline<C, 2>;
  extern __shared__ __align__(16) unsigned char smem[];

  const Region reg = region_of<QUAD>(blockIdx.x, grid_x, tile_size);
  const int t = reg.tile;
  const int p = threadIdx.x;
  const int P = blockDim.x;  // pixels of the block's square
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];

  const int lane = p & 31;
  const int pixel = pixel_of(p, reg.side);
  // The square's corner in the image.
  const float x0 = QUAD ? reg.tile_x0 + (float)reg.qx0 : reg.tile_x0;
  const float y0 = QUAD ? reg.tile_y0 + (float)reg.qy0 : reg.tile_y0;
  const float px = x0 + (float)(pixel % reg.side);
  const float py = y0 + (float)(pixel / reg.side);
  const Box box = warp_box(p, reg.side, x0, y0);

  float T = 1.0f;
  int count = 0;
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.0f;
  bool done = false;

  if (end > start) {  // the same for the whole block
    const Pipe pipe{reinterpret_cast<int64_t*>(smem),
                    reinterpret_cast<float*>(smem + Pipe::RING_BYTES),
                    gauss_s, table, start, end};
    pipe.start_up();
    const int nbatch = pipe.batches();
    for (int b = 0; b < nbatch; ++b) {
      pipe.prefetch(b);
      const float4* rows4 = reinterpret_cast<const float4*>(pipe.batch(b));
      const int nb = pipe.count(b);
      bool warp_done = __all_sync(FULL_MASK, done);
      for (int first = 0; first < nb && !warp_done; first += 32) {
        unsigned todo = rows_to_march<C>(rows4, first, nb, lane, box);
        while (todo != 0) {
          warp_done = __all_sync(FULL_MASK, done);
          if (warp_done) break;  // the same for the whole warp
          int row[GROUP];
          float alpha[GROUP];
          next_group<C>(todo, first, rows4, px, py, row, alpha);  // stage 1
          // Stage 2: the chain through T, in depth order.
#pragma unroll
          for (int i = 0; i < GROUP; ++i) {
            float t_after;
            const bool inc = includes(alpha[i], T, done, t_after);
            const float4* r4 = rows4 + max(row[i], 0) * (R::STRIDE / 4);
            if (C <= 8) {
              const float w = inc ? alpha[i] * T : 0.0f;
              for_each_color<C>(r4, [&](int k, float c) { acc[k] = fmaf(w, c, acc[k]); });
            } else if (inc) {
              const float w = alpha[i] * T;
              for_each_color<C>(r4, [&](int k, float c) { acc[k] = fmaf(w, c, acc[k]); });
            }
            T = inc ? t_after : T;
            count += inc ? 1 : 0;
          }
        }
      }
      cp_async_wait_all();
      // Ends the batch: the next one's rows are visible, this one's buffer is
      // free, and the block leaves once every pixel has saturated.
      if (__syncthreads_count(done) == P) break;
    }
  }

  const int tile_p = QUAD ? 4 * P : P;  // pixels of the tile
  const size_t pix = (size_t)t * tile_p + tile_pixel<QUAD>(reg, pixel, tile_size);
  final_t[pix] = T;
  n_contrib[pix] = count;
  if (C > 8) {
    // No thread reads a row after the loop's last barrier, so the buffers
    // are free to stage the colors: written by pixel, read back in the
    // output's order, whole lines to device memory: the block's pixels lie
    // in one piece of the output, a quadrant's in one piece a row.
    constexpr int SS = FwdSmem<C>::STAGE_STRIDE;
    float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int k = 0; k < C; ++k) stage[pixel * SS + k] = acc[k] + T * bg[k];
    __syncthreads();
    if (QUAD) {
      for (int r = 0; r < 16; ++r) {
        float* out = tiles + ((size_t)t * tile_p + (size_t)(reg.qy0 + r) * 32 + reg.qx0) * C;
        const float* in = stage + r * 16 * SS;
        for (int e = p; e < 16 * C; e += P) {
          const int q = e / C;
          out[e] = in[q * SS + (e - q * C)];
        }
      }
    } else {
      float* out = tiles + (size_t)t * P * C;
      for (int e = p; e < P * C; e += P) {
        const int q = e / C;
        out[e] = stage[q * SS + (e - q * C)];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) tiles[pix * C + k] = acc[k] + T * bg[k];
  }
}

template <int C>
cudaError_t launch(const int64_t* gauss_s, const int* tile_starts,
                   const float* table, const float* bg, float* tiles,
                   float* final_t, int* n_contrib, int num_tiles, int grid_x,
                   int tile_size, cudaStream_t stream) {
  const int side = block_side(tile_size);
  if (side == 0) return cudaErrorInvalidValue;
  const long long blocks = (long long)num_tiles * (tile_size == 32 ? 4 : 1);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 8 != 0) return cudaErrorMisalignedAddress;
  const int P = side * side;  // threads a block
  const size_t bytes = FwdSmem<C>::bytes(P);
  auto kernel = tile_size == 32 ? blend_fwd_kernel<C, true> : blend_fwd_kernel<C, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, P, bytes, stream>>>(
      gauss_s, tile_starts, table, bg, tiles, final_t, n_contrib, grid_x,
      tile_size);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code (0 on success); 1 (cudaErrorInvalidValue) for a
// channel count without an instance here or a tile that is not 8 x 8, 16 x 16
// or 32 x 32.
extern "C" int blend_fwd_launch(int channels, const void* gauss_s,
                                const void* tile_starts, const void* table,
                                const void* bg, void* tiles, void* final_t,
                                void* n_contrib, int num_tiles, int grid_x,
                                int tile_size, void* stream) {
  if (num_tiles == 0) return 0;
  const auto* g = static_cast<const int64_t*>(gauss_s);
  const auto* s = static_cast<const int*>(tile_starts);
  const auto* tb = static_cast<const float*>(table);
  const auto* b = static_cast<const float*>(bg);
  auto* o = static_cast<float*>(tiles);
  auto* ft = static_cast<float*>(final_t);
  auto* nc = static_cast<int*>(n_contrib);
  auto st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 3: return launch<3>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 4: return launch<4>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 5: return launch<5>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 8: return launch<8>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 16: return launch<16>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 24: return launch<24>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    case 32: return launch<32>(g, s, tb, b, o, ft, nc, num_tiles, grid_x, tile_size, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
