// What blend_fwd.cu and blend_bwd.cu share: the constants, the α of one
// instance at one pixel, and the skeleton that streams a tile's depth-sorted
// instance rows through shared memory.
//
// The backward kernel re-marches the forward bit for bit (it must include
// exactly the instances the forward included), so the α arithmetic lives here
// once.  Both sources are built with --fmad=false: the compiler fuses nothing,
// and only the places that say fmaf() (color sums, gradient products, where
// nothing is compared exactly) use a fused multiply-add.
//
// Skeleton.  One thread block per tile of 8 x 8 or 16 x 16 pixels, and four
// per 32 x 32 tile, one on each 16 x 16 quadrant (Region); one thread per
// pixel of the block; a warp has a block of 8 x 4 pixels (pixel_of).  A
// tile's range [tile_starts[t], tile_starts[t+1]) is walked in batches of
// BATCH instances, by each of a 32 x 32 tile's four blocks in full.  While the block
// marches batch b, cp.async copies the rows of batch b + 1 (gathered through
// the depth ranks of that batch, which arrived one batch earlier) and the
// ranks of batch b + 2, so a batch costs one barrier and nothing waits on a
// gather; a tile that saturates early has fetched at most one batch too many.
// Rows are padded to a multiple of four floats, so a pixel reads an instance
// with 16-byte loads that every lane of a warp shares (a broadcast).
//
// Inside a batch every warp goes its own way.  32 rows at a time, each lane
// tests one row against the warp's 8 x 4 pixels (misses_box) and a ballot
// gives the warp its to-do mask: it marches only the instances that can reach
// α >= 1/255 on one of its pixels, in depth order, four at a time
// (next_group): first their four α without a branch, so the four exponentials
// overlap, then the chain that truly depends on the step before (T,
// inclusion).  A warp leaves the march once all its pixels have saturated,
// the block once all warps have.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL_MASK = 0xffffffffu;

constexpr int BATCH = 64;          // instances per shared-memory batch
constexpr int GROUP = 4;            // instances whose α are evaluated together
constexpr int GID_RING = 4;         // batches of depth ranks kept in shared memory
constexpr int MAX_THREADS = 256;    // pixels per block (16 x 16) at most
static_assert(BATCH % 8 == 0 && BATCH >= 8, "BATCH must be a multiple of 8");

// One table row (x, y, conic a, b, c, opacity, C colors) in shared memory.
template <int C>
struct Row {
  static constexpr int F = 6 + C;
  static constexpr int STRIDE = (F + 3) / 4 * 4;         // floats, 16-byte rows
  static constexpr int WORDS = (F % 2 == 0) ? 2 : 1;     // floats per cp.async
  static constexpr int COPIES = F / WORDS;               // cp.async per row
};

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The square of pixels a thread block works on: a whole tile of 8 x 8 or
// 16 x 16 pixels, or (QUAD) one 16 x 16 quadrant of a 32 x 32 tile.  A
// 32 x 32 tile has 1024 pixels, more than MAX_THREADS, so four blocks share
// it (blocks 4 t .. 4 t + 3); each streams the tile's whole range and its
// warps' culling (misses_box) leaves out what cannot reach their pixels.  A
// block's square is addressed row by row (pixel_of), its corner inside the
// tile is (qx0, qy0), and tile_pixel gives a pixel's index in the tile's
// (P, C) output.  The kernels are instantiated for QUAD and not, so that a
// whole-tile block computes exactly what it did before 32 x 32 tiles.
struct Region {
  int tile;                // t
  int side;                // pixels a side of the block's square: 8 or 16
  int qx0, qy0;            // the square's corner inside the tile
  float tile_x0, tile_y0;  // the tile's corner in the image
};

// The side of a block's square for a tile size; 0 for a size the kernels do
// not take (any but 8, 16 and 32).
__host__ __device__ __forceinline__ int block_side(int tile_size) {
  return tile_size == 32 ? 16 : (tile_size == 16 || tile_size == 8) ? tile_size : 0;
}

template <bool QUAD>
__device__ __forceinline__ Region region_of(int block, int grid_x, int tile_size) {
  const int t = QUAD ? block >> 2 : block;
  const int q = QUAD ? block & 3 : 0;
  const int side = QUAD ? 16 : tile_size;
  return Region{t, side, (q & 1) * side, (q >> 1) * side, (float)((t % grid_x) * tile_size),
                (float)((t / grid_x) * tile_size)};
}

template <bool QUAD>
__device__ __forceinline__ int tile_pixel(const Region& r, int pixel, int tile_size) {
  return QUAD ? (r.qy0 + pixel / 16) * tile_size + r.qx0 + pixel % 16 : pixel;
}

// The pixel of its block's square that a thread works on.  In a 16 x 16
// square a warp takes a block of 8 x 4 pixels, not two rows of 16: what a
// warp's lanes see of a splat (skipped, included, saturated) then differs
// less, the warp leaves the march sooner, and fewer splats touch its pixels
// at all (misses_box).  An 8 x 8 tile's warps are 8 x 4 blocks as they are.
// Lane l of a warp has the pixel (l & 7, l >> 3) of its block.
__device__ __forceinline__ int pixel_of(int thread, int side) {
  if (side != 16) return thread;
  const int lane = thread & 31, warp = thread >> 5;
  return ((warp >> 1) * 4 + (lane >> 3)) * 16 + (warp & 1) * 8 + (lane & 7);
}

// The bounds of a warp's pixels, in absolute pixel coordinates (inclusive).
struct Box {
  float x0, x1, y0, y1;
};

// (x0, y0): the corner of the block's square in the image.
__device__ __forceinline__ Box warp_box(int thread, int side, float x0, float y0) {
  const int first = pixel_of(thread & ~31, side);  // lane 0: the top left pixel
  const int last = pixel_of(thread | 31, side);    // lane 31: the bottom right one
  return Box{x0 + (float)(first % side), x0 + (float)(last % side),
             y0 + (float)(first / side), y0 + (float)(last / side)};
}

// True where an instance (row words q0 = x, y, a, b; q1 = c, opacity, ...)
// cannot reach α >= 1/255 at any pixel of the box, so that the march may
// leave it out for the whole warp: the binning keeps an instance for a tile
// that its α >= 1/255 footprint touches, and a warp's pixels are an eighth of
// a 16 x 16 tile (a 32nd of a 32 x 32 one).  α >= 1/255 needs opacity >= 1/255 and a dx² + 2b dx dy + c dy²
// <= τ = 2 ln(255 opacity); that ellipse reaches sqrt(τ c / det) from the
// mean in x and sqrt(τ a / det) in y.  Conservative: 1 % and half a pixel are
// added to the reach, far more than the fp32 error of the march's own power.
// Only a sound row is ever left out: one whose power is a finite number <= 0
// (up to rounding) at every pixel, so that the ellipse above describes it.
// A conic that is not positive definite or nearly singular has no such
// ellipse and may reach α >= 1/255 anywhere; a NaN in the row or values so
// large that the power's terms overflow to inf - inf give a NaN power, which
// alpha_of skips (α = 0).  Such rows are marched, never culled here.
__device__ __forceinline__ bool misses_box(float4 q0, float4 q1, const Box& box) {
  const float x = q0.x, y = q0.y, a = q0.z, b = q0.w, c = q1.x, opacity = q1.y;
  const float det = a * c - b * b;
  // Every comparison is false for a NaN; |b| < sqrt(a c) follows from det.
  const bool sound = fabsf(x) <= 1e9f && fabsf(y) <= 1e9f && a > 0.0f && a <= 1e15f &&
                     c > 0.0f && c <= 1e15f && det > 1e-4f * (a * c) && fabsf(opacity) <= 1e6f;
  const float tau = 2.0f * logf(255.0f * opacity);
  const float ex = sqrtf(tau * c / det) * 1.01f + 0.5f;
  const float ey = sqrtf(tau * a / det) * 1.01f + 0.5f;
  const bool outside =
      x + ex < box.x0 || x - ex > box.x1 || y + ey < box.y0 || y - ey > box.y1;
  // opacity < 0.0039 < 1/255: α <= opacity wherever the power is <= 0.
  return sound && (opacity < 0.0039f || outside);
}

// α of one instance at pixel (px, py); 0 for an instance the march skips.
// An instance is kept only on power <= 0, as in ops/blend.py and the JAX
// package (seganygaussians_tpu/ops/blend.py, blend_pallas.py): a NaN power
// (a NaN mean or conic) fails the test and gives α = 0, where fminf alone
// would drop the NaN and composite the row with α = 0.99.  Evaluated without
// a branch, so the exponentials of a group of instances overlap.
__device__ __forceinline__ float alpha_of(float x, float y, float a, float b, float c,
                                          float opacity, float px, float py) {
  const float dx = x - px;
  const float dy = y - py;
  const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
  const float alpha = fminf(ALPHA_MAX, opacity * expf(power));
  return power <= 0.0f ? alpha : 0.0f;
}

// A warp's to-do mask for rows [first, first + 32) of a batch of nb rows: each
// lane tests one row against the warp's pixels (bit i: row first + i).
template <int C>
__device__ __forceinline__ unsigned rows_to_march(const float4* rows4, int first, int nb,
                                                  int lane, const Box& box) {
  bool touches = false;
  if (first + lane < nb) {
    const float4* r4 = rows4 + (first + lane) * (Row<C>::STRIDE / 4);
    touches = !misses_box(r4[0], r4[1], box);
  }
  return __ballot_sync(FULL_MASK, touches);
}

// Stage 1 of the march: takes the next GROUP instances off the to-do mask, in
// depth order (row[i]: their rows of the batch, -1 once the mask is empty),
// and evaluates their α at the lane's pixel, independent of each other and
// of T (0 for a missing row).
template <int C>
__device__ __forceinline__ void next_group(unsigned& todo, int first, const float4* rows4,
                                           float px, float py, int (&row)[GROUP],
                                           float (&alpha)[GROUP]) {
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    row[i] = todo != 0 ? first + __ffs(todo) - 1 : -1;
    todo &= todo - 1;
  }
#pragma unroll
  for (int i = 0; i < GROUP; ++i) {
    const float4* r4 = rows4 + max(row[i], 0) * (Row<C>::STRIDE / 4);
    const float4 q0 = r4[0];
    const float4 q1 = r4[1];
    const float a = alpha_of(q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, px, py);
    alpha[i] = row[i] >= 0 ? a : 0.0f;
  }
}

// Stage 2, one step of the chain through T: whether a pixel with
// transmittance T includes an instance of α a.  An instance that would bring
// T under T_EPS is not included and ends the pixel's march (done).
// ``t_after`` is T past the instance, for the caller to keep if it is
// included.
__device__ __forceinline__ bool includes(float a, float T, bool& done, float& t_after) {
  const bool valid = !done && a >= ALPHA_MIN;
  t_after = T * (1.0f - a);
  const bool stop = valid && t_after < T_EPS;
  done = done || stop;
  return valid && !stop;
}

// fn(k, color_k) for the C colors of a shared-memory row; they start at float
// 6, in the second 16-byte word.  Fully unrolled: k is a constant in fn.
template <int C, typename Fn>
__device__ __forceinline__ void for_each_color(const float4* row4, Fn fn) {
#pragma unroll
  for (int i = 1; i < Row<C>::STRIDE / 4; ++i) {
    const float4 v = row4[i];
    const int k0 = 4 * i - 6;
    if (k0 >= 0 && k0 < C) fn(k0, v.x);
    if (k0 + 1 >= 0 && k0 + 1 < C) fn(k0 + 1, v.y);
    if (k0 + 2 < C) fn(k0 + 2, v.z);
    if (k0 + 3 < C) fn(k0 + 3, v.w);
  }
}

// The stream of a tile's rows through shared memory: NBUF row buffers of
// BATCH rows and a ring of GID_RING batches of depth ranks.
template <int C, int NBUF>
struct Pipeline {
  using R = Row<C>;
  static constexpr size_t RING_BYTES = size_t(GID_RING) * BATCH * sizeof(int64_t);
  static constexpr size_t ROWS_BYTES = size_t(NBUF) * BATCH * R::STRIDE * sizeof(float);

  int64_t* ring;
  float* rows;
  const int64_t* gauss_s;
  const float* table;
  int start, end;

  __device__ __forceinline__ int batches() const { return (end - start + BATCH - 1) / BATCH; }
  // Instances in batch b: <= 0 past the range.
  __device__ __forceinline__ int count(int b) const { return min(BATCH, end - start - b * BATCH); }
  __device__ __forceinline__ int64_t* gids(int b) const {
    return ring + (b & (GID_RING - 1)) * BATCH;
  }
  __device__ __forceinline__ float* batch(int b) const {
    return rows + (b % NBUF) * (BATCH * R::STRIDE);
  }

  __device__ __forceinline__ void copy_gids(int b) const {
    const int nb = count(b);
    const int64_t* src = gauss_s + start + b * BATCH;
    int64_t* dst = gids(b);
    for (int j = threadIdx.x; j < nb; j += blockDim.x) cp_async_8(dst + j, src + j);
  }

  // Needs gids(b) complete and visible to the block.
  __device__ __forceinline__ void copy_rows(int b) const {
    const int nb = count(b);
    const int64_t* gid = gids(b);
    float* dst = batch(b);
    for (int k = threadIdx.x; k < nb * R::COPIES; k += blockDim.x) {
      const int j = k / R::COPIES;  // a constant divisor: a multiply and a shift
      const int e = (k - j * R::COPIES) * R::WORDS;
      const float* src = table + gid[j] * R::F + e;
      if (R::WORDS == 2) {
        cp_async_8(dst + j * R::STRIDE + e, src);
      } else {
        cp_async_4(dst + j * R::STRIDE + e, src);
      }
    }
  }

  // Batch 0's rows and batch 1's ranks in shared memory, visible to all.
  __device__ __forceinline__ void start_up() const {
    copy_gids(0);
    copy_gids(1);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    copy_rows(0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  // Called before batch b's march; the caller ends the batch with
  // cp_async_wait_all() and a block barrier.
  __device__ __forceinline__ void prefetch(int b) const {
    copy_rows(b + 1);
    copy_gids(b + 2);
    cp_async_commit();
  }
};

}  // namespace blend
