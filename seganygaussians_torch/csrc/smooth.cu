// K-neighbour smoothing of a feature field for Hopper (sm_90a), plain C
// interface: a gather-mean forward kernel and its backward.
//
// Replaces no TPU kernel: the JAX package leaves SAGA's feature smoothing to
// XLA (seganygaussians_tpu/models/feature_gaussians.py:smoothed_point_features,
// multi_res_smoothed_features), and the port first did it with PyTorch ops
// (models/feature_gaussians.py, still its CPU path): the gather normed[nbrs]
// materialised as an (N, K, D) tensor, its mean over K, and for the gradient
// autograd's sorted, accumulating index_put.
//
// What it computes.  Forward: out[i] (+)= (1/K') sum over the K' columns c of
// the map (the drawn columns `cols`, or all K) of normalise(pf[map[i, c]]),
// where normalise is x * rsqrt(sum x^2 + 1e-12) (NORM_RSQRT, the K-neighbour
// smoothing) or x / max(|x|, 1e-9) (NORM_CLAMP, the multi-resolution levels).
// Backward: for each source row j, the upstream rows grad_out[i] of every map
// position (i, c) that names j, each times how often column c is drawn (once
// each without `cols`), summed, divided by K', then the normalisation's
// vector-Jacobian product at pf[j], written or added into grad_pf[j].  The
// positions that name j come from the map's reverse
// (ops/smooth_cuda.py:reverse_map): offsets (N + 1) and the positions
// p = i * K + c ordered by (j, p), so each row's sum is taken in one fixed
// order, with no atomics.
//
// What bounds it on this card.  Bytes: the forward reads K' rows of D floats
// a point (128 bytes at D = 32) at random and writes one row; the backward
// reads as many upstream rows, the point's own row and its entries, and
// writes one row.  A few operations a byte.  Random 128-byte rows reach HBM's
// bandwidth only with many in flight: eight lanes hold a row as float4s (a
// warp four rows), and each group issues UNROLL rows' loads before it adds
// any, so a warp keeps 16 rows in flight.  The backward loads a pass's
// entries one pass ahead and the source row's own features before its sums,
// so that a pass waits on its upstream rows alone.  One group sums one source
// row: dealing a warp's four rows' entries out over its four groups, so that
// a row named by many points is summed by 32 lanes, took four partial sums a
// lane and their join, and measured slower on every map tried, hubs of about
// a thousand entries included (PERF.md, section 6).
//
// Numerics.  IEEE fp32 with --fmad=false and no fast math.  The forward sums
// a point's neighbours in column order, the backward a row's entries in list
// order.  So the results are deterministic, and within a few ulps of the
// plain path's, which sums in other orders.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;                        // lanes a feature row
constexpr int ROWS_PER_BLOCK = THREADS / GROUP;  // points (forward) or source rows (backward)
constexpr int UNROLL = 4;                       // rows a group loads before it adds them
constexpr int MAX_K = 64;                       // map columns the backward's weights hold
constexpr int MAX_CHUNKS = 4;                   // float4s a lane: D <= 4 * GROUP * 4 = 128
constexpr int NORM_RSQRT = 0;
constexpr int NORM_CLAMP = 1;
constexpr unsigned FULL = 0xffffffffu;

// One feature row as a lane holds it: float4 chunk lane + GROUP * j.
template <int CH>
struct Row {
  float4 v[CH];
};

template <int CH>
__device__ __forceinline__ Row<CH> zero_row() {
  Row<CH> r;
#pragma unroll
  for (int j = 0; j < CH; ++j) r.v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  return r;
}

template <int CH>
__device__ __forceinline__ Row<CH> load_row(const float4* __restrict__ row, int d4, int lane) {
  Row<CH> r;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + GROUP * j;
    r.v[j] = c < d4 ? __ldg(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return r;
}

// The sum of x over the 8 lanes of a group; every lane of the group gets the
// same float.  All 32 lanes of the warp must call it.
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 4);
  return x;
}

template <int CH>
__device__ __forceinline__ float row_dot(const Row<CH>& a, const Row<CH>& b) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    s = s + a.v[j].x * b.v[j].x;
    s = s + a.v[j].y * b.v[j].y;
    s = s + a.v[j].z * b.v[j].z;
    s = s + a.v[j].w * b.v[j].w;
  }
  return group_sum(s);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__device__ __forceinline__ float4 div4(float4 a, float s) {
  return make_float4(a.x / s, a.y / s, a.z / s, a.w / s);
}

// acc += normalise(x).
template <int NORM, int CH>
__device__ __forceinline__ void add_normalised(Row<CH>& acc, const Row<CH>& x) {
  const float s = row_dot(x, x);
  if (NORM == NORM_RSQRT) {
    const float f = rsqrtf(s + 1e-12f);
#pragma unroll
    for (int j = 0; j < CH; ++j) acc.v[j] = add4(acc.v[j], scale4(x.v[j], f));
  } else {
    const float d = fmaxf(sqrtf(s), 1e-9f);
#pragma unroll
    for (int j = 0; j < CH; ++j) acc.v[j] = add4(acc.v[j], div4(x.v[j], d));
  }
}

// The gradient of normalise at x, given the gradient gy of its output, as
// autograd forms it through the plain path: rsqrt's -0.5 r^3, the square's
// two products; the division's two terms, the clamp's mask, the norm's x/|x|.
template <int NORM, int CH>
__device__ __forceinline__ Row<CH> normalise_vjp(const Row<CH>& x, const Row<CH>& gy) {
  const float s = row_dot(x, x);
  const float t = row_dot(gy, x);
  Row<CH> gx;
  if (NORM == NORM_RSQRT) {
    const float r = rsqrtf(s + 1e-12f);
    const float gs = (-0.5f * t) * ((r * r) * r);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float4 sq = scale4(x.v[j], gs);
      gx.v[j] = add4(scale4(gy.v[j], r), add4(sq, sq));
    }
  } else {
    const float nrm = sqrtf(s);
    const float d = fmaxf(nrm, 1e-9f);
    const float q = nrm >= 1e-9f ? -(t / (d * d)) / nrm : 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) gx.v[j] = add4(div4(gy.v[j], d), scale4(x.v[j], q));
  }
  return gx;
}

template <int CH>
__device__ __forceinline__ void store_row(float4* __restrict__ row, const Row<CH>& r, int d4,
                                          int lane, bool accumulate) {
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + GROUP * j;
    if (c < d4) row[c] = accumulate ? add4(row[c], r.v[j]) : r.v[j];
  }
}

// One group of 8 lanes a point i; a block 32 points.
template <int CH, int NORM>
__global__ void __launch_bounds__(THREADS)
    smooth_fwd_kernel(const float* __restrict__ pf, int n, int d4,
                      const long long* __restrict__ map, int k,
                      const long long* __restrict__ cols, int kd, float* __restrict__ out,
                      int accumulate) {
  const int lane = threadIdx.x % GROUP;
  const long long point = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / GROUP;
  // A group past the end gathers the last point's rows, so that its warp's
  // shuffles run with every lane, and stores nothing.
  const long long i = point < n ? point : n - 1;
  const long long* __restrict__ nbrs = map + i * k;
  const float4* __restrict__ rows = reinterpret_cast<const float4*>(pf);
  Row<CH> acc = zero_row<CH>();
  for (int c0 = 0; c0 < kd; c0 += UNROLL) {
    Row<CH> x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u;
      if (c < kd) {
        const long long col = cols == nullptr ? c : __ldg(cols + c);
        x[u] = load_row<CH>(rows + __ldg(nbrs + col) * d4, d4, lane);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < kd) add_normalised<NORM>(acc, x[u]);
  }
  if (point >= n) return;
  const float count = static_cast<float>(kd);
#pragma unroll
  for (int j = 0; j < CH; ++j) acc.v[j] = div4(acc.v[j], count);
  store_row(reinterpret_cast<float4*>(out) + i * d4, acc, d4, lane, accumulate != 0);
}

// One group of 8 lanes a source row j; a block 32 rows.
template <int CH, int NORM>
__global__ void __launch_bounds__(THREADS)
    smooth_bwd_kernel(const float* __restrict__ pf, int n, int d4,
                      const float* __restrict__ grad_out, const int* __restrict__ offsets,
                      const int* __restrict__ entries, int k, const long long* __restrict__ cols,
                      int kd, float* __restrict__ grad_pf, int accumulate) {
  // How often each map column is drawn: a count, so that a column drawn twice
  // counts twice, as in the plain path's gather.
  __shared__ float weight[MAX_K];
  if (threadIdx.x < MAX_K) {
    const int c = threadIdx.x;
    float w = 0.f;
    if (c < k) {
      if (cols == nullptr) {
        w = 1.f;
      } else {
        for (int t = 0; t < kd; ++t) w += __ldg(cols + t) == c ? 1.f : 0.f;
      }
    }
    weight[c] = w;
  }
  __syncthreads();
  const int lane = threadIdx.x % GROUP;
  const long long j = static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / GROUP;
  const bool live = j < n;
  const int lo = live ? __ldg(offsets + j) : 0;
  const int hi = live ? __ldg(offsets + j + 1) : 0;
  // The row's own features are loaded before its sums, to overlap them.  A
  // row no position names has no gradient: its zero row gives zeros.
  const bool named = hi > lo;
  const Row<CH> x = named ? load_row<CH>(reinterpret_cast<const float4*>(pf) + j * d4, d4, lane)
                          : zero_row<CH>();
  // A pass takes UNROLL entries; their positions are loaded a pass ahead.
  const float4* __restrict__ up = reinterpret_cast<const float4*>(grad_out);
  int pos[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) pos[u] = lo + u < hi ? __ldg(entries + lo + u) : -1;
  Row<CH> acc = zero_row<CH>();
  for (int e0 = lo; e0 < hi; e0 += UNROLL) {
    float w[UNROLL];
    Row<CH> up_rows[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      w[u] = 0.f;
      if (pos[u] >= 0) {
        const int i = pos[u] / k;
        w[u] = weight[pos[u] - i * k];
        if (w[u] != 0.f) up_rows[u] = load_row<CH>(up + static_cast<long long>(i) * d4, d4, lane);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + UNROLL + u;
      pos[u] = e < hi ? __ldg(entries + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (w[u] == 0.f) continue;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc.v[c] = add4(acc.v[c], scale4(up_rows[u].v[c], w[u]));
    }
  }
  const float count = static_cast<float>(kd);
#pragma unroll
  for (int c = 0; c < CH; ++c) acc.v[c] = div4(acc.v[c], count);
  const Row<CH> gx = normalise_vjp<NORM>(x, acc);
  if (!live || (accumulate && !named)) return;
  store_row(reinterpret_cast<float4*>(grad_pf) + j * d4, gx, d4, lane, accumulate != 0);
}

int blocks(int n) { return (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

int chunks(int d) { return d % 4 == 0 ? (d / 4 + GROUP - 1) / GROUP : 0; }

template <int NORM>
void launch_fwd(int ch, cudaStream_t st, const float* pf, int n, int d4, const long long* map,
                int k, const long long* cols, int kd, float* out, int accumulate) {
#define SMOOTH_FWD(CH) \
  smooth_fwd_kernel<CH, NORM><<<blocks(n), THREADS, 0, st>>>(pf, n, d4, map, k, cols, kd, out, accumulate)
  switch (ch) {
    case 1: SMOOTH_FWD(1); break;
    case 2: SMOOTH_FWD(2); break;
    case 3: SMOOTH_FWD(3); break;
    default: SMOOTH_FWD(4); break;
  }
#undef SMOOTH_FWD
}

template <int NORM>
void launch_bwd(int ch, cudaStream_t st, const float* pf, int n, int d4, const float* grad_out,
                const int* offsets, const int* entries, int k, const long long* cols, int kd,
                float* grad_pf, int accumulate) {
#define SMOOTH_BWD(CH)                                                                     \
  smooth_bwd_kernel<CH, NORM><<<blocks(n), THREADS, 0, st>>>(pf, n, d4, grad_out, offsets, \
                                                             entries, k, cols, kd, grad_pf, \
                                                             accumulate)
  switch (ch) {
    case 1: SMOOTH_BWD(1); break;
    case 2: SMOOTH_BWD(2); break;
    case 3: SMOOTH_BWD(3); break;
    default: SMOOTH_BWD(4); break;
  }
#undef SMOOTH_BWD
}

}  // namespace

// norm: NORM_RSQRT or NORM_CLAMP; pf (n, d) float32, d a multiple of 4 up to
// 128; map (n, k) int64; cols (kd,) int64 columns of the map, or null for all
// k (kd = k).  out (n, d) is written, or added to where accumulate is set.
extern "C" int smooth_fwd_launch(int norm, int n, int d, const void* pf, const void* map, int k,
                                 const void* cols, int kd, void* out, int accumulate,
                                 void* stream) {
  const int ch = chunks(d);
  if (ch < 1 || ch > MAX_CHUNKS || k < 1 || kd < 1 || (norm != NORM_RSQRT && norm != NORM_CLAMP))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(pf);
  const auto* m = static_cast<const long long*>(map);
  const auto* c = static_cast<const long long*>(cols);
  auto* o = static_cast<float*>(out);
  if (norm == NORM_RSQRT) {
    launch_fwd<NORM_RSQRT>(ch, st, x, n, d / 4, m, k, c, kd, o, accumulate);
  } else {
    launch_fwd<NORM_CLAMP>(ch, st, x, n, d / 4, m, k, c, kd, o, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}

// The map's reverse: offsets (n + 1) int32 and entries (n * k) int32, the
// positions i * k + c of the map ordered by (map value, position).  grad_out
// (n, d) float32; grad_pf (n, d) is written, or added to where accumulate is
// set (a row no position names is then left as it is).
extern "C" int smooth_bwd_launch(int norm, int n, int d, const void* pf, const void* grad_out,
                                 const void* offsets, const void* entries, int k,
                                 const void* cols, int kd, void* grad_pf, int accumulate,
                                 void* stream) {
  const int ch = chunks(d);
  if (ch < 1 || ch > MAX_CHUNKS || k < 1 || k > MAX_K || kd < 1 ||
      (norm != NORM_RSQRT && norm != NORM_CLAMP))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(pf);
  const auto* g = static_cast<const float*>(grad_out);
  const auto* off = static_cast<const int*>(offsets);
  const auto* ent = static_cast<const int*>(entries);
  const auto* c = static_cast<const long long*>(cols);
  auto* gx = static_cast<float*>(grad_pf);
  if (norm == NORM_RSQRT) {
    launch_bwd<NORM_RSQRT>(ch, st, x, n, d / 4, g, off, ent, k, c, kd, gx, accumulate);
  } else {
    launch_bwd<NORM_CLAMP>(ch, st, x, n, d / 4, g, off, ent, k, c, kd, gx, accumulate);
  }
  return static_cast<int>(cudaGetLastError());
}
