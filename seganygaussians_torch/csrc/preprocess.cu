// Per-Gaussian preprocess for Hopper (sm_90a), plain C interface: a forward
// and a backward kernel.
//
// Replaces no TPU kernel: the JAX package computes this stage with XLA
// (seganygaussians_tpu/ops/projection.py:preprocess, ops/sh.py:eval_sh), and
// the port first did so with some 150 PyTorch ops and their autograd
// (ops/projection.py, ops/sh.py, ops/transforms.py, still its CPU path).  It
// is the stage 3DGS's rasterizer runs as preprocessCUDA and as the preprocess
// part of BackwardCUDA.
//
// What it computes, for each Gaussian, from rasterize's geometry inputs to
// the tensors that enter its depth-order gathers: the 3D covariance from
// scale and quaternion (build_covariance_3d, with build_rotation's
// normalisation) or as given; the projection (project_points); the EWA 2D
// covariance with the +-1.3 tan(fov) clamp and the +0.3 low-pass
// (compute_cov2d); the conic, the 3-sigma radius, the alpha >= 1/255 tile
// rects and the culls (near plane, det, active mask, opacity); and the SH
// color along the normalised view direction, +0.5, clamped at 0
// (eval_sh_color).  The backward is the vector-Jacobian product of autograd
// through that plain path, formula for formula as
// ops/preprocess_cuda.py:preprocess_backward_plain writes it: where the
// plain path passes a gradient through a clamp at its bounds, through the
// product clamp(tx / tz) * tz, the tz == 0 and det == 0 substitutions and the
// normalisations, so does this; the radius and rects carry none.  It
// recomputes what it needs from the inputs instead of saving intermediates.
//
// What bounds it on this card.  One thread a Gaussian, all in registers:
// the forward reads 59 floats a Gaussian (xyz, 48 SH coefficients, scale,
// quaternion, opacity) and writes 18 values, the backward reads those inputs
// and 9 upstream gradients and writes 58 gradients.  The arithmetic is some
// hundreds of flops a Gaussian, far below the 295 flops a byte at which the
// card's compute would bound it, so the bytes bound both kernels: about
// 0.4 and 0.9 ms at 5.8M Gaussians and 3.35 TB/s.
//
// Numerics.  IEEE fp32 with --fmad=false and no fast math, in the plain
// path's order of operations, so that its floats equal the plain path's and
// the integer outputs (radii, rects) agree with it but where a float lies
// within an ulp of a tile edge.  The plain path writes every small sum out
// term by term and takes it left to right, ((a0 + a1) + a2) + a3: the
// projections (_row_vec_mul), the quaternion's and the view direction's
// norms, L L^T and the 2D covariance's dot products; so does this, whatever
// PyTorch's reductions or the camera matrices' memory layout would do.  NaN
// passes through the clamps as in PyTorch.

#include <cuda_runtime.h>

namespace {

constexpr float SH_C0 = 0.28209479177387814f;
constexpr float SH_C1 = 0.4886025119029199f;
// Scalars, not arrays: device code may read a constexpr scalar, not a constexpr array.
constexpr float SH_C2_0 = 1.0925484305920792f;
constexpr float SH_C2_1 = -1.0925484305920792f;
constexpr float SH_C2_2 = 0.31539156525252005f;
constexpr float SH_C2_3 = -1.0925484305920792f;
constexpr float SH_C2_4 = 0.5462742152960396f;
constexpr float SH_C3_0 = -0.5900435899266435f;
constexpr float SH_C3_1 = 2.890611442640554f;
constexpr float SH_C3_2 = -0.4570457994644658f;
constexpr float SH_C3_3 = 0.3731763325901154f;
constexpr float SH_C3_4 = -0.4570457994644658f;
constexpr float SH_C3_5 = 1.445305721320277f;
constexpr float SH_C3_6 = -0.5900435899266435f;
constexpr float SH_C4_0 = 2.5033429417967046f;
constexpr float SH_C4_1 = -1.7701307697799304f;
constexpr float SH_C4_2 = 0.9461746957575601f;
constexpr float SH_C4_3 = -0.6690465435572892f;
constexpr float SH_C4_4 = 0.10578554691520431f;
constexpr float SH_C4_5 = -0.6690465435572892f;
constexpr float SH_C4_6 = 0.47308734787878004f;
constexpr float SH_C4_7 = -1.7701307697799304f;
constexpr float SH_C4_8 = 0.6258357354491761f;

// The camera block fill_params reads, 45 floats (ops/preprocess_cuda.py:camera_block):
// world_view, full_proj, centre, fx, fy, -fx, -fy, limx, limy, width, height,
// tile, scale_modifier.
constexpr int THREADS = 128;
constexpr int STAGE_BYTES = 48 * 1024;  // shared memory a block may take without opting in

struct Params {
  float wv[16];  // world_view, row-vector convention: p_view = [x y z 1] @ wv
  float fp[16];  // full_proj
  float cc[3];   // camera centre
  float fx, fy, neg_fx, neg_fy, limx, limy;
  float width, height, tile, scale_modifier;
  int n, grid_x, grid_y;
  int channels, coeffs;  // SH: (C, K) of the (N, C, K) coefficients
  long long sh_n, sh_c, sh_k;  // their strides, in floats
  long long dsh_n, dsh_c, dsh_k;  // the strides of their gradient
  int sh_staged;  // each Gaussian's C x K values dense: staged in shared memory
};

__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return v != v ? v : (v < lo ? lo : v);
}

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : (v < lo ? lo : (v > hi ? hi : v));
}

__device__ __forceinline__ float minimum_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// floor(v) clipped to [0, hi] in float, then to int (projection._tile_index).
__device__ __forceinline__ int tile_index(float v, int hi) {
  return static_cast<int>(clamp_nan(floorf(v), 0.f, static_cast<float>(hi)));
}

// build_covariance_3d: the quaternion normalised, R, L = R diag(s), L L^T.
struct Rotation {
  float q[4];   // the quaternion as given
  float nrm;    // its norm
  float qn[4];  // (r, x, y, z) normalised
  float R[9];
  float s[3];   // scale_modifier * scales
};

__device__ __forceinline__ void covariance(const Params& p, const float* __restrict__ scales,
                                           const float* __restrict__ rotations, int i,
                                           Rotation& rt, float cov[6]) {
  for (int j = 0; j < 3; ++j) rt.s[j] = p.scale_modifier * scales[3 * i + j];
  for (int j = 0; j < 4; ++j) rt.q[j] = rotations[4 * i + j];
  const float ss = ((rt.q[0] * rt.q[0] + rt.q[1] * rt.q[1]) + rt.q[2] * rt.q[2]) + rt.q[3] * rt.q[3];
  rt.nrm = sqrtf(ss);
  for (int j = 0; j < 4; ++j) rt.qn[j] = rt.q[j] / rt.nrm;
  const float r = rt.qn[0], x = rt.qn[1], y = rt.qn[2], z = rt.qn[3];
  rt.R[0] = 1.f - 2.f * (y * y + z * z);
  rt.R[1] = 2.f * (x * y - r * z);
  rt.R[2] = 2.f * (x * z + r * y);
  rt.R[3] = 2.f * (x * y + r * z);
  rt.R[4] = 1.f - 2.f * (x * x + z * z);
  rt.R[5] = 2.f * (y * z - r * x);
  rt.R[6] = 2.f * (x * z - r * y);
  rt.R[7] = 2.f * (y * z + r * x);
  rt.R[8] = 1.f - 2.f * (x * x + y * y);
  float L[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) L[3 * a + b] = rt.R[3 * a + b] * rt.s[b];
  auto dot = [&](int a, int b) {
    return (L[3 * a] * L[3 * b] + L[3 * a + 1] * L[3 * b + 1]) + L[3 * a + 2] * L[3 * b + 2];
  };
  cov[0] = dot(0, 0);
  cov[1] = dot(0, 1);
  cov[2] = dot(0, 2);
  cov[3] = dot(1, 1);
  cov[4] = dot(1, 2);
  cov[5] = dot(2, 2);
}

// project_points, compute_cov2d and the conic, in the plain path's order.
struct Geometry {
  float ph0, ph1, ph3, pw, px, py;
  float tx, ty, tz, tzs, rx, ry, cxr, cyr, txc, tyc, inv_z, inv_z2;
  float m0[3], m1[3], sm0[3], sm1[3];
  float cxx, cxy, cyy, det, det_inv;
  bool det_valid;
};

__device__ __forceinline__ void geometry(const Params& p, float x, float y, float z,
                                         const float cov[6], Geometry& g) {
  const float* F = p.fp;
  const float* V = p.wv;
  g.ph0 = ((x * F[0] + y * F[4]) + z * F[8]) + F[12];
  g.ph1 = ((x * F[1] + y * F[5]) + z * F[9]) + F[13];
  g.ph3 = ((x * F[3] + y * F[7]) + z * F[11]) + F[15];
  g.pw = 1.f / (g.ph3 + 1e-7f);
  g.px = g.ph0 * g.pw;
  g.py = g.ph1 * g.pw;
  g.tx = ((x * V[0] + y * V[4]) + z * V[8]) + V[12];
  g.ty = ((x * V[1] + y * V[5]) + z * V[9]) + V[13];
  g.tz = ((x * V[2] + y * V[6]) + z * V[10]) + V[14];

  g.tzs = g.tz == 0.f ? 1e-6f : g.tz;
  g.rx = g.tx / g.tzs;
  g.ry = g.ty / g.tzs;
  g.cxr = clamp_nan(g.rx, -p.limx, p.limx);
  g.cyr = clamp_nan(g.ry, -p.limy, p.limy);
  g.txc = g.cxr * g.tz;
  g.tyc = g.cyr * g.tz;
  g.inv_z = 1.f / g.tzs;
  g.inv_z2 = g.inv_z * g.inv_z;
  const float j00 = p.fx * g.inv_z;
  const float j02 = (p.neg_fx * g.txc) * g.inv_z2;
  const float j11 = p.fy * g.inv_z;
  const float j12 = (p.neg_fy * g.tyc) * g.inv_z2;
  // R = world_view[:3, :3]^T: R[a][k] = V[4k + a].
  for (int k = 0; k < 3; ++k) {
    g.m0[k] = j00 * V[4 * k] + j02 * V[4 * k + 2];
    g.m1[k] = j11 * V[4 * k + 1] + j12 * V[4 * k + 2];
  }
  const float xx = cov[0], xy = cov[1], xz = cov[2], yy = cov[3], yz = cov[4], zz = cov[5];
  auto sym = [&](const float* m, float* out) {
    out[0] = (xx * m[0] + xy * m[1]) + xz * m[2];
    out[1] = (xy * m[0] + yy * m[1]) + yz * m[2];
    out[2] = (xz * m[0] + yz * m[1]) + zz * m[2];
  };
  sym(g.m0, g.sm0);
  sym(g.m1, g.sm1);
  auto dot3 = [](const float* a, const float* b) {
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
  };
  g.cxx = dot3(g.m0, g.sm0) + 0.3f;
  g.cxy = dot3(g.m0, g.sm1);
  g.cyy = dot3(g.m1, g.sm1) + 0.3f;
  g.det = g.cxx * g.cyy - g.cxy * g.cxy;
  g.det_valid = g.det != 0.f;
  g.det_inv = 1.f / (g.det_valid ? g.det : 1.f);
}

// The SH basis as ops/sh.py:eval_sh writes each term's factor (b[1] and b[3]
// carry the sign of the subtracted terms: r - a*s == r + (-a)*s exactly).
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = SH_C0;
  if constexpr (DEG > 0) {
    b[1] = -(SH_C1 * y);
    b[2] = SH_C1 * z;
    b[3] = -(SH_C1 * x);
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * ((2.f * zz - xx) - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if constexpr (DEG > 2) {
      b[9] = (SH_C3_0 * y) * (3.f * xx - yy);
      b[10] = (SH_C3_1 * xy) * z;
      b[11] = (SH_C3_2 * y) * ((4.f * zz - xx) - yy);
      b[12] = (SH_C3_3 * z) * ((2.f * zz - 3.f * xx) - 3.f * yy);
      b[13] = (SH_C3_4 * x) * ((4.f * zz - xx) - yy);
      b[14] = (SH_C3_5 * z) * (xx - yy);
      b[15] = (SH_C3_6 * x) * (xx - 3.f * yy);
      if constexpr (DEG > 3) {
        b[16] = (SH_C4_0 * xy) * (xx - yy);
        b[17] = (SH_C4_1 * yz) * (3.f * xx - yy);
        b[18] = (SH_C4_2 * xy) * (7.f * zz - 1.f);
        b[19] = (SH_C4_3 * yz) * (7.f * zz - 3.f);
        b[20] = SH_C4_4 * (zz * (35.f * zz - 30.f) + 3.f);
        b[21] = (SH_C4_5 * xz) * (7.f * zz - 3.f);
        b[22] = (SH_C4_6 * (xx - yy)) * (7.f * zz - 1.f);
        b[23] = (SH_C4_7 * xz) * (xx - 3.f * yy);
        b[24] = SH_C4_8 * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy));
      }
    }
  }
}

// d/d(x, y, z) of sum_k w[k] b[k].
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float* w,
                                             float& gx, float& gy, float& gz) {
  gx = 0.f;
  gy = 0.f;
  gz = 0.f;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
  const float xyz = xy * z;
  if constexpr (DEG >= 1) {
    gy += -SH_C1 * w[1];
    gz += SH_C1 * w[2];
    gx += -SH_C1 * w[3];
  }
  if constexpr (DEG >= 2) {
    gx += SH_C2_0 * y * w[4];
    gy += SH_C2_0 * x * w[4];
    gy += SH_C2_1 * z * w[5];
    gz += SH_C2_1 * y * w[5];
    gx += -2.f * SH_C2_2 * x * w[6];
    gy += -2.f * SH_C2_2 * y * w[6];
    gz += 4.f * SH_C2_2 * z * w[6];
    gx += SH_C2_3 * z * w[7];
    gz += SH_C2_3 * x * w[7];
    gx += 2.f * SH_C2_4 * x * w[8];
    gy += -2.f * SH_C2_4 * y * w[8];
  }
  if constexpr (DEG >= 3) {
    gx += 6.f * SH_C3_0 * xy * w[9];
    gy += 3.f * SH_C3_0 * (xx - yy) * w[9];
    gx += SH_C3_1 * yz * w[10];
    gy += SH_C3_1 * xz * w[10];
    gz += SH_C3_1 * xy * w[10];
    gx += -2.f * SH_C3_2 * xy * w[11];
    gy += SH_C3_2 * (4.f * zz - xx - 3.f * yy) * w[11];
    gz += 8.f * SH_C3_2 * yz * w[11];
    gx += -6.f * SH_C3_3 * xz * w[12];
    gy += -6.f * SH_C3_3 * yz * w[12];
    gz += SH_C3_3 * (6.f * zz - 3.f * xx - 3.f * yy) * w[12];
    gx += SH_C3_4 * (4.f * zz - 3.f * xx - yy) * w[13];
    gy += -2.f * SH_C3_4 * xy * w[13];
    gz += 8.f * SH_C3_4 * xz * w[13];
    gx += 2.f * SH_C3_5 * xz * w[14];
    gy += -2.f * SH_C3_5 * yz * w[14];
    gz += SH_C3_5 * (xx - yy) * w[14];
    gx += 3.f * SH_C3_6 * (xx - yy) * w[15];
    gy += -6.f * SH_C3_6 * xy * w[15];
  }
  if constexpr (DEG >= 4) {
    gx += SH_C4_0 * y * (3.f * xx - yy) * w[16];
    gy += SH_C4_0 * x * (xx - 3.f * yy) * w[16];
    gx += 6.f * SH_C4_1 * xyz * w[17];
    gy += 3.f * SH_C4_1 * z * (xx - yy) * w[17];
    gz += SH_C4_1 * y * (3.f * xx - yy) * w[17];
    gx += SH_C4_2 * y * (7.f * zz - 1.f) * w[18];
    gy += SH_C4_2 * x * (7.f * zz - 1.f) * w[18];
    gz += 14.f * SH_C4_2 * xyz * w[18];
    gy += SH_C4_3 * z * (7.f * zz - 3.f) * w[19];
    gz += SH_C4_3 * y * (21.f * zz - 3.f) * w[19];
    gz += SH_C4_4 * z * (140.f * zz - 60.f) * w[20];
    gx += SH_C4_5 * z * (7.f * zz - 3.f) * w[21];
    gz += SH_C4_5 * x * (21.f * zz - 3.f) * w[21];
    gx += 2.f * SH_C4_6 * x * (7.f * zz - 1.f) * w[22];
    gy += -2.f * SH_C4_6 * y * (7.f * zz - 1.f) * w[22];
    gz += 14.f * SH_C4_6 * z * (xx - yy) * w[22];
    gx += 3.f * SH_C4_7 * z * (xx - yy) * w[23];
    gy += -6.f * SH_C4_7 * xyz * w[23];
    gz += SH_C4_7 * x * (xx - 3.f * yy) * w[23];
    gx += 4.f * SH_C4_8 * x * (xx - 3.f * yy) * w[24];
    gy += 4.f * SH_C4_8 * y * (yy - 3.f * xx) * w[24];
  }
}

// The view direction: (xyz - centre) / max(|xyz - centre|, 1e-12).
struct Direction {
  float d[3], norm, nc, u[3];
};

__device__ __forceinline__ void direction(const Params& p, float x, float y, float z,
                                          Direction& v) {
  v.d[0] = x - p.cc[0];
  v.d[1] = y - p.cc[1];
  v.d[2] = z - p.cc[2];
  v.norm = sqrtf((v.d[0] * v.d[0] + v.d[1] * v.d[1]) + v.d[2] * v.d[2]);
  v.nc = clamp_min_nan(v.norm, 1e-12f);
  for (int j = 0; j < 3; ++j) v.u[j] = v.d[j] / v.nc;
}

// A Gaussian's SH coefficients: in shared memory when the block's lie in one
// contiguous range (each Gaussian's C x K values dense, as get_shs gives
// them), copied there with coalesced loads; else where they are.  All the
// block's threads call it (it holds a barrier); i is clamped to the last
// Gaussian for the threads past it, which write nothing.
__device__ __forceinline__ const float* sh_of(const Params& p, const float* __restrict__ shs,
                                              float* tile, int i) {
  if (!p.sh_staged) return shs + i * p.sh_n;
  const long long ck = static_cast<long long>(p.channels) * p.coeffs;
  const int first = blockIdx.x * blockDim.x;
  const long long count = min(static_cast<int>(blockDim.x), p.n - first) * ck;
  const float* src = shs + first * ck;
  for (long long j = threadIdx.x; j < count; j += blockDim.x) tile[j] = __ldg(src + j);
  __syncthreads();
  return tile + threadIdx.x * ck;
}

// One color channel before the clamp: eval_sh(...) + 0.5, summed in eval_sh's order.
template <int DEG>
__device__ __forceinline__ float sh_channel(const Params& p, const float* s, int c,
                                            const float* b) {
  constexpr int NB = (DEG + 1) * (DEG + 1);
  s += c * p.sh_c;
  float r = b[0] * s[0];
#pragma unroll
  for (int k = 1; k < NB; ++k) r = r + b[k] * s[k * p.sh_k];
  return r + 0.5f;
}

template <int DEG>
__global__ void __launch_bounds__(THREADS) preprocess_fwd_kernel(
    const Params p, const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations, const float* __restrict__ cov3d,
    const float* __restrict__ opacities, const bool* __restrict__ active,
    const float* __restrict__ shs, float* __restrict__ means2d, float* __restrict__ depths,
    float* __restrict__ conics, float* __restrict__ colors, int* __restrict__ radii,
    int* __restrict__ rect_min, int* __restrict__ rect_max, int* __restrict__ tiles_touched,
    bool* __restrict__ valid) {
  extern __shared__ float tile[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* sh = nullptr;
  if constexpr (DEG >= 0) sh = sh_of(p, shs, tile, min(i, p.n - 1));
  if (i >= p.n) return;
  const float x = means3d[3 * i], y = means3d[3 * i + 1], z = means3d[3 * i + 2];
  float cov[6];
  if (cov3d != nullptr) {
    for (int j = 0; j < 6; ++j) cov[j] = cov3d[6 * i + j];
  } else {
    Rotation rt;
    covariance(p, scales, rotations, i, rt, cov);
  }
  Geometry g;
  geometry(p, x, y, z, cov, g);

  const float mx = ((g.px + 1.f) * p.width - 1.f) * 0.5f;
  const float my = ((g.py + 1.f) * p.height - 1.f) * 0.5f;
  means2d[2 * i] = mx;
  means2d[2 * i + 1] = my;
  depths[i] = g.tz;
  conics[3 * i] = g.cyy * g.det_inv;
  conics[3 * i + 1] = (-g.cxy) * g.det_inv;
  conics[3 * i + 2] = g.cxx * g.det_inv;

  // The 3-sigma radius and the rects: structural, no gradient.
  const float mid = 0.5f * (g.cxx + g.cyy);
  const float disc = sqrtf(clamp_min_nan(mid * mid - g.det, 0.1f));
  const float lambda1 = mid + disc;
  const float radius_f = ceilf(3.f * sqrtf(clamp_min_nan(lambda1, 1e-12f)));
  float rad_x = radius_f, rad_y = radius_f;
  bool opa_visible = true;
  if (opacities != nullptr) {
    const float opa = opacities[i];
    opa_visible = opa * 255.f > 1.f;
    const float e = sqrtf(clamp_min_nan(2.f * logf(clamp_min_nan(opa, 1e-12f) * 255.f), 0.f));
    rad_x = minimum_nan(e * sqrtf(clamp_min_nan(g.cxx, 0.f)) + 1.f, radius_f);
    rad_y = minimum_nan(e * sqrtf(clamp_min_nan(g.cyy, 0.f)) + 1.f, radius_f);
  }
  const float ts = p.tile;
  auto lo = [&](float m, float r, int hi) { return tile_index((m - r) / ts, hi); };
  auto up = [&](float m, float r, int hi) { return tile_index(((m + r) + ts - 1.f) / ts, hi); };
  const int rx0 = lo(mx, rad_x, p.grid_x), ry0 = lo(my, rad_y, p.grid_y);
  const int rx1 = up(mx, rad_x, p.grid_x), ry1 = up(my, rad_y, p.grid_y);
  const int num_tiles = (rx1 - rx0) * (ry1 - ry0);
  const int r3 = (up(mx, radius_f, p.grid_x) - lo(mx, radius_f, p.grid_x)) *
                 (up(my, radius_f, p.grid_y) - lo(my, radius_f, p.grid_y));
  bool visible = (g.tz > 0.2f) && g.det_valid && r3 > 0;
  if (active != nullptr) visible = visible && active[i];
  const bool ok = visible && num_tiles > 0 && opa_visible;
  radii[i] = visible ? static_cast<int>(radius_f) : 0;
  rect_min[2 * i] = rx0;
  rect_min[2 * i + 1] = ry0;
  rect_max[2 * i] = rx1;
  rect_max[2 * i + 1] = ry1;
  tiles_touched[i] = ok ? num_tiles : 0;
  valid[i] = ok;

  if constexpr (DEG >= 0) {
    constexpr int NB = (DEG + 1) * (DEG + 1);
    Direction v;
    direction(p, x, y, z, v);
    float b[NB];
    sh_basis<DEG>(v.u[0], v.u[1], v.u[2], b);
    for (int c = 0; c < p.channels; ++c)
      colors[i * p.channels + c] = clamp_min_nan(sh_channel<DEG>(p, sh, c, b), 0.f);
  }
}

template <int DEG>
__global__ void __launch_bounds__(THREADS) preprocess_bwd_kernel(
    const Params p, const float* __restrict__ means3d, const float* __restrict__ scales,
    const float* __restrict__ rotations, const float* __restrict__ cov3d,
    const float* __restrict__ shs, const float* __restrict__ g_means2d,
    const float* __restrict__ g_depths, const float* __restrict__ g_conics,
    const float* __restrict__ g_colors, float* __restrict__ d_means3d,
    float* __restrict__ d_scales, float* __restrict__ d_rotations, float* __restrict__ d_cov3d,
    float* __restrict__ d_shs) {
  extern __shared__ float tile[];
  // The threads past the last Gaussian compute on it and write nothing: all
  // threads reach the barriers of the shared-memory SH.
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gi < p.n;
  const int i = min(gi, p.n - 1);
  const float* sh = nullptr;
  if constexpr (DEG >= 0) sh = sh_of(p, shs, tile, i);
  const float x = means3d[3 * i], y = means3d[3 * i + 1], z = means3d[3 * i + 2];
  float cov[6];
  Rotation rt;
  if (cov3d != nullptr) {
    for (int j = 0; j < 6; ++j) cov[j] = cov3d[6 * i + j];
  } else {
    covariance(p, scales, rotations, i, rt, cov);
  }
  Geometry g;
  geometry(p, x, y, z, cov, g);

  const float gmx = g_means2d != nullptr ? g_means2d[2 * i] : 0.f;
  const float gmy = g_means2d != nullptr ? g_means2d[2 * i + 1] : 0.f;
  const float gdep = g_depths != nullptr ? g_depths[i] : 0.f;
  const float ga = g_conics != nullptr ? g_conics[3 * i] : 0.f;
  const float gb = g_conics != nullptr ? g_conics[3 * i + 1] : 0.f;
  const float gc = g_conics != nullptr ? g_conics[3 * i + 2] : 0.f;

  // conic = (cyy, -cxy, cxx) / det, det = cxx cyy - cxy^2 (1 where it is 0).
  const float g_di = (ga * g.cyy + gb * (-g.cxy)) + gc * g.cxx;
  float g_cxx = gc * g.det_inv;
  float g_cxy = -(gb * g.det_inv);
  float g_cyy = ga * g.det_inv;
  const float g_det = g.det_valid ? -g_di * (g.det_inv * g.det_inv) : 0.f;
  g_cxx += g_det * g.cyy;
  g_cyy += g_det * g.cxx;
  g_cxy += -2.f * (g_det * g.cxy);

  // cov2d = (m0.S m0 + .3, m0.S m1, m1.S m1 + .3).
  float g_m0[3], g_m1[3], g_sm0[3], g_sm1[3];
  for (int k = 0; k < 3; ++k) {
    g_m0[k] = g_cxx * g.sm0[k] + g_cxy * g.sm1[k];
    g_m1[k] = g_cyy * g.sm1[k];
    g_sm0[k] = g_cxx * g.m0[k];
    g_sm1[k] = g_cxy * g.m0[k] + g_cyy * g.m1[k];
  }
  const float xx = cov[0], xy = cov[1], xz = cov[2], yy = cov[3], yz = cov[4], zz = cov[5];
  g_m0[0] += (xx * g_sm0[0] + xy * g_sm0[1]) + xz * g_sm0[2];
  g_m0[1] += (xy * g_sm0[0] + yy * g_sm0[1]) + yz * g_sm0[2];
  g_m0[2] += (xz * g_sm0[0] + yz * g_sm0[1]) + zz * g_sm0[2];
  g_m1[0] += (xx * g_sm1[0] + xy * g_sm1[1]) + xz * g_sm1[2];
  g_m1[1] += (xy * g_sm1[0] + yy * g_sm1[1]) + yz * g_sm1[2];
  g_m1[2] += (xz * g_sm1[0] + yz * g_sm1[1]) + zz * g_sm1[2];
  float g_cov[6];
  g_cov[0] = g_sm0[0] * g.m0[0] + g_sm1[0] * g.m1[0];
  g_cov[1] = (g_sm0[0] * g.m0[1] + g_sm0[1] * g.m0[0]) + (g_sm1[0] * g.m1[1] + g_sm1[1] * g.m1[0]);
  g_cov[2] = (g_sm0[0] * g.m0[2] + g_sm0[2] * g.m0[0]) + (g_sm1[0] * g.m1[2] + g_sm1[2] * g.m1[0]);
  g_cov[3] = g_sm0[1] * g.m0[1] + g_sm1[1] * g.m1[1];
  g_cov[4] = (g_sm0[1] * g.m0[2] + g_sm0[2] * g.m0[1]) + (g_sm1[1] * g.m1[2] + g_sm1[2] * g.m1[1]);
  g_cov[5] = g_sm0[2] * g.m0[2] + g_sm1[2] * g.m1[2];

  // m0 = j00 R[0] + j02 R[2], m1 = j11 R[1] + j12 R[2], R[a][k] = V[4k + a].
  const float* V = p.wv;
  float g_j00 = 0.f, g_j02 = 0.f, g_j11 = 0.f, g_j12 = 0.f;
  for (int k = 0; k < 3; ++k) {
    g_j00 += g_m0[k] * V[4 * k];
    g_j02 += g_m0[k] * V[4 * k + 2];
    g_j11 += g_m1[k] * V[4 * k + 1];
    g_j12 += g_m1[k] * V[4 * k + 2];
  }
  float g_inv_z = g_j00 * p.fx + g_j11 * p.fy;
  const float g_txc = (g_j02 * g.inv_z2) * p.neg_fx;
  const float g_tyc = (g_j12 * g.inv_z2) * p.neg_fy;
  const float g_inv_z2 = g_j02 * (p.neg_fx * g.txc) + g_j12 * (p.neg_fy * g.tyc);
  g_inv_z += 2.f * (g_inv_z2 * g.inv_z);
  float g_tzs = -g_inv_z * (g.inv_z * g.inv_z);
  // tx' = clamp(tx / tz_safe, -lim, lim) * tz: the product passes gradient to tz.
  float g_tz = g_txc * g.cxr + g_tyc * g.cyr + gdep;
  const float g_rx = (g.rx >= -p.limx && g.rx <= p.limx) ? g_txc * g.tz : 0.f;
  const float g_ry = (g.ry >= -p.limy && g.ry <= p.limy) ? g_tyc * g.tz : 0.f;
  float g_tx = g_rx / g.tzs;
  float g_ty = g_ry / g.tzs;
  g_tzs += -g_rx * (g.rx / g.tzs) - g_ry * (g.ry / g.tzs);
  if (g.tz != 0.f) g_tz += g_tzs;

  // means2d = ndc2pix(p_hom[:2] / (p_hom[3] + 1e-7)).
  const float g_px = (gmx * 0.5f) * p.width;
  const float g_py = (gmy * 0.5f) * p.height;
  const float g_ph0 = g_px * g.pw;
  const float g_ph1 = g_py * g.pw;
  const float g_pw = g_px * g.ph0 + g_py * g.ph1;
  const float g_ph3 = -g_pw * (g.pw * g.pw);
  const float* F = p.fp;
  float gxyz[3];
  for (int k = 0; k < 3; ++k)
    gxyz[k] = ((g_ph0 * F[4 * k] + g_ph1 * F[4 * k + 1]) + g_ph3 * F[4 * k + 3]) +
              ((g_tx * V[4 * k] + g_ty * V[4 * k + 1]) + g_tz * V[4 * k + 2]);

  if constexpr (DEG >= 0) {
    constexpr int NB = (DEG + 1) * (DEG + 1);
    Direction v;
    direction(p, x, y, z, v);
    float b[NB], w[NB];
    sh_basis<DEG>(v.u[0], v.u[1], v.u[2], b);
#pragma unroll
    for (int k = 0; k < NB; ++k) w[k] = 0.f;
    // Staged, the gradient goes into the thread's own slot of the shared
    // copy (its strides are the coefficients'), then out with coalesced stores.
    float* dsh = p.sh_staged ? const_cast<float*>(sh)
                             : (d_shs != nullptr ? d_shs + i * p.dsh_n : nullptr);
    const bool write_dsh = d_shs != nullptr && (live || p.sh_staged);
    for (int c = 0; c < p.channels; ++c) {
      float gcol = 0.f;
      if (g_colors != nullptr && sh_channel<DEG>(p, sh, c, b) >= 0.f)
        gcol = g_colors[i * p.channels + c];
      const float* s = sh + c * p.sh_c;
#pragma unroll
      for (int k = 0; k < NB; ++k) w[k] += gcol * s[k * p.sh_k];
      if (write_dsh) {
        float* ds = dsh + c * p.dsh_c;
#pragma unroll
        for (int k = 0; k < NB; ++k) ds[k * p.dsh_k] = gcol * b[k];
        for (int k = NB; k < p.coeffs; ++k) ds[k * p.dsh_k] = 0.f;
      }
    }
    if (p.sh_staged && d_shs != nullptr) {
      __syncthreads();
      const long long ck = static_cast<long long>(p.channels) * p.coeffs;
      const int first = blockIdx.x * blockDim.x;
      const long long count = min(static_cast<int>(blockDim.x), p.n - first) * ck;
      for (long long j = threadIdx.x; j < count; j += blockDim.x) d_shs[first * ck + j] = tile[j];
    }
    float gu[3];
    sh_basis_vjp<DEG>(v.u[0], v.u[1], v.u[2], w, gu[0], gu[1], gu[2]);
    // u = d / max(|d|, 1e-12).
    const float g_nc = -(((gu[0] * (v.d[0] / v.nc)) / v.nc + (gu[1] * (v.d[1] / v.nc)) / v.nc) +
                         (gu[2] * (v.d[2] / v.nc)) / v.nc);
    const float g_norm = v.norm >= 1e-12f ? g_nc : 0.f;
    const float scale = v.norm == 0.f ? 0.f : g_norm / v.norm;
    for (int k = 0; k < 3; ++k) gxyz[k] += gu[k] / v.nc + v.d[k] * scale;
  }
  if (!live) return;
  if (d_means3d != nullptr)
    for (int k = 0; k < 3; ++k) d_means3d[3 * i + k] = gxyz[k];

  if (d_cov3d != nullptr)
    for (int j = 0; j < 6; ++j) d_cov3d[6 * i + j] = g_cov[j];
  if (cov3d != nullptr || (d_scales == nullptr && d_rotations == nullptr)) return;

  // cov = strip(L L^T), L = R diag(s): dL = (G + G^T) L with G upper triangular.
  float L[9];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) L[3 * a + b] = rt.R[3 * a + b] * rt.s[b];
  const float G[9] = {2.f * g_cov[0], g_cov[1], g_cov[2],
                      g_cov[1], 2.f * g_cov[3], g_cov[4],
                      g_cov[2], g_cov[4], 2.f * g_cov[5]};
  float gR[9], gs[3] = {0.f, 0.f, 0.f};
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      const float gL = (G[3 * a] * L[k] + G[3 * a + 1] * L[3 + k]) + G[3 * a + 2] * L[6 + k];
      gR[3 * a + k] = gL * rt.s[k];
      gs[k] += gL * rt.R[3 * a + k];
    }
  if (d_scales != nullptr)
    for (int k = 0; k < 3; ++k) d_scales[3 * i + k] = gs[k] * p.scale_modifier;
  if (d_rotations == nullptr) return;
  const float r = rt.qn[0], qx = rt.qn[1], qy = rt.qn[2], qz = rt.qn[3];
  float gq[4];
  gq[0] = 2.f * (((-qz * gR[1] + qy * gR[2]) + (qz * gR[3] - qx * gR[5])) +
                 (-qy * gR[6] + qx * gR[7]));
  gq[1] = 2.f * ((((qy * gR[1] + qz * gR[2]) + (qy * gR[3] - 2.f * qx * gR[4])) +
                  ((-r * gR[5] + qz * gR[6]) + r * gR[7])) - 2.f * qx * gR[8]);
  gq[2] = 2.f * ((((-2.f * qy * gR[0] + qx * gR[1]) + (r * gR[2] + qx * gR[3])) +
                  ((qz * gR[5] - r * gR[6]) + qz * gR[7])) - 2.f * qy * gR[8]);
  gq[3] = 2.f * ((((-2.f * qz * gR[0] - r * gR[1]) + (qx * gR[2] + r * gR[3])) +
                  ((-2.f * qz * gR[4] + qy * gR[5]) + qx * gR[6])) + qy * gR[7]);
  // qn = q / sqrt(sum q^2).
  float g_nrm = 0.f;
  for (int j = 0; j < 4; ++j) g_nrm += -gq[j] * ((rt.q[j] / rt.nrm) / rt.nrm);
  const float g_ss = g_nrm / (2.f * rt.nrm);
  for (int j = 0; j < 4; ++j)
    d_rotations[4 * i + j] = gq[j] / rt.nrm + 2.f * (g_ss * rt.q[j]);
}

int fill_params(Params& p, const float* camera, int n, int grid_x, int grid_y, int channels,
                int coeffs, const long long* sh_strides) {
  if (camera == nullptr || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* c = camera;
  for (int j = 0; j < 16; ++j) p.wv[j] = *c++;
  for (int j = 0; j < 16; ++j) p.fp[j] = *c++;
  for (int j = 0; j < 3; ++j) p.cc[j] = *c++;
  p.fx = *c++;
  p.fy = *c++;
  p.neg_fx = *c++;
  p.neg_fy = *c++;
  p.limx = *c++;
  p.limy = *c++;
  p.width = *c++;
  p.height = *c++;
  p.tile = *c++;
  p.scale_modifier = *c++;
  p.n = n;
  p.grid_x = grid_x;
  p.grid_y = grid_y;
  p.channels = channels;
  p.coeffs = coeffs;
  p.sh_n = sh_strides[0];
  p.sh_c = sh_strides[1];
  p.sh_k = sh_strides[2];
  p.dsh_n = sh_strides[3];
  p.dsh_c = sh_strides[4];
  p.dsh_k = sh_strides[5];
  const long long ck = static_cast<long long>(channels) * coeffs;
  const bool dense = ck > 0 && p.sh_n == ck &&
                     ((p.sh_c == coeffs && p.sh_k == 1) || (p.sh_c == 1 && p.sh_k == channels));
  const bool same = sh_strides[3] == 0 ||
                    (p.dsh_n == p.sh_n && p.dsh_c == p.sh_c && p.dsh_k == p.sh_k);
  p.sh_staged = dense && same && THREADS * ck * sizeof(float) <= STAGE_BYTES;
  return 0;
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }
inline size_t stage_bytes(const Params& p) {
  return p.sh_staged ? THREADS * static_cast<size_t>(p.channels) * p.coeffs * sizeof(float) : 0;
}

}  // namespace

// sh_degree -1: colors given (no SH).  sh_strides: the SH coefficients'
// (n, c, k) strides, then their gradient's (unused here).
extern "C" int preprocess_fwd_launch(int sh_degree, const float* camera, int n, int grid_x,
                                     int grid_y, int channels, int coeffs,
                                     const long long* sh_strides, const void* means3d,
                                     const void* scales, const void* rotations,
                                     const void* cov3d, const void* opacities,
                                     const void* active, const void* shs, void* means2d,
                                     void* depths, void* conics, void* colors, void* radii,
                                     void* rect_min, void* rect_max, void* tiles_touched,
                                     void* valid, void* stream) {
  Params p;
  const int err = fill_params(p, camera, n, grid_x, grid_y, channels, coeffs, sh_strides);
  if (err != 0) return err;
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(means3d);
  const auto* s = static_cast<const float*>(scales);
  const auto* r = static_cast<const float*>(rotations);
  const auto* cv = static_cast<const float*>(cov3d);
  const auto* o = static_cast<const float*>(opacities);
  const auto* a = static_cast<const bool*>(active);
  const auto* sh = static_cast<const float*>(shs);
  auto* m2 = static_cast<float*>(means2d);
  auto* dp = static_cast<float*>(depths);
  auto* cn = static_cast<float*>(conics);
  auto* cl = static_cast<float*>(colors);
  auto* rd = static_cast<int*>(radii);
  auto* r0 = static_cast<int*>(rect_min);
  auto* r1 = static_cast<int*>(rect_max);
  auto* tt = static_cast<int*>(tiles_touched);
  auto* v = static_cast<bool*>(valid);
#define PREPROCESS_FWD(D)                                                                  \
  preprocess_fwd_kernel<D><<<blocks(n), THREADS, stage_bytes(p), st>>>(p, m, s, r, cv, o, a, sh, m2, dp, \
                                                           cn, cl, rd, r0, r1, tt, v)
  switch (sh_degree) {
    case -1: PREPROCESS_FWD(-1); break;
    case 0: PREPROCESS_FWD(0); break;
    case 1: PREPROCESS_FWD(1); break;
    case 2: PREPROCESS_FWD(2); break;
    case 3: PREPROCESS_FWD(3); break;
    case 4: PREPROCESS_FWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PREPROCESS_FWD
  return static_cast<int>(cudaGetLastError());
}

// A null gradient pointer is a gradient not wanted (outputs) or zero (inputs).
extern "C" int preprocess_bwd_launch(int sh_degree, const float* camera, int n, int grid_x,
                                     int grid_y, int channels, int coeffs,
                                     const long long* sh_strides, const void* means3d,
                                     const void* scales, const void* rotations,
                                     const void* cov3d, const void* shs, const void* g_means2d,
                                     const void* g_depths, const void* g_conics,
                                     const void* g_colors, void* d_means3d, void* d_scales,
                                     void* d_rotations, void* d_cov3d, void* d_shs,
                                     void* stream) {
  Params p;
  const int err = fill_params(p, camera, n, grid_x, grid_y, channels, coeffs, sh_strides);
  if (err != 0) return err;
  if (n == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const float*>(means3d);
  const auto* s = static_cast<const float*>(scales);
  const auto* r = static_cast<const float*>(rotations);
  const auto* cv = static_cast<const float*>(cov3d);
  const auto* sh = static_cast<const float*>(shs);
  const auto* gm = static_cast<const float*>(g_means2d);
  const auto* gd = static_cast<const float*>(g_depths);
  const auto* gn = static_cast<const float*>(g_conics);
  const auto* gcl = static_cast<const float*>(g_colors);
  auto* dm = static_cast<float*>(d_means3d);
  auto* ds = static_cast<float*>(d_scales);
  auto* dr = static_cast<float*>(d_rotations);
  auto* dc = static_cast<float*>(d_cov3d);
  auto* dsh = static_cast<float*>(d_shs);
#define PREPROCESS_BWD(D)                                                                  \
  preprocess_bwd_kernel<D><<<blocks(n), THREADS, stage_bytes(p), st>>>(p, m, s, r, cv, sh, gm, gd, gn,   \
                                                           gcl, dm, ds, dr, dc, dsh)
  switch (sh_degree) {
    case -1: PREPROCESS_BWD(-1); break;
    case 0: PREPROCESS_BWD(0); break;
    case 1: PREPROCESS_BWD(1); break;
    case 2: PREPROCESS_BWD(2); break;
    case 3: PREPROCESS_BWD(3); break;
    case 4: PREPROCESS_BWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PREPROCESS_BWD
  return static_cast<int>(cudaGetLastError());
}
